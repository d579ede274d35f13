"""Taylor-Hood space construction and block preconditioning for (Navier-)Stokes.

PyTorch port of dune_pdelab_tpu/solvers/stokes.py: the Taylor-Hood tree
Composite(Power(Q2, dim), Q1) of the reference tests, the velocity-GMG +
pressure-mass Schur preconditioner (StokesGMGSchur), its instationary
Cahouet-Chabard variant and the diagonal block preconditioner
(StokesBlockJacobi). Each preconditioner is a `precond(go, x_lin, time)
-> M` callable of LinearSolverBackend.

The velocity blocks are LatticeGMG V-cycles on the Q2 component
Laplacian, the dim components cycled together as one batch: compiled
stencils, whose k > 1 applies run the plain torch form of
assembly/stencil.py (the JAX package leaves them to XLA; no hand kernel). The Taylor-Hood coupling, the pressure mass and the
pressure Laplacian are general-jvp applies. A component's rows are a
slice of the flat vector whenever the ordering allows (lexicographic and
interleaved trees), an index array else (permuted spaces); writes go
through index puts of distinct rows, never an atomic add.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from dune_pdelab_tpu_torch.constraints.dirichlet import DirichletConstraints, constraints
from dune_pdelab_tpu_torch.fe.basis import QkFEM
from dune_pdelab_tpu_torch.ops.l2 import L2
from dune_pdelab_tpu_torch.space.space import CompositeSpace, FunctionSpace, PowerSpace
from dune_pdelab_tpu_torch.utils.common import device_key, resolve_device


def taylor_hood_space(mesh, degree: int = 2):
    """Composite(Power(Q_degree, dim), Q_{degree-1}) Taylor-Hood space."""
    Vv = FunctionSpace(mesh, QkFEM(degree, mesh.dim), name="velocity")
    Vp = FunctionSpace(mesh, QkFEM(degree - 1, mesh.dim), name="pressure")
    return CompositeSpace(PowerSpace(Vv, mesh.dim), Vp, name="taylor-hood")


def velocity_pressure_masks(space: CompositeSpace):
    """Boolean (ndofs,) masks for velocity rows and pressure rows."""
    vmask = np.zeros(space.ndofs, dtype=bool)
    vmask[space.child_global(0, np.arange(space.children[0].ndofs, dtype=np.int64))] = True
    return vmask, ~vmask


def stokes_constraints(space: CompositeSpace, bctype=True, pin_pressure: bool = True,
                       device=None) -> DirichletConstraints:
    """Velocity Dirichlet constraints (+ optional single pinned pressure DOF
    to fix the hydrostatic nullspace of enclosed flows)."""
    mask = constraints((bctype, None), space, device="cpu").mask_np.copy()
    if pin_pressure:
        mask[int(space.child_global(1, np.array([0]))[0])] = True
    return DirichletConstraints(mask, device=device)


def _rows(gidx: np.ndarray, device):
    """Rows `gidx` of the flat vector: a slice when they are an arithmetic
    progression (a view, no gather), else an index tensor on `device`."""
    g = np.asarray(gidx, dtype=np.int64)
    if len(g) == 1 or (len(g) > 1 and g[1] > g[0] and np.all(np.diff(g) == g[1] - g[0])):
        step = int(g[1] - g[0]) if len(g) > 1 else 1
        return slice(int(g[0]), int(g[-1]) + 1, step)
    return torch.as_tensor(g, device=device)


class StokesGMGSchur:
    """Saddle-point preconditioner: velocity-block geometric multigrid +
    pressure-mass Schur complement, optionally block-triangular.

        [ A  B^T ]   with  Schur S = -B A^{-1} B^T  ~  -(1/mu) M_p
        [ B   0  ]

    Velocity block: in the gradient form the momentum block decouples per
    component into scalar Laplacians; each component gets one LatticeGMG
    V-cycle as \\hat A^{-1}. Pressure block: degree-`mass_cheby`
    Chebyshev on the Jacobi-scaled pressure mass (plain Jacobi for 0),
    \\hat S^{-1} = -mu \\hat M_p^{-1}.

    triangular=True applies the upper-triangular variant
        z_p = \\hat S^{-1} r_p;   z_v = \\hat A^{-1} (r_v - (J [0; z_p])_v)
    with one extra matrix-free jacobian apply per call (B^T is never
    assembled).

    Falls back to diagonal Jacobi on the velocity block, with a warning,
    when the mesh has no lattice hierarchy (odd cell counts).

    Enclosed flows: prefer `stokes_constraints(pin_pressure=False)` here;
    GMRES handles the consistent singular system, while a single pinned
    pressure DOF adds an h-dependent outlier to the 3D Schur spectrum.
    """

    def __init__(self, space: CompositeSpace, mu: float = 1.0,
                 triangular: bool = True, smoother: str = "chebyshev",
                 mass_cheby: int = 4, device=None):
        from dune_pdelab_tpu_torch.assembly.gridoperator import GridOperator
        from dune_pdelab_tpu_torch.ops.convectiondiffusion import (
            ConvectionDiffusionFEM, ConvectionDiffusionProblem,
        )

        self.space = space
        self.mu = mu
        self.triangular = triangular
        self.mass_cheby = mass_cheby
        self.device = resolve_device(device)
        power = space.children[0]
        Vv = power.child                      # scalar velocity component
        Vp = space.children[1]
        self.dim = power.k
        self.nv = Vv.ndofs
        arange_v = np.arange(Vv.ndofs, dtype=np.int64)
        self.cidx = [_rows(space.child_global(0, power.child_global(c, arange_v)),
                           self.device) for c in range(self.dim)]
        self.pidx = _rows(space.child_global(1, np.arange(Vp.ndofs, dtype=np.int64)),
                          self.device)

        # velocity-block GMG on the mu-scaled scalar Laplacian
        class _Lap(ConvectionDiffusionProblem):
            def A(self, x, _mu=mu):
                return _mu

        self._vgmg = None
        try:
            from dune_pdelab_tpu_torch.linalg.gmg_lattice import LatticeGMG
            self._vgmg = LatticeGMG(Vv, ConvectionDiffusionFEM(_Lap()),
                                    smoother=smoother, coarsest_cells=2,
                                    device=self.device)
        except (ValueError, NotImplementedError) as e:
            # loud, not silent: iteration counts grow ~1/h instead of
            # staying bounded
            warnings.warn(
                "StokesGMGSchur: velocity block has no lattice GMG "
                f"hierarchy ({e}); falling back to diagonal Jacobi — "
                "expect mesh-dependent GMRES iteration growth",
                stacklevel=2)

        # pressure mass diagonal (Schur): S^-1 ~ -mu diag(M_p)^-1
        self._go_mp = GridOperator(Vp, L2())
        self.mp_diag = self._go_mp.jacobian_diagonal(
            torch.zeros(Vp.ndofs, dtype=torch.float64, device=self.device))
        self._zeros = {}

    def _pressure_zero(self, like):
        key = (like.dtype, device_key(like.device))
        if key not in self._zeros:
            self._zeros[key] = torch.zeros(self.space.children[1].ndofs,
                                           dtype=like.dtype, device=like.device)
        return self._zeros[key]

    def _mass_solve(self, rp):
        """\\hat M_p^{-1} rp. mass_cheby == 0: diag(M_p)^-1 (Wathen),
        spectrally equivalent with the D^-1 M_p spread [2^-d, (3/2)^d]
        (tensor-product Q1 bounds); mass_cheby = k > 0: degree-k Chebyshev
        on that interval (a fixed polynomial in M_p, so still linear)."""
        d = self.mp_diag.to(rp.dtype)
        if self.mass_cheby <= 0:
            return rp / d
        lmax = 1.5 ** self.dim
        lmin = 0.5 ** self.dim
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta
        xp0 = self._pressure_zero(rp)
        dz = (1.0 / theta) * (rp / d)
        z = dz
        rho = 1.0 / sigma
        for _ in range(self.mass_cheby - 1):
            res = rp - self._go_mp.jacobian_apply(xp0, z)
            rho_new = 1.0 / (2.0 * sigma - rho)
            dz = (rho_new * rho) * dz + (2.0 * rho_new / delta) * (res / d)
            z = z + dz
            rho = rho_new
        return z

    def _vel_solve(self, rv, d_full=None):
        """\\hat A^{-1} per velocity component."""
        if self._vgmg is not None:
            return self._vgmg.apply(torch.stack(rv)).unbind(0)
        return [rc / d_full[ci] for rc, ci in zip(rv, self.cidx)]

    def _assemble(self, r, zp, zv, mask):
        z = torch.empty_like(r)
        z[self.pidx] = zp
        for ci, zc in zip(self.cidx, zv):
            z[ci] = zc
        return z if mask is None else torch.where(mask, r, z)

    def _coupled(self, go, x_lin, time, r, zp, mask):
        """Velocity right-hand sides r_v - (J [0; z_p])_v (triangular) or r_v."""
        if not self.triangular:
            return [r[ci] for ci in self.cidx]
        zfull = torch.zeros_like(r)
        zfull[self.pidx] = zp
        if mask is not None:
            zfull = torch.where(mask, 0.0, zfull)
        coup = go.jacobian_apply(x_lin, zfull, time)
        return [r[ci] - coup[ci] for ci in self.cidx]

    def __call__(self, go, x_lin, time):
        mask = go.cg.mask_on(x_lin.device) if go.cg is not None else None
        d = go.jacobian_diagonal(x_lin, time) if self._vgmg is None else None
        mu = self.mu

        def M(r):
            zp = -mu * self._mass_solve(r[self.pidx])
            rv = self._coupled(go, x_lin, time, r, zp, mask)
            return self._assemble(r, zp, self._vel_solve(rv, d), mask)

        return M


class CahouetChabardSchur(StokesGMGSchur):
    """Schur preconditioner for instationary (Navier-)Stokes stages.

    A one-step stage solves the saddle system of
        F = rho*wa*M_v + wb*mu*A_v,   coupling wb*B / wb*B^T
    (OneStepGridOperator weights: wa = a[r,r], wb = dt*b[r,r]). Cahouet-
    Chabard (1988) combines the stationary and the mass-dominated limits:

        S^{-1} ~ -[ (mu/wb) diag(M_p)^{-1} + (rho*wa/wb^2) L_p^+ ]

    with L_p the Neumann pressure Laplacian, applied matrix-free by a fixed
    number of Jacobi-CG iterations with mean projection (the hydrostatic
    nullspace). The velocity block is a LatticeGMG V-cycle of the stage
    operator rho*wa*mass + wb*mu*Laplacian, built and cached per (wa, wb),
    which it reads from the port's float StageContext.
    """

    def __init__(self, space: CompositeSpace, mu: float = 1.0,
                 rho: float = 1.0, triangular: bool = True,
                 smoother: str = "chebyshev", lp_iters: int = 10, device=None):
        super().__init__(space, mu=mu, triangular=triangular, smoother=smoother,
                         device=device)
        from dune_pdelab_tpu_torch.assembly.gridoperator import GridOperator
        from dune_pdelab_tpu_torch.ops.convectiondiffusion import (
            ConvectionDiffusionFEM, ConvectionDiffusionProblem,
        )
        self.rho = rho
        self.lp_iters = lp_iters
        self._smoother = smoother
        Vp = space.children[1]

        class _PLap(ConvectionDiffusionProblem):
            def A(self, x):
                return 1.0

        # Neumann pressure Laplacian (no constraints), matrix-free
        self._go_lp = GridOperator(Vp, ConvectionDiffusionFEM(_PLap()), skip_boundary=True)
        self._lp_diag = self._go_lp.jacobian_diagonal(
            torch.zeros(Vp.ndofs, dtype=torch.float64, device=self.device))
        self._stage_gmg = {}

    def _vel_gmg(self, wa, wb):
        """LatticeGMG of the stage momentum block rho*wa*M + wb*mu*Lap,
        cached per stage weights (None where the mesh has no hierarchy)."""
        key = (round(wa, 14), round(wb, 14))
        if key not in self._stage_gmg:
            from dune_pdelab_tpu_torch.linalg.gmg_lattice import LatticeGMG
            from dune_pdelab_tpu_torch.ops.convectiondiffusion import (
                ConvectionDiffusionFEM, ConvectionDiffusionProblem,
            )
            mu, rho = self.mu, self.rho

            class _Stage(ConvectionDiffusionProblem):
                def A(self, x):
                    return wb * mu

                def c(self, x):
                    return rho * wa

            try:
                self._stage_gmg[key] = LatticeGMG(
                    self.space.children[0].child, ConvectionDiffusionFEM(_Stage()),
                    smoother=self._smoother, coarsest_cells=2, device=self.device)
            except (ValueError, NotImplementedError):
                self._stage_gmg[key] = None
        return self._stage_gmg[key]

    def _lp_apply(self, rp):
        """L_p^+ rp: mean-projected fixed-iteration Jacobi-CG on the
        Neumann pressure Laplacian."""
        from dune_pdelab_tpu_torch.linalg import krylov
        d = self._lp_diag.to(rp.dtype)
        xp0 = self._pressure_zero(rp)
        z, _ = krylov.cg(lambda v: self._go_lp.jacobian_apply(xp0, v), rp - rp.mean(),
                         M=lambda r: r / d, tol=0.0, maxiter=self.lp_iters)
        return z - z.mean()

    def __call__(self, go, x_lin, time):
        # `time` is the OneStepGridOperator StageContext (wa, wb weights);
        # a plain float means a stationary solve: the parent's
        if not hasattr(time, "wb"):
            return super().__call__(go, x_lin, time)
        sc = time
        wa, wb = float(sc.wa), float(sc.wb)
        mask = go.cg.mask_on(x_lin.device) if go.cg is not None else None
        vgmg = self._vel_gmg(wa, wb)
        d = go.jacobian_diagonal(x_lin, sc) if vgmg is None else None
        c_m = self.mu / wb
        c_l = self.rho * wa / (wb * wb)

        def M(r):
            rp = r[self.pidx]
            zp = -(c_m * rp / self.mp_diag.to(rp.dtype))
            if c_l != 0.0 and self.lp_iters > 0:
                zp = zp - c_l * self._lp_apply(rp)
            rv = self._coupled(go, x_lin, sc, r, zp, mask)
            zv = (vgmg.apply(torch.stack(rv)).unbind(0) if vgmg is not None
                  else [rc / d[ci] for rc, ci in zip(rv, self.cidx)])
            return self._assemble(r, zp, zv, mask)

        return M


class StokesBlockJacobi:
    """Block-diagonal preconditioner callable for LinearSolverBackend:
    velocity rows: Jacobi on diag(J); pressure rows: Jacobi on the scaled
    pressure mass matrix (Schur approximation S ~ (1/mu) M_p)."""

    def __init__(self, space: CompositeSpace, mu: float = 1.0, device=None):
        from dune_pdelab_tpu_torch.assembly.gridoperator import GridOperator

        self.space = space
        self.mu = mu
        device = resolve_device(device)
        vmask, _ = velocity_pressure_masks(space)
        self.vmask = torch.as_tensor(vmask, device=device)
        Vp = space.children[1]
        mp_diag = GridOperator(Vp, L2()).jacobian_diagonal(
            torch.zeros(Vp.ndofs, dtype=torch.float64, device=device))
        full = torch.ones(space.ndofs, dtype=torch.float64, device=device)
        full[_rows(space.child_global(1, np.arange(Vp.ndofs, dtype=np.int64)),
                   device)] = mp_diag
        self.mp_diag_full = full

    def __call__(self, go, x_lin, time):
        d = go.jacobian_diagonal(x_lin, time)
        mask = go.cg.mask_on(x_lin.device) if go.cg is not None else None
        vm, mu = self.vmask, self.mu
        mp = self.mp_diag_full.to(x_lin.dtype)

        def M(r):
            z = torch.where(vm, r / d, mu * r / mp)
            return z if mask is None else torch.where(mask, r, z)

        return M
