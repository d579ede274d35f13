"""Stencil-resident geometric multigrid on structured Qk lattices.

PyTorch port of dune_pdelab_tpu/linalg/gmg_lattice.py. Every level
operation stays in lattice form:

  * level operators are compiled StencilOperators (assembly/stencil.py):
    (2k+1)^d scalars, no index maps. On a CUDA tensor a k = 1 3D level runs
    the stencil27 kernel, the fine level and the coarse levels alike;
  * transfers are separable: one (n_out, taps) 1D map per axis, applied as
    torch.index_select + weighted sum along that axis;
  * smoothing is damped Jacobi or Chebyshev with the Gershgorin bound of
    D^-1 A taken from the stencil weights (no power iteration);
  * coarse-level stencils are probed on tiny proxy meshes with the level's
    spacing (on the host in float64), so setup never assembles anything at
    fine-level size;
  * the coarsest level is a dense LU (torch.linalg.lu_factor on the host,
    lu_solve on the level's device).

Transfers, smoothing, the CG vector updates and the coarse solve are plain
torch (ROADMAP: they move into kernels only when a measurement asks).
There is no jit: `apply` runs the V-cycle eagerly, and `solve_host` reads
the defect on the host once per iteration, which is its stopping rule.

Validity = compile_stencil's contract: single-leaf C0 Qk space, uniform
non-periodic mesh, linear translation-invariant operator, fully
Dirichlet-constrained boundary.

Reference analog: ISTL AMG-preconditioned CG (dune/pdelab/backend/istl/
seqistlsolverbackend.hh:983 ISTLBackend_SEQ_CG_AMG_SSOR).
"""
from __future__ import annotations

import numpy as np
import torch

from dune_pdelab_tpu_torch.assembly.stencil import StencilOperator, compile_stencil
from dune_pdelab_tpu_torch.linalg import krylov
from dune_pdelab_tpu_torch.linalg.multigrid import _transfer_1d


def _transpose_transfer_1d(idx, w, ncd):
    """Transpose a 1D prolongation map (nfd, t) into a restriction map
    (ncd, t') with coarse[i] = sum_t rw[i, t] * fine[ridx[i, t]]."""
    nfd = idx.shape[0]
    rows = [[] for _ in range(ncd)]
    for f in range(nfd):
        for j in range(idx.shape[1]):
            if w[f, j] != 0.0:
                rows[int(idx[f, j])].append((f, float(w[f, j])))
    maxt = max(len(r) for r in rows)
    ridx = np.zeros((ncd, maxt), dtype=np.int64)
    rw = np.zeros((ncd, maxt))
    for c, lst in enumerate(rows):
        for t, (f, wv) in enumerate(lst):
            ridx[c, t] = f
            rw[c, t] = wv
    return ridx, rw


def _axis_apply(g, idx, w, axis):
    """out[..., i, ...] = sum_t w[i, t] * g[..., idx[i, t], ...] along axis.

    idx: (n_out, t) int64 tensor on g's device; w: (n_out, t) tensor of g's
    dtype. One index_select per tap, so no (.., n_out, t, ..) intermediate.
    """
    wshape = [1] * g.ndim
    wshape[axis] = idx.shape[0]
    out = None
    for t in range(idx.shape[1]):
        term = torch.index_select(g, axis, idx[:, t]) * w[:, t].reshape(wshape)
        out = term if out is None else out + term
    return out


def _face_mask(dims):
    """All-faces Dirichlet mask for a dof lattice (flat bool, dim0 fastest)."""
    m = np.zeros(tuple(reversed(dims)), dtype=bool)
    for ax in range(len(dims)):
        sl = [slice(None)] * len(dims)
        sl[ax] = 0
        m[tuple(sl)] = True
        sl[ax] = -1
        m[tuple(sl)] = True
    return m.reshape(-1)


def _proxy_stencil(lop, fem, mesh_l, quad_order):
    """Probe the level-l stencil weights on a tiny proxy mesh with the same
    spacing h_l (translation invariance => identical interior weights), on
    the host in float64."""
    from dune_pdelab_tpu_torch.assembly.gridoperator import GridOperator
    from dune_pdelab_tpu_torch.constraints.dirichlet import (
        constraints as make_constraints,
    )
    from dune_pdelab_tpu_torch.space.space import FunctionSpace

    k = fem.degree
    pc = tuple(max(8, 4 * k + 4) for _ in range(mesh_l.dim))
    mesh_p = type(mesh_l)(mesh_l.lower, mesh_l.lower + np.array(pc) * mesh_l.h, pc)
    V_p = FunctionSpace(mesh_p, fem)
    go_p = GridOperator(V_p, lop, constraints=make_constraints(True, V_p),
                        quad_order=quad_order, skip_boundary=True)
    return compile_stencil(go_p, dtype=torch.float64, device="cpu")


def coarse_lu_factor(go):
    """Dense LU of a (tiny) coarse GridOperator's assembled Jacobian, on
    the host in float64: torch.linalg.lu_factor's (LU, 1-based pivots)."""
    A = go.jacobian(torch.zeros(go.space.ndofs, dtype=torch.float64)).to_dense()
    return torch.linalg.lu_factor(A)


def level_hierarchy(mesh, coarsest_cells):
    """Meshes from `mesh` down by factors of 2 while every axis has an even
    cell count of at least 2 * coarsest_cells."""
    meshes = [mesh]
    while True:
        m = meshes[-1]
        if any(c % 2 or c < 2 * coarsest_cells for c in m.cells):
            break
        meshes.append(m.coarsen(2))
    if len(meshes) < 2:
        raise ValueError(f"mesh {mesh.cells} supports no coarsening")
    return meshes


def separable_transfers(k, meshes, dims):
    """Per (level, axis): (idx, w, ridx, rw) numpy maps; transfers[l] maps
    level l+1 (coarse) <-> level l (fine)."""
    transfers = []
    for l in range(len(meshes) - 1):
        per_axis = []
        for d in range(meshes[0].dim):
            idx, w, nfd, ncd = _transfer_1d(k, meshes[l + 1].cells[d], False)
            assert nfd == dims[l][d] and ncd == dims[l + 1][d]
            ridx, rw = _transpose_transfer_1d(idx, w, ncd)
            per_axis.append((idx, w, ridx, rw))
        transfers.append(per_axis)
    return transfers


class LatticeGMG:
    """V-cycle multigrid on compiled stencils; a `precond` callable and a
    full GMG-preconditioned CG solver.

    Parameters
    ----------
    space : leaf FunctionSpace on a uniform structured mesh (Qk)
    lop : linear, translation-invariant local operator
    pre, post : smoothing steps per level (Chebyshev degree when
        smoother="chebyshev")
    smoother : "chebyshev" (default) | "jacobi"
    fine_stencil : optionally the already-compiled fine StencilOperator
        (e.g. the one driving the CG operator), to skip re-probing
    device : where the level masks live (default: fine_stencil's mask
        device, else the CPU); vectors passed in must be on it
    """

    def __init__(self, space, lop, *, pre=2, post=2, smoother="chebyshev",
                 omega=0.8, coarsest_cells=4, quad_order=None, cycle="v",
                 fine_stencil=None, device=None):
        from dune_pdelab_tpu_torch.assembly.gridoperator import GridOperator
        from dune_pdelab_tpu_torch.constraints.dirichlet import (
            constraints as make_constraints,
        )
        from dune_pdelab_tpu_torch.space.space import FunctionSpace

        mesh, fem = space.mesh, space.fem
        if any(mesh.periodic) or not mesh.uniform:
            raise ValueError("LatticeGMG requires a uniform non-periodic "
                             "structured mesh")
        k = fem.degree
        if device is None:
            device = (fine_stencil.mask.device if fine_stencil is not None
                      and fine_stencil.mask is not None else "cpu")
        self.meshes = level_hierarchy(mesh, coarsest_cells)
        dims = [tuple(k * c + 1 for c in m.cells) for m in self.meshes]

        # level stencils: reuse the fine one if provided; every other level
        # is probed on a proxy mesh (the weights depend only on h_l), with
        # compile_stencil's own random-vector parity check
        sts = []
        for l, m in enumerate(self.meshes):
            if l == 0 and fine_stencil is not None:
                if tuple(fine_stencil.dims) != dims[0]:
                    raise ValueError("fine_stencil dims mismatch")
                sts.append(fine_stencil)
                continue
            st_p = _proxy_stencil(lop, fem, m, quad_order)
            if st_p is None:
                raise ValueError(
                    "operator does not compile to a lattice stencil "
                    "(variable coefficients / non-invariant terms?) — use "
                    "VarCoeffGMG (Q1) instead")
            mask = torch.as_tensor(_face_mask(dims[l]), device=device)
            sts.append(StencilOperator(dims[l], k, st_p.weights, st_p.offsets,
                                       mask, st_p.interior_classes))

        Vc = FunctionSpace(self.meshes[-1], fem)
        goc = GridOperator(Vc, lop, constraints=make_constraints(True, Vc),
                           quad_order=quad_order, skip_boundary=True)
        self._init_levels(dims, sts, separable_transfers(k, self.meshes, dims),
                          coarse_lu_factor(goc), pre=pre, post=post,
                          smoother=smoother, omega=omega, cycle=cycle)

    def _init_levels(self, dims, stencils, transfers, coarse_lu, *, pre, post,
                     smoother, omega, cycle, lmax=None):
        """Hierarchy state: level dims, level operators (StencilOperator
        protocol: __call__, .mask, .diagonal), numpy transfer maps, the
        coarse (LU, 1-based pivots) and the smoother settings. lmax: the
        Chebyshev bound per level (default: Gershgorin from the weights)."""
        self.dims = [tuple(d) for d in dims]
        self.stencils = stencils
        self.transfers = transfers
        self._coarse_lu = coarse_lu
        self.pre, self.post = pre, post
        self.smoother, self.omega, self.cycle = smoother, omega, cycle
        if lmax is None:
            lmax = []
            for st in stencils:
                t0 = int(np.nonzero(~np.any(st.offsets, axis=1))[0][0])
                lmax.append(max(
                    float(np.abs(st.weights[c]).sum() / abs(st.weights[c][t0]))
                    for c in range(st.weights.shape[0])))
        self.lmax = lmax
        self._cache = {}

    @property
    def nlevels(self):
        return len(self.dims)

    # -- per (dtype, device) tensors, built on first use ----------------------
    def _cached(self, key, build):
        if key not in self._cache:
            self._cache[key] = build()
        return self._cache[key]

    def _transfer(self, l, d, v):
        def build():
            idx, w, ridx, rw = self.transfers[l][d]
            ints = dict(dtype=torch.int64, device=v.device)
            reals = dict(dtype=v.dtype, device=v.device)
            return (torch.as_tensor(idx, **ints), torch.as_tensor(w, **reals),
                    torch.as_tensor(ridx, **ints), torch.as_tensor(rw, **reals))
        return self._cached(("transfer", l, d, v.dtype, str(v.device)), build)

    def _dinv(self, l, r):
        return self._cached(
            ("dinv", l, r.dtype, str(r.device)),
            lambda: 1.0 / self.stencils[l].diagonal(dtype=r.dtype, device=r.device))

    def _coarse_solve(self, r):
        lu, piv = self._cached(
            ("lu", r.dtype, str(r.device)),
            lambda: (self._coarse_lu[0].to(r.device, r.dtype),
                     self._coarse_lu[1].to(r.device)))
        return torch.linalg.lu_solve(lu, piv, r[:, None])[:, 0]

    # -- grid-shaped transfer ops ---------------------------------------------
    def _restrict(self, l, res):
        """fine level l flat -> coarse level l+1 flat (P^T)."""
        g = res.reshape(tuple(reversed(self.dims[l])))
        for d in range(g.ndim):
            _, _, ridx, rw = self._transfer(l, d, res)
            g = _axis_apply(g, ridx, rw, g.ndim - 1 - d)
        return g.reshape(-1)

    def _prolong(self, l, zc):
        """coarse level l+1 flat -> fine level l flat (P)."""
        g = zc.reshape(tuple(reversed(self.dims[l + 1])))
        for d in range(g.ndim):
            idx, w, _, _ = self._transfer(l, d, zc)
            g = _axis_apply(g, idx, w, g.ndim - 1 - d)
        return g.reshape(-1)

    # -- V-cycle ----------------------------------------------------------------
    def _smooth(self, l, z, r, steps):
        st = self.stencils[l]
        mask = st.mask
        dinv = self._dinv(l, r)
        if self.smoother == "jacobi":
            for _ in range(steps):
                z = z + self.omega * dinv * (r - st(z))
                z = torch.where(mask, r, z)
            return z
        # Chebyshev on [lmax/4, lmax] (degree = steps), D^-1-preconditioned;
        # standard 3-term recurrence (hypre/AMGX smoother form)
        lmax = self.lmax[l]
        lmin = lmax / 4.0
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta
        res = r - st(z)
        d = (1.0 / theta) * (dinv * res)
        z = torch.where(mask, r, z + d)
        rho = 1.0 / sigma
        for _ in range(steps - 1):
            res = r - st(z)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * (dinv * res)
            z = torch.where(mask, r, z + d)
            rho = rho_new
        return z

    def _vcycle(self, l, r):
        L = self.nlevels
        if l == L - 1:
            return self._coarse_solve(r)
        st = self.stencils[l]
        z = self._smooth(l, torch.zeros_like(r), r, self.pre)
        res = r - st(z)
        rc = self._restrict(l, res)
        maskc = self.stencils[l + 1].mask
        rc = torch.where(maskc, 0.0, rc)
        zc = self._vcycle(l + 1, rc)
        if self.cycle == "w" and l + 1 < L - 1:
            rc2 = rc - self.stencils[l + 1](zc)
            rc2 = torch.where(maskc, 0.0, rc2)
            zc = zc + self._vcycle(l + 1, rc2)
        corr = self._prolong(l, zc)
        z = z + torch.where(st.mask, 0.0, corr)
        return self._smooth(l, z, r, self.post)

    def apply(self, r):
        """One V-cycle: approximate A^-1 r (identity on constrained rows)."""
        return self._vcycle(0, r)

    def __call__(self, go, x_lin, time):
        """LinearSolverBackend `precond` protocol (setup-free: stencils are
        linearization-point independent by the linearity requirement)."""
        return self.apply

    # -- host-loop solver ---------------------------------------------------
    def solve_host(self, b, tol=1e-8, atol=0.0, maxiter=200):
        """GMG-preconditioned CG with the iteration loop on the host.

        ISTL CGSolver semantics (recurrence-defect 2-norm, relative
        reduction `tol`); the defect is read on the host once per iteration
        (the stopping rule). Returns (x, info dict) with iterations,
        converged, defect0, defect and true_defect (recomputed ||b - A x||
        at the end).
        """
        st = self.stencils[0]
        x = torch.zeros_like(b)
        r = b
        defect0 = float(torch.linalg.norm(r))
        target = max(tol * defect0, atol)
        z = self.apply(r)
        p = z
        rho = torch.dot(r, z)
        defect = defect0
        it = 0
        while defect > target and it < maxiter:
            q = st(p)
            alpha = rho / torch.dot(p, q)
            x = x + alpha * p
            r = r - alpha * q
            defect = float(torch.linalg.norm(r))      # host sync once per iteration
            it += 1
            if defect <= target:
                break
            z = self.apply(r)
            rho_new = torch.dot(r, z)
            p = z + (rho_new / rho) * p
            rho = rho_new
        true_defect = float(torch.linalg.norm(b - st(x)))
        return x, {
            "iterations": it,
            "converged": defect <= target,
            "defect0": defect0,
            "defect": defect,
            "true_defect": true_defect,
        }

    # -- full solver ------------------------------------------------------------
    def make_solver(self, tol=1e-8, atol=0.0, maxiter=500):
        """solve(b) -> (x, SolverStats): GMG-preconditioned CG on the fine
        stencil (linalg/krylov.cg, ISTL CGSolver semantics). b must follow
        the residual convention (zero Dirichlet rows)."""
        st0 = self.stencils[0]

        def solve(b):
            return krylov.cg(st0, b, M=self.apply, tol=tol, atol=atol,
                             maxiter=maxiter)

        return solve
