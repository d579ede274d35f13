"""Two-level DG multigrid: CG-subspace coarse correction + block smoothing.

PyTorch port of dune_pdelab_tpu/linalg/dgmultigrid.py (reference:
dune/pdelab/backend/istl/seq_amg_dg_backend.hh:146 — DG matrix + assembled
CG subspace prolongation + AMG on the CG space; cg_to_dg_prolongation.hh).
The coarse solve (coarse='gmg', the default on a structured mesh) is one
LatticeGMG V-cycle on the Q1 CG subspace (every 3D level on the stencil27
kernel); where LatticeGMG does not apply (a CG subspace not Dirichlet on
the whole boundary, a coarse operator that is not a lattice stencil) or
`gmg_kwargs` tune the coarse solve, one GeometricMultigrid cycle
(linalg/multigrid.py). coarse='amg' takes one AlgebraicMultigrid V-cycle
on the assembled Q1 operator instead (the literal seq_amg_dg_backend.hh
composition), with the flat cycle below. The DG smoother is colored symmetric
block Gauss-Seidel (face-parity two-coloring: DG blocks couple only through
faces) with the element block inverses taken from the block stencil's
3^dim boundary classes, and the CG->DG prolongation is the per-element L2
embedding W[j, c] of the Q1 corner functions in the DG basis.

Two cycles compute the same preconditioner:
  * flat: element-major vectors, the color steps as masked full-lattice
    updates, the operator any z -> A z (on a 2D lattice the block stencil's
    element-major kernel);
  * mode-major (3D, on an MMBlockStencil): the state lives as
    (nz, nb, ny, nx), the block inverses as a (nz, ny, nx, nb, nb) array
    built on the device from the class table, the DG<->CG transfers as
    corner slice adds; flat layout only at entry and exit.
The mode-major cycle runs with the LatticeGMG coarse solve, as in the
reference. The reference's three-jit split of that cycle (a workaround for
its remote compiler) has no counterpart. On a simplex mesh (PkDGFEM) the
conforming subspace is P1, the coarse solve AMG (coarse='auto'), the block
inverses come from probed element diagonal blocks and the smoother's
colours from a greedy colouring of the face-adjacency graph.

Usable directly as the `precond` callable of LinearSolverBackend.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from dune_pdelab_tpu_torch.assembly.dofmaps import make_leaf_dof_map
from dune_pdelab_tpu_torch.constraints.dirichlet import constraints as make_constraints
from dune_pdelab_tpu_torch.fe.basis import PkFEM, QkFEM
from dune_pdelab_tpu_torch.fe.quadrature import quadrature_rule
from dune_pdelab_tpu_torch.space.space import FunctionSpace, _leaf_boundary_dof_mask
from dune_pdelab_tpu_torch.utils.common import (
    default_float, device_key, full_fp32_on_cuda, resolve_device,
)


def _greedy_element_colors(mesh):
    """Colour simplex elements so face-adjacent elements differ (the DG
    coupling graph: SIPG couples element blocks only through shared
    faces). Greedy over the face-adjacency graph, host numpy as in the
    reference; returns one element-index array per colour."""
    if_ = mesh.interior_faces()
    E = mesh.nelements
    nbrs = [[] for _ in range(E)]
    for a, b in zip(if_["inside"], if_["outside"]):
        nbrs[a].append(b)
        nbrs[b].append(a)
    color = np.full(E, -1, np.int64)
    for e in range(E):
        used = {color[n] for n in nbrs[e] if color[n] >= 0}
        c = 0
        while c in used:
            c += 1
        color[e] = c
    return [np.flatnonzero(color == c) for c in range(int(color.max()) + 1)]


class DGTwoLevel:
    """Two-level preconditioner for (linear, SPD-ish) DG operators.

    go_dg:   the DG GridOperator (single leaf: QkDG on a structured mesh
             or PkDG on a simplex mesh)
    cg_lop:  the CG discretization of the same PDE for the coarse space
             (e.g. ConvectionDiffusionFEM(problem))
    bctype:  Dirichlet bctype for the CG subspace (strong constraints)
    gmg_kwargs: options of the GeometricMultigrid coarse solve (given:
             GeometricMultigrid even where LatticeGMG would apply)
    coarse:  'gmg' (structured lattices), 'amg' (AlgebraicMultigrid on the
             assembled CG operator, options `amg_kwargs`) or 'auto' (gmg on
             structured lattices, amg on simplex meshes)
    device:  where the coarse hierarchy lives (default: the default device)
    """

    def __init__(self, go_dg, cg_lop, bctype=True, pre_smooth=1,
                 post_smooth=1, gmg_kwargs=None, coarse="auto",
                 amg_kwargs=None, device=None):
        from dune_pdelab_tpu_torch.linalg.gmg_lattice import LatticeGMG
        from dune_pdelab_tpu_torch.linalg.multigrid import GeometricMultigrid

        space = go_dg.space
        if not (space.is_leaf and space.fem.continuity == "DG"):
            raise ValueError("DGTwoLevel needs a single-leaf DG space")
        mesh = space.mesh
        self._is_simplex = mesh.geometry_type == "simplex"
        if coarse == "auto":
            coarse = "amg" if self._is_simplex else "gmg"
        if coarse not in ("gmg", "amg"):
            raise ValueError(f"coarse={coarse!r}")
        self.go_dg = go_dg
        self.pre = pre_smooth
        self.post = post_smooth
        self.coarse_kind = coarse
        self.device = resolve_device(device)
        dim = mesh.dim

        # conforming Q1 subspace (cg_to_dg_prolongation.hh analog) with a
        # stencil-resident lattice GMG where it applies: fully Dirichlet
        # boundary, a lattice-stencil operator, no explicit gmg_kwargs
        cg_fem = PkFEM(1, dim) if self._is_simplex else QkFEM(1, dim)
        self.V_cg = FunctionSpace(mesh, cg_fem)
        self.cg_cg = make_constraints(bctype, self.V_cg, device=self.device)
        self.gmg_lattice = None
        self.gmg = None
        self.amg = None
        if coarse == "amg":
            from dune_pdelab_tpu_torch.assembly.gridoperator import GridOperator
            from dune_pdelab_tpu_torch.linalg.amg import AlgebraicMultigrid
            self._go_cg = GridOperator(self.V_cg, cg_lop, constraints=self.cg_cg)
            self.amg = AlgebraicMultigrid(**(amg_kwargs or {}))
        else:
            bmask = _leaf_boundary_dof_mask(self.V_cg)
            if not gmg_kwargs and bool(np.all(self.cg_cg.mask_np[np.nonzero(bmask)[0]])):
                try:
                    self.gmg_lattice = LatticeGMG(self.V_cg, cg_lop, device=self.device)
                except (ValueError, NotImplementedError):
                    self.gmg_lattice = None
            if self.gmg_lattice is None:
                self.gmg = GeometricMultigrid(cg_lop, mesh, cg_fem, bctype=bctype,
                                              device=self.device, **(gmg_kwargs or {}))
        self._cg_map = make_leaf_dof_map(self.V_cg, None, offset=0)

        # CG -> DG embedding weights W[j, c]: the element-local corner hat
        # function expressed in the DG element basis by local L2 projection
        # (exact: Q1 restricted to one element lies in the DG space, k >= 1)
        fem = space.fem
        qp, qw = quadrature_rule(fem.geometry, dim, 2 * fem.degree + 2)
        phi, _ = fem.tabulate(qp)                     # (nq, nb)
        lam, _ = cg_fem.tabulate(qp)                  # (nq, C)
        M = phi.T @ (qw[:, None] * phi)
        b = phi.T @ (qw[:, None] * lam)
        self._W = np.linalg.solve(M, b)               # (nb, C)
        self._corner_mi = None if self._is_simplex else np.asarray(cg_fem._mi)
        self.E = mesh.nelements
        self.nb = fem.nbasis
        self._apply = None
        self._setup_key = None
        self._bst_src = None
        self._cache = {}

    # -- per (dtype, device) tensors --------------------------------------
    def _t(self, name, value, ref):
        key = (name, ref.dtype, device_key(ref.device))
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(value, dtype=ref.dtype, device=ref.device)
        return self._cache[key]

    def _prolong(self, xc):
        """CG vector -> DG vector (element-major DG layout)."""
        vals = self._cg_map.gather(xc)                           # (E, C)
        return torch.einsum("jc,ec->ej", self._t("W", self._W, xc), vals).reshape(-1)

    def _restrict(self, r_dg):
        """Transpose: DG residual -> CG residual (corner slice-adds)."""
        rc_e = torch.einsum("jc,ej->ec", self._t("W", self._W, r_dg),
                            r_dg.reshape(self.E, self.nb))
        rc = self._cg_map.scatter_add(
            torch.zeros(self.V_cg.ndofs, dtype=r_dg.dtype, device=r_dg.device), rc_e)
        return torch.where(self.cg_cg.mask_on(r_dg.device), 0.0, rc)

    def setup(self, x_lin=None, time=0.0, operator=None):
        """operator: optional fast apply z -> A z at the linearization point
        (a BlockStencilOperator, or its MMBlockStencil lowering, which
        selects the mode-major cycle in 3D) used by the smoothers in place
        of the general jvp apply. When None and the operator is linear,
        setup compiles the block stencil itself (and lowers it to the
        mode-major kernel in 3D)."""
        from dune_pdelab_tpu_torch.assembly.blockstencil import compile_block_stencil
        from dune_pdelab_tpu_torch.assembly.blockstencil_mm import try_mm_block_stencil
        from dune_pdelab_tpu_torch.linalg.preconditioners import _explicit_block_inverse

        go = self.go_dg
        mesh = go.space.mesh
        if self.device.type == "cuda":
            full_fp32_on_cuda()      # the block solves and transfers are einsums
        if x_lin is None:
            x_lin = torch.zeros(go.space.ndofs, dtype=default_float(), device=self.device)
        bst_src = operator if hasattr(operator, "W_taps") else getattr(operator, "source", None)
        if operator is None and getattr(go.lop, "is_linear", False) and not self._is_simplex:
            operator = compile_block_stencil(go, x_lin, time)
            bst_src = operator
            if operator is not None and mesh.dim == 3:
                operator = try_mm_block_stencil(operator) or operator
        use_mm = (self.gmg_lattice is not None and mesh.dim == 3
                  and getattr(operator, "apply_mm", None) is not None)
        self._bst_src = bst_src
        self._cache = {}
        Dinv = None
        if bst_src is None:
            blocks = go.element_diagonal_blocks(x_lin, time)      # (E, nb, nb)
            Dinv = _explicit_block_inverse(blocks)
        elif not use_mm:
            Dinv = torch.as_tensor(self._class_block_inverses(bst_src),
                                   device=x_lin.device)

        gl = self.gmg_lattice
        if self.amg is not None:
            if self.amg._levels is None:
                self.amg.setup_from_grid_operator(self._go_cg)
            gmg_apply = self.amg.apply
        elif gl is not None:
            lmask = gl.stencils[0].mask

            def gmg_apply(rc):
                # corrections vanish at (strongly) constrained CG dofs
                return gl._vcycle(0, torch.where(lmask, 0.0, rc))
        else:
            self.gmg.setup(None, 0.0, dtype=x_lin.dtype)
            gmg_apply = self.gmg._apply

        A = (operator if operator is not None
             else (lambda z: go.jacobian_apply(x_lin, z, time)))
        # DG blocks couple only through faces, so sum-parity is a valid
        # two-coloring; palindromic schedule with the repeated middle step
        # dropped ([r, b, r]: a repeated color step after an exact block
        # solve is a no-op)
        if self._is_simplex:
            colors = _greedy_element_colors(mesh)
        else:
            par = mesh.element_multi_index().sum(axis=1) % 2
            colors = [np.flatnonzero(par == c) for c in range(2)]
        masks_np = np.zeros((len(colors), self.E))
        for i, cidx in enumerate(colors):
            masks_np[i, cidx] = 1.0
        order = list(range(len(colors))) + list(range(len(colors) - 2, -1, -1))
        if use_mm:
            self._apply = self._build_mm_apply(operator, masks_np, order, gmg_apply)
        else:
            self._apply = self._build_flat_apply(A, Dinv, masks_np, order, gmg_apply)

    def _build_flat_apply(self, A, Dinv, masks_np, order, gmg_apply):
        E, nb = self.E, self.nb
        pre, post = self.pre, self.post

        def solve_all(res):
            return torch.einsum("ejk,ek->ej", self._t("Dinv", Dinv, res),
                                res.reshape(E, nb))

        def smooth(z, r, sweeps, z_is_zero=False):
            masks = self._t("masks", masks_np, r)
            for s in range(sweeps):
                for k, ci in enumerate(order):
                    fresh = z_is_zero and s == 0 and k == 0
                    res = r if fresh else r - A(z)
                    z = (z.reshape(E, nb) + masks[ci][:, None] * solve_all(res)).reshape(-1)
            return z

        def apply(r):
            z = smooth(torch.zeros_like(r), r, pre, z_is_zero=True)
            zc = gmg_apply(self._restrict(r - A(z)))
            return smooth(z + self._prolong(zc), r, post)

        return apply

    def _class_inverse_table(self, bst):
        """Inverse diagonal blocks per boundary class: the element block is
        W_taps[t0] + the dD_sides corrections of the domain boundaries the
        element touches, so only 3^dim distinct blocks. (3^dim, nb, nb)
        float64 with class index sum_d cls_d * 3^d, cls_d in {0: lower
        side, 1: interior, 2: upper side}."""
        dim = len(bst.cells)
        t0 = int(np.nonzero(~np.any(bst.offsets, axis=1))[0][0])
        W0 = np.asarray(bst.W_taps[t0], np.float64)
        dD = np.asarray(bst.dD_sides, np.float64)      # (dim, 2, nb, nb)
        table = np.empty((3 ** dim, bst.nb, bst.nb))
        for cls in itertools.product(*[range(3)] * dim):
            D = W0.copy()
            for d in range(dim):
                if cls[d] == 0:
                    D = D + dD[d, 0]
                if cls[d] == 2:
                    D = D + dD[d, 1]
            table[sum(c * 3 ** d for d, c in enumerate(cls))] = D
        return np.linalg.inv(table)

    def _class_index(self, cells, device):
        """(nz, ny, nx) (2D: (ny, nx)) boundary-class index per element."""
        dim = len(cells)
        idx = torch.zeros(tuple(reversed(cells)), dtype=torch.int64, device=device)
        for d in range(dim):
            pos = torch.ones(cells[d], dtype=torch.int64, device=device)
            pos[0] = 0
            pos[-1] = 2
            shape = [1] * dim
            shape[dim - 1 - d] = cells[d]
            idx = idx + pos.reshape(shape) * (3 ** d)
        return idx

    def _class_block_inverses(self, bst):
        """Per-element inverse diagonal blocks (E, nb, nb) via the class
        table (no per-element inversion)."""
        table = self._class_inverse_table(bst)
        return table[self._class_index(bst.cells, "cpu").reshape(-1).numpy()]

    def _build_mm_apply(self, mm, masks_np, order, gmg_apply):
        """Mode-major two-level V-cycle on a 3D structured DG lattice: state
        as (nz, nb, ny, nx); the block inverses as (nz, ny, nx, nb, nb),
        gathered on the device from the 3^dim class table; the colour masks
        as element planes; the DG<->CG transfer as W-weighted corner slice
        adds/reads. Flat layout only at entry and exit. Reference
        cost-centre analog: seq_amg_dg_backend.hh:146."""
        nxc, nyc, nzc = mm.cells
        pre, post = self.pre, self.post
        table_np = self._class_inverse_table(self._bst_src)
        mi = self._corner_mi                            # (C, 3) x, y, z

        def dmm(ref):
            def build():
                table = torch.as_tensor(table_np, dtype=ref.dtype, device=ref.device)
                return table[self._class_index(mm.cells, ref.device)]   # (z, y, x, j, k)
            key = ("Dmm", ref.dtype, device_key(ref.device))
            if key not in self._cache:
                self._cache[key] = build()
            return self._cache[key]

        def solve_all(res):
            return torch.einsum("zyxjk,zkyx->zjyx", dmm(res), res)

        def smooth(z, r, sweeps, z_is_zero=False):
            cols = self._t("col_mm", masks_np.reshape(-1, nzc, 1, nyc, nxc), r)
            for s in range(sweeps):
                for k, ci in enumerate(order):
                    fresh = z_is_zero and s == 0 and k == 0
                    res = r if fresh else r - mm.apply_mm(z)
                    z = z + cols[ci] * solve_all(res)
            return z

        def restrict_mm(r):
            W = self._t("W", self._W, r)
            rc = torch.zeros((nzc + 1, nyc + 1, nxc + 1), dtype=r.dtype, device=r.device)
            for c in range(W.shape[1]):
                cx, cy, cz = (int(v) for v in mi[c])
                rc[cz:cz + nzc, cy:cy + nyc, cx:cx + nxc] += torch.einsum(
                    "j,zjyx->zyx", W[:, c], r)
            return rc

        def prolong_mm(zc):
            W = self._t("W", self._W, zc)
            z = None
            for c in range(W.shape[1]):
                cx, cy, cz = (int(v) for v in mi[c])
                t = W[:, c][None, :, None, None] * zc[cz:cz + nzc, cy:cy + nyc,
                                                      cx:cx + nxc][:, None]
                z = t if z is None else z + t
            return z

        def apply(r_flat):
            r = mm.to_mm(r_flat)
            z = smooth(torch.zeros_like(r), r, pre, z_is_zero=True)
            rc = restrict_mm(r - mm.apply_mm(z))
            zc = gmg_apply(rc.reshape(-1)).reshape(rc.shape)
            z = smooth(z + prolong_mm(zc), r, post)
            return mm.from_mm(z, r_flat.dtype)

        return apply

    # -- LinearSolverBackend precond protocol -----------------------------
    def __call__(self, go, x_lin, time):
        key = 0 if getattr(self.go_dg.lop, "is_linear", False) else object()
        if self._apply is None or self._setup_key != key:
            self.setup(x_lin, time)
            self._setup_key = key
        return self._apply

    def apply(self, r):
        """One two-level cycle: approximate A^-1 r."""
        if self._apply is None:
            self.setup()
        return self._apply(r)
