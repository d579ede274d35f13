"""Block-stencil compilation: translation-invariant DG operators as block
stencils over the element lattice.

PyTorch port of dune_pdelab_tpu/assembly/blockstencil.py. On a uniform
structured mesh a linear translation-invariant DG operator (SIPG/NIPG/IIPG
convection-diffusion, DG mass, ...) assembles into a block convolution over
the element lattice: every interior element row is the same set of
(2*dim+1) nb-by-nb blocks (volume + face coupling to each face neighbour),

    out[e] = sum_taps  W_t @ z[e + off_t]

and boundary elements differ from interior ones only through their
boundary-face terms: face contributions are additive, so the difference is
one diagonal correction block per side (corners get the sum of their
sides' corrections, verified by a probe at compile time).

BlockStencilOperator.__call__ runs the element-major block stencil
(kernels/blockstencil.py block_stencil_em: the CUDA kernel for a CUDA
tensor, its plain version, shifted slices with one contraction per tap in
the working dtype, for a CPU tensor). The mode-major lowering is
assembly/blockstencil_mm.py. BlockEllMatrix / assemble_block_ell are the
variable-coefficient generalisation, in plain torch.

Reference analog: the assembled BCRS path for DG spaces
(dune/pdelab/backend/istl/bcrsmatrix.hh) and the FastDG blocked matrices
(dune/pdelab/gridoperator/fastdg/).
"""
from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import vmap

from dune_pdelab_tpu_torch.assembly import stencil as _stencil
from dune_pdelab_tpu_torch.kernels.blockstencil import (
    block_stencil_em, block_stencil_em_reference, tap_tensors,
)
from dune_pdelab_tpu_torch.utils.common import (
    default_float, device_key, full_fp32_on_cuda, resolve_device,
)


class BlockStencilOperator:
    """y = block_stencil(z) on the element-major DG layout (DOF e*nb + j)."""

    def __init__(self, cells, nb, W_taps, offsets, dD_sides):
        self.cells = tuple(int(c) for c in cells)   # element lattice, dim0 fastest
        self.nb = int(nb)
        self.W_taps = np.asarray(W_taps, np.float64)     # (ntaps, nb, nb)
        self.offsets = np.asarray(offsets)               # (ntaps, dim)
        self.dD_sides = np.asarray(dD_sides, np.float64)  # (dim, 2, nb, nb)
        self._taps = {}

    @property
    def ndofs(self):
        return int(np.prod(self.cells)) * self.nb

    def taps(self, dtype, device):
        """The kernel's (W (7, nb, nb), dD (3, 2, nb, nb)) in `dtype` on
        `device`, built once per pair, with their host weights for the
        kernel's parameter path (kernels/blockstencil.py tap_tensors)."""
        key = (dtype, device_key(device))
        if key not in self._taps:
            if torch.device(device).type == "cuda":
                full_fp32_on_cuda()
            self._taps[key] = tap_tensors(self.W_taps, self.offsets,
                                          self.dD_sides, dtype, device)
        return self._taps[key]

    def _apply_impl(self, z):
        """Plain form: shifted slices with one contraction per tap."""
        return block_stencil_em_reference(z, *self.taps(z.dtype, z.device), self.cells)

    def __call__(self, z):
        return block_stencil_em(z, *self.taps(z.dtype, z.device), self.cells)

    def diagonal(self, dtype=None, device=None):
        """Exact operator diagonal from the tap data alone: diag(W0) per
        element plus the per-side dD boundary diagonals."""
        dim = len(self.cells)
        t0 = int(np.nonzero(~np.any(self.offsets, axis=1))[0][0])
        grid_rev = tuple(reversed(self.cells))
        dt = dtype or default_float()
        device = resolve_device(device)
        diag = torch.as_tensor(np.diag(self.W_taps[t0]).copy(), dtype=dt, device=device)
        diag = diag.expand(grid_rev + (self.nb,)).clone()
        for d in range(dim):
            ax = dim - 1 - d
            for side in (0, 1):
                sl = [slice(None)] * (dim + 1)
                sl[ax] = slice(0, 1) if side == 0 else slice(-1, None)
                diag[tuple(sl)] += torch.as_tensor(
                    np.diag(self.dD_sides[d, side]).copy(), dtype=dt, device=device)
        return diag.reshape(-1)


def _dg_layout_ok(space):
    if not getattr(space, "is_leaf", False):
        return False
    fem = space.fem
    mesh = space.mesh
    return (fem.continuity == "DG"
            and mesh.geometry_type == "cube"
            and mesh.uniform
            and not any(mesh.periodic))


def face_offsets(dim):
    """(2*dim+1, dim) tap offsets: the element, then -e_d, +e_d per axis."""
    offsets = [np.zeros(dim, dtype=np.int64)]
    for d in range(dim):
        for s in (-1, 1):
            off = np.zeros(dim, dtype=np.int64)
            off[d] = s
            offsets.append(off)
    return np.array(offsets)


def compile_block_stencil(go, x_lin=None, time=0.0, check=True, dtype=None,
                          device=None):
    """Build a BlockStencilOperator equivalent to go.jacobian_apply.

    Probes run in `dtype` on `device` (defaults: x_lin's, else the default
    float on the default device). Returns None when the operator/space does
    not qualify (a single-leaf DG space on a uniform non-periodic cube
    mesh, a linear operator, no Dirichlet-constrained DOFs: DG boundary
    conditions are weak).

    Meshes above assembly/stencil.py's PROXY_MIN_ELEMENTS, at the default
    linearization point and with spatially constant coefficients, are
    probed on a 6^dim proxy mesh with the same spacing."""
    space = go.space
    if not _dg_layout_ok(space):
        return None
    if not getattr(go.lop, "is_linear", False):
        return None
    if go.cg is not None and go.cg.nconstrained > 0:
        return None
    mesh = space.mesh
    dim = mesh.dim
    nb = space.fem.nbasis
    cells = tuple(mesh.cells)
    if any(c < 5 for c in cells):
        return None
    if x_lin is not None:
        dtype = dtype or x_lin.dtype
        device = device or x_lin.device
    dtype = dtype or default_float()
    device = resolve_device(device)

    if (mesh.nelements > _stencil.PROXY_MIN_ELEMENTS and x_lin is None
            and not go.selective   # masks are not translation invariant
            and _stencil._coefficients_spatially_constant(go.lop, mesh)):
        from dune_pdelab_tpu_torch.assembly.gridoperator import GridOperator
        from dune_pdelab_tpu_torch.space.space import FunctionSpace
        pc = (6,) * dim
        mesh_p = type(mesh)(mesh.lower, mesh.lower + np.array(pc) * mesh.h, pc)
        go_p = GridOperator(FunctionSpace(mesh_p, space.fem), go.lop,
                            quad_order=go.qorder)
        st_p = compile_block_stencil(go_p, None, time, check, dtype, device)
        if st_p is None:
            return None
        return BlockStencilOperator(cells, nb, st_p.W_taps, st_p.offsets,
                                    st_p.dD_sides)

    if x_lin is None:
        x_lin = torch.zeros(space.ndofs, dtype=dtype, device=device)
    strides = np.cumprod((1,) + cells[:-1]).astype(np.int64)

    def eidx(g):
        return int(np.dot(g, strides))

    def column_blocks(e_mi, rows):
        """Probe all nb columns of element e_mi (one vmapped jvp); return
        {row_e: (nb, nb)} with block[i, j] = J[(row_e, i), (e_mi, j)]."""
        e = torch.zeros((nb, space.ndofs), dtype=dtype, device=device)
        e[torch.arange(nb), eidx(e_mi) * nb + torch.arange(nb)] = 1.0
        cols = vmap(lambda v: go.jacobian_apply(x_lin, v, time))(e).cpu().numpy()
        if np.iscomplexobj(cols):
            imaginary.append(bool(np.any(cols.imag != 0)))
            cols = cols.real
        return {r: cols[:, r * nb:(r + 1) * nb].T.copy() for r in rows}

    imaginary = []     # a complex operator's blocks: the stencil is declined

    # interior probe: centre element far from every boundary
    c_mi = np.array([2] * dim)
    offsets = face_offsets(dim)
    rows = [eidx(c_mi - off) for off in offsets]
    blocks = column_blocks(c_mi, rows)
    W_taps = np.stack([blocks[eidx(c_mi - off)] for off in offsets])
    D_int = W_taps[0]

    # per-side diagonal corrections: probe a mid-side element
    dD = np.zeros((dim, 2, nb, nb))
    for d in range(dim):
        for si in (0, 1):
            m = np.array([2] * dim)
            m[d] = 0 if si == 0 else cells[d] - 1
            dD[d, si] = column_blocks(m, [eidx(m)])[eidx(m)] - D_int

    if check:
        # translation invariance: interior diagonal at a shifted element
        c2 = c_mi + 1
        if not np.allclose(column_blocks(c2, [eidx(c2)])[eidx(c2)], D_int, atol=1e-9):
            return None
        # corner additivity: D_corner == D_int + sum of side corrections
        corner = np.zeros(dim, dtype=np.int64)
        expect = D_int + sum(dD[d, 0] for d in range(dim))
        if not np.allclose(column_blocks(corner, [eidx(corner)])[eidx(corner)],
                           expect, atol=1e-9):
            return None

    if any(imaginary):
        return None
    st = BlockStencilOperator(cells, nb, W_taps, offsets, dD)
    if check and not _global_parity(go, st, x_lin, time):
        # probe-local checks pass for operators that are translation
        # invariant near the probes only (e.g. a central coefficient
        # inclusion); the whole-domain random-vector check is decisive
        return None
    return st


def _global_parity(go, st, x_lin, time):
    """Whole-domain verification: one random-vector apply of the plain
    block stencil against go.jacobian_apply. On a CUDA tensor the kernel
    is held against the plain form on the same vector and raises on a
    mismatch: a kernel fault must not read as a non-invariant operator."""
    rng = np.random.default_rng(96321)
    z = torch.as_tensor(rng.standard_normal(go.space.ndofs), dtype=x_lin.dtype,
                        device=x_lin.device)
    y_ref = go.jacobian_apply(x_lin, z, time)
    y_st = st._apply_impl(z)
    if z.device.type == "cuda":
        err = float((st(z) - y_st).abs().max())
        lim = (1e-12 if z.dtype == torch.float64 else 1e-5) * float(y_st.abs().max())
        if not err <= lim:
            raise RuntimeError(
                f"block_stencil_em on {z.device} disagrees with the plain block "
                f"stencil: max abs error {err:.3e} > {lim:.3e}")
    scale = max(1.0, float(y_ref.abs().max()))
    tol = 1e-8 if y_ref.dtype == torch.float64 else 2e-4
    return float((y_st - y_ref).abs().max()) <= tol * scale


class BlockEllMatrix:
    """Assembled DG operator with per-element block taps, the
    variable-coefficient generalisation of BlockStencilOperator (the DG
    counterpart of the lattice-ELL matrix, assembly/ell.py):

        A[(e, a), (e + off_t, b)] = values[t][e, a, b]

    SpMV = one contraction per tap over the element lattice with shifted
    operands, in plain torch."""

    def __init__(self, cells, nb, offsets, values):
        self.cells = tuple(cells)            # element lattice, dim0 fastest
        self.nb = int(nb)
        self.offsets = np.asarray(offsets)   # (ntaps, dim)
        self.values = values                 # (ntaps, *grid_rev, nb, nb) tensor

    @property
    def ndofs(self):
        return int(np.prod(self.cells)) * self.nb

    def __call__(self, z):
        cells = self.cells
        dim = len(cells)
        grid_rev = tuple(reversed(cells))
        gp = F.pad(z.reshape(grid_rev + (self.nb,)), (0, 0) + (1, 1) * dim)
        V = self.values.to(z.dtype)
        out = None
        for t, off in enumerate(self.offsets):
            sl = tuple(slice(1 + int(off[d]), 1 + int(off[d]) + cells[d])
                       for d in reversed(range(dim)))
            term = torch.einsum("...ab,...b->...a", V[t], gp[sl])
            out = term if out is None else out + term
        return out.reshape(-1)

    def pattern_stats(self):
        E = int(np.prod(self.cells))
        ntaps = len(self.offsets)
        return {"rows": E * self.nb, "ntaps": ntaps, "block": self.nb,
                "nnz_stored": E * ntaps * self.nb * self.nb,
                "bytes_values": self.values.numel() * self.values.element_size()}


def assemble_block_ell(go, x_lin=None, time=0.0):
    """Assemble go's Jacobian at x_lin as a BlockEllMatrix.

    Valid for variable coefficients and nonlinear operators (linearization
    at x_lin), unlike compile_block_stencil. Probing uses element coloring
    (coords mod 3 per dim: face-coupled columns never share a row block),
    so assembly costs 3^dim * nb jacobian_apply sweeps on x_lin's device
    (default: a zero vector of the default float on the default device).
    Returns None when the space does not qualify (single-leaf DG, cube
    mesh, non-periodic, no constrained DOFs)."""
    space = go.space
    if not _dg_layout_ok(space):
        return None
    if go.cg is not None and go.cg.nconstrained > 0:
        return None
    mesh = space.mesh
    dim = mesh.dim
    nb = space.fem.nbasis
    cells = tuple(mesh.cells)
    grid_rev = tuple(reversed(cells))
    if x_lin is None:
        x_lin = torch.zeros(space.ndofs, dtype=default_float(),
                            device=resolve_device(None))
    dt, dev = x_lin.dtype, x_lin.device
    offsets = face_offsets(dim)
    ntaps = len(offsets)
    emi = torch.stack(torch.meshgrid(
        *[torch.arange(n, device=dev) % 3 for n in grid_rev], indexing="ij"))

    values = torch.zeros((ntaps,) + grid_rev + (nb, nb), dtype=dt, device=dev)
    for color in itertools.product(*[range(min(3, n)) for n in grid_rev]):
        sel = torch.ones(grid_rev, dtype=torch.bool, device=dev)
        for a in range(dim):
            sel &= emi[a] == color[a]
        for j in range(nb):
            e = torch.zeros(grid_rev + (nb,), dtype=dt, device=dev)
            e[..., j] = sel.to(dt)
            col = go.jacobian_apply(x_lin, e.reshape(-1), time).reshape(grid_rev + (nb,))
            for t in range(ntaps):
                off_g = offsets[t][::-1]                 # grid-axis order
                start = [(color[a] - int(off_g[a])) % 3 for a in range(dim)]
                if any(start[a] >= grid_rev[a] for a in range(dim)):
                    continue
                sl = tuple(slice(start[a], None, 3) for a in range(dim))
                values[(t,) + sl + (slice(None), j)] = col[sl]
    return BlockEllMatrix(cells, nb, offsets, values)
