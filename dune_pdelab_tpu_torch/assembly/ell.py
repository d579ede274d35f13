"""Assembled lattice-ELL Jacobian: per-row tap values + shift-MAC SpMV.

PyTorch port of dune_pdelab_tpu/assembly/ell.py (reference:
dune/pdelab/backend/istl/bcrspattern.hh:1-409 pattern construction,
bcrsmatrix.hh:1-278 storage). On a structured Qk lattice every DOF row
couples to at most (2k+1)^d neighbours at fixed offsets, so the matrix is
stored offset-keyed:

    A[i, i + off_t] = values[t][i]         (ELL with implicit column index)

and SpMV is `sum_t values[t] * shift(x, off_t)`. Unlike the compiled
stencil this holds per-row values, so it is exact for variable
coefficients and boundary-modified rows.

  * `assemble_ell` / `assemble_ell_device`: colored probing, one
    jacobian_apply per lattice color ((2k+1)^d = 27 sweeps for Q1 3D), on
    the device of x_lin (the reference's host loop and its device variant
    share this code here);
  * `assemble_ell_direct`: m = (k+1)^d jvp probes of alpha_volume on the
    GridOperator's volume context, scattered by strided slice-adds;
  * `EllMatrix.__call__` sends a k = 1 3D matrix to the ell27 kernel
    (kernels/ell27.py: the CUDA kernel for a CUDA tensor, its plain version
    for a CPU tensor); other k and 2D run the plain padded-slice form;
  * `ell_to_csr`: host scipy CSR.

The TPU-only machinery of the reference is not ported: the per-probe jit
split above 4M elements, values passed as jit arguments, and the
lane-alignment qualification of the Pallas lowerings.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import jvp

from dune_pdelab_tpu_torch.kernels.ell27 import ell27
from dune_pdelab_tpu_torch.utils.common import default_float, resolve_device


def lattice_offsets(k, dim):
    """(ntaps, dim) tap offsets, dim 0 fastest (ell.py:110-111 order)."""
    return np.array(list(itertools.product(*[range(-k, k + 1)] * dim)))[:, ::-1]


def shift(arr, off, k):
    """arr (grid-axis order) read at lattice position i + off (off in dim
    order, |off| <= k), zero outside the grid."""
    dim = arr.ndim
    a = arr.to(torch.uint8) if arr.dtype == torch.bool else arr
    gp = F.pad(a, (k, k) * dim)
    sl = tuple(slice(k + int(off[d]), k + int(off[d]) + n)
               for d, n in zip(reversed(range(dim)), arr.shape))
    out = gp[sl]
    return out.bool() if arr.dtype == torch.bool else out


class EllMatrix:
    """y = mask ? z : A z with A stored as (ntaps, *grid) per-row values."""

    def __init__(self, dims, k, offsets, values, mask):
        self.dims = tuple(int(d) for d in dims)  # dof lattice dims, dim0 fastest
        self.k = int(k)
        self.offsets = np.asarray(offsets)       # (ntaps, dim) dim0 fastest
        self.values = values                     # (ntaps, *grid_shape) tensor
        self.mask = mask                         # (N,) bool tensor or None
        self.grid_shape = tuple(reversed(self.dims))
        self.uses_ell27 = self.k == 1 and len(self.dims) == 3
        if self.uses_ell27 and not np.array_equal(self.offsets, lattice_offsets(1, 3)):
            raise ValueError("a k = 1 3D EllMatrix needs the lattice_offsets(1, 3) "
                             "tap order (the ell27 kernel's)")

    def _apply_impl(self, z):
        """Plain padded-slice form, any k and dimension."""
        zf = z if self.mask is None else torch.where(self.mask, 0.0, z)
        grid = zf.reshape(self.grid_shape)
        out = None
        for t in range(self.offsets.shape[0]):
            term = self.values[t] * shift(grid, self.offsets[t], self.k)
            out = term if out is None else out + term
        y = out.reshape(-1)
        return y if self.mask is None else torch.where(self.mask, z, y)

    def __call__(self, z):
        if self.uses_ell27:
            return ell27(self.values, z, self.mask, self.dims)
        return self._apply_impl(z)

    def pattern_stats(self):
        """Pattern statistics (reference: bcrspattern.hh bookkeeping)."""
        vals = self.values
        N = int(np.prod(self.dims))
        stored = vals.numel()
        nbytes = stored * vals.element_size()
        nnz = int(torch.count_nonzero(vals))
        return {
            "rows": N,
            "taps": int(self.offsets.shape[0]),
            "stored_entries": stored,
            "nonzeros": nnz,
            "fill_ratio": nnz / max(stored, 1),
            "bytes": nbytes,
            "bytes_per_row": nbytes / max(N, 1),
        }


def _lattice_space(space):
    """Single-leaf C0 tensor Lagrange space on a non-periodic structured
    cube mesh (a simplex mesh declines: it has no DOF lattice)."""
    return (getattr(space, "is_leaf", False)
            and space.mesh.geometry_type == "cube"
            and space.fem.continuity == "C0"
            and hasattr(space.fem, "_mi") and not any(space.mesh.periodic))


def _default_x_lin(go):
    device = go.cg.mask.device if go.cg is not None else resolve_device(None)
    return torch.zeros(go.space.ndofs, dtype=default_float(), device=device)


def _probed_ell(go, x_lin, time):
    """Colored probing on the device of x_lin: for lattice color c, one
    jacobian_apply of e_c = sum of unit vectors at points with coords = c
    (mod 2k+1); same-color columns never share a row, so the rows i with
    i + off_t of color c read tap t from that probe."""
    space = go.space
    if not _lattice_space(space):
        return None
    k = space.fem.degree
    dim = space.mesh.dim
    dims = space._dof_grid_dims
    grid_shape = tuple(reversed(dims))
    P = 2 * k + 1
    offsets = lattice_offsets(k, dim)
    if x_lin is None:
        x_lin = _default_x_lin(go)
    dtype, device = x_lin.dtype, x_lin.device
    residues = [(torch.arange(n, device=device) % P).reshape(
        [n if a == b else 1 for b in range(dim)]) for a, n in enumerate(grid_shape)]
    values = torch.zeros((len(offsets),) + grid_shape, dtype=dtype, device=device)
    for color in itertools.product(*[range(min(P, n)) for n in grid_shape]):
        sel = torch.ones(grid_shape, dtype=torch.bool, device=device)
        for a in range(dim):
            sel = sel & (residues[a] == color[a])
        col = go.jacobian_apply(x_lin, sel.to(dtype).reshape(-1), time).reshape(grid_shape)
        for t in range(len(offsets)):
            off_g = offsets[t][::-1]                   # grid-axis order
            start = [(color[a] - int(off_g[a])) % P for a in range(dim)]
            if any(start[a] >= grid_shape[a] for a in range(dim)):
                continue
            sl = tuple(slice(s, None, P) for s in start)
            values[(t,) + sl] = col[sl]
    mask = go.cg.mask_on(device) if go.cg is not None else None
    if mask is not None:
        # jacobian_apply returns z on constrained rows: identity artifacts,
        # not matrix values (the apply re-imposes identity via the mask)
        values.masked_fill_(mask.reshape(grid_shape), 0.0)
    return EllMatrix(dims, k, offsets, values, mask)


def assemble_ell(go, x_lin=None, time=0.0):
    """Assemble the (constrained) Jacobian of `go` at x_lin as an EllMatrix,
    by colored probing on the device of x_lin (default: zeros in the default
    float on the constraint mask's device).

    Returns None when the space does not qualify (needs a single-leaf C0
    tensor Lagrange space on a structured mesh)."""
    return _probed_ell(go, x_lin, time)


def assemble_ell_device(go, x_lin=None, time=0.0):
    """Device-resident lattice-ELL assembly: the reference's device variant
    of colored probing (ell.py:339-417). In the port every assembly runs on
    the device of x_lin, so this shares `assemble_ell`'s code."""
    return _probed_ell(go, x_lin, time)


def assemble_ell_direct(go, x_lin=None, time=0.0, check=False):
    """One-sweep lattice-ELL assembly without colored probing.

    Per-element Jacobian columns come from m = (k+1)^d torch.func.jvp
    probes of alpha_volume on the GridOperator's volume context; the
    local->global scatter is m^2 strided slice-adds (A[k c + mi_a,
    k c + mi_b] += J_e[a, b] is a step-k slice update per (a, b) pair),
    exact for boundary rows. Row and column masks then give the
    symmetrically eliminated operator, equal to the probed one.

    Applies to leaf C0 tensor-nodal Qk spaces on uniform non-periodic
    meshes, volume-kernel Jacobians (no face terms) and non-affine
    constraints; returns None otherwise. A nonlinear operator is
    linearised at x_lin: its local coefficients are gathered through the
    GridOperator's DOF map (slices on the lattice); a linear one probes at
    zero, as the reference does.

    check=True holds the result against go.jacobian_apply (1e-5 relative).
    Nothing is cached: each call builds the values anew.
    """
    space = go.space
    if not _lattice_space(space) or not space.mesh.uniform:
        return None
    if not go.has["alpha_volume"]:
        return None
    if go.has["alpha_boundary"] or go.has["alpha_skeleton"]:
        return None                      # face jacobian terms: use probing
    if go.cg is not None and getattr(go.cg, "has_affine", False):
        return None                      # affine constraints: use probing
    if x_lin is None:
        x_lin = _default_x_lin(go)
    dtype, device = x_lin.dtype, x_lin.device
    fem, mesh = space.fem, space.mesh
    k, dim, m = fem.degree, mesh.dim, fem.nbasis
    cells = mesh.cells
    cells_shape = tuple(reversed(cells))
    grid_shape = tuple(reversed(space._dof_grid_dims))
    E = mesh.nelements
    mi = np.asarray(fem._mi)             # (m, dim) local nodes, dim0 fastest
    offsets = lattice_offsets(k, dim)
    tap_of = {tuple(int(c) for c in o): t for t, o in enumerate(offsets)}
    mask = go.cg.mask_on(device) if go.cg is not None else None
    lop = go.lop.set_time(time)

    def row_slices(a):
        """Dof-grid slices selecting rows k*c + mi[a] (grid-axis order)."""
        return tuple(slice(int(mi[a][d]), int(mi[a][d]) + k * (cells[d] - 1) + 1, k)
                     for d in reversed(range(dim)))

    ctx = go._volume_ctx(time, dtype, device)
    if getattr(go.lop, "is_linear", False):
        u0 = torch.zeros((E, m), dtype=dtype, device=device)
    else:
        u0 = go.dof_maps[0].gather(x_lin)               # (E, m) local coefficients
    V = torch.zeros((len(offsets),) + grid_shape, dtype=dtype, device=device)
    for b in range(m):
        tangent = torch.zeros(m, dtype=dtype, device=device)
        tangent[b] = 1.0
        _, col = jvp(lambda u: lop.alpha_volume(ctx, u), (u0,),
                     (tangent.expand(E, m),))              # (E, m) = J[:, :, b]
        colg = col.reshape(cells_shape + (m,))
        for a in range(m):
            t = tap_of[tuple(int(v) for v in (mi[b] - mi[a]))]
            V[(t,) + row_slices(a)] += colg[..., a]
        del col, colg
    if mask is not None:
        # rows, and the taps whose column is constrained, so the values
        # equal the probed (symmetrically eliminated) operator's
        mg = mask.reshape(grid_shape)
        for t in range(len(offsets)):
            V[t].masked_fill_(mg | shift(mg, offsets[t], k), 0.0)
    ell = EllMatrix(space._dof_grid_dims, k, offsets, V, mask)
    if check:
        _ell_direct_check(go, ell, x_lin, time)
    return ell


def _ell_direct_check(go, ell, x_lin, time):
    rng = np.random.default_rng(0)
    z = torch.as_tensor(rng.standard_normal(go.space.ndofs), dtype=x_lin.dtype,
                        device=x_lin.device)
    y_ref = go.jacobian_apply(x_lin, z, time)
    err = float((ell(z) - y_ref).abs().max())
    scale = float(y_ref.abs().max()) or 1.0
    if err > 1e-5 * scale:
        raise AssertionError(
            f"direct ELL parity failure: max err {err:.3e} (scale {scale:.3e})")


def ell_to_csr(ell: EllMatrix):
    """Convert to scipy.sparse CSR on the host (inspection, direct solvers).
    Masked (Dirichlet) rows become identity rows."""
    import scipy.sparse as sp

    dims = ell.dims
    dim = len(dims)
    N = int(np.prod(dims))
    vals = ell.values.detach().cpu().numpy()
    strides = np.ones(dim, dtype=np.int64)
    for d in range(1, dim):
        strides[d] = strides[d - 1] * dims[d - 1]
    mask = (ell.mask.cpu().numpy().reshape(-1) if ell.mask is not None
            else np.zeros(N, bool))
    # lattice multi-index of every row, dim 0 first
    g = np.arange(N, dtype=np.int64)
    mi = np.empty((N, dim), dtype=np.int64)
    for d in range(dim):
        mi[:, d] = g % dims[d]
        g = g // dims[d]
    rows_parts, cols_parts, data_parts = [], [], []
    for t in range(ell.offsets.shape[0]):
        tgt = mi + ell.offsets[t][None, :]
        valid = np.all((tgt >= 0) & (tgt < np.asarray(dims)[None, :]), axis=1)
        valid &= ~mask
        v = vals[t].reshape(-1)
        valid &= v != 0.0
        rows_parts.append(np.nonzero(valid)[0])
        cols_parts.append((tgt[valid] * strides[None, :]).sum(axis=1))
        data_parts.append(v[valid])
    mrows = np.nonzero(mask)[0]          # identity on masked rows
    rows_parts.append(mrows)
    cols_parts.append(mrows)
    data_parts.append(np.ones(len(mrows)))
    return sp.csr_matrix(
        (np.concatenate(data_parts),
         (np.concatenate(rows_parts), np.concatenate(cols_parts))),
        shape=(N, N))


def try_pallas_tiled_ell(ell: EllMatrix):
    """The kernel-backed apply z -> mask ? z : A z of a k = 1 3D EllMatrix
    (the ell27 kernel, which replaces the TPU's row-tiled K4b,
    ell.py:467-561, and the plane-streamed K4a); None for other k or
    dimensions. Any dims, fp32 or fp64, with or without a mask."""
    if not ell.uses_ell27:
        return None
    values, mask, dims = ell.values, ell.mask, ell.dims
    return lambda z: ell27(values, z, mask, dims)
