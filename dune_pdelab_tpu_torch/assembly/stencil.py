"""Stencil compilation: translation-invariant operators as shift-MAC kernels.

PyTorch port of dune_pdelab_tpu/assembly/stencil.py. On a uniform
structured mesh with translation-invariant coefficients, the Jacobian of a
Qk operator is a convolution: every interior DOF row of a residue class has
the same (2k+1)^d neighbour weights. `compile_stencil` probes J with unit
vectors at interior representative DOFs (torch.func.jvp through
GridOperator.jacobian_apply), verifies the result against the full operator
with one random vector, and returns a StencilOperator.

StencilOperator.__call__ sends k = 1, single-class 3D operators to the
stencil27 kernel (kernels/stencil27.py: the CUDA kernel for a CUDA tensor,
its plain version for a CPU tensor); the multi-class (k > 1) and 2D
operators run the plain torch form here (padded slices for one class, a
strided window and one tensordot per class for several), as the JAX
package leaves them to XLA. Applies take a vector or a batch of vectors.

Validity requirements: single-leaf C0 tensor Lagrange space on a uniform
non-periodic mesh, linear operator with translation-invariant coefficients,
every mesh boundary DOF Dirichlet-constrained.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

from dune_pdelab_tpu_torch.kernels.stencil27 import stencil27, tap_tensor
from dune_pdelab_tpu_torch.space.space import _leaf_boundary_dof_mask, to_numpy
from dune_pdelab_tpu_torch.utils.common import default_float, device_key, resolve_device

# Meshes with more elements than this are probed on a small proxy mesh of
# the same spacing (module constant so a test can lower it).
PROXY_MIN_ELEMENTS = 200_000


class StencilOperator:
    """y = mask ? z : stencil(z) with zero Dirichlet columns."""

    def __init__(self, dims, k, weights, offsets, mask, interior_classes):
        self.dims = tuple(dims)          # dof grid dims, dim0 fastest
        self.k = k
        self.weights = weights           # (nclass, ntaps) numpy float64
        self.offsets = offsets           # (ntaps, dim) numpy
        self.mask = mask                 # (N,) bool tensor or None
        self.interior_classes = interior_classes   # residue class per row of weights
        self.uses_stencil27 = (k == 1 and weights.shape[0] == 1
                               and len(self.dims) == 3)
        self.w27 = (tap_tensor(offsets, weights[0]) if self.uses_stencil27
                    else None)
        self._dense = {}

    def _dense_weights(self, dtype, device):
        """Per residue class, the weights as a dense (2k+1,)*dim tensor in
        the grid's C order (slowest axis first), zeros where no tap."""
        key = (dtype, device_key(device))
        if key not in self._dense:
            dim, k = len(self.dims), self.k
            W = np.zeros((self.weights.shape[0],) + (2 * k + 1,) * dim)
            for t, off in enumerate(self.offsets):
                W[(slice(None),) + tuple(int(off[d]) + k for d in reversed(range(dim)))] = (
                    self.weights[:, t])
            self._dense[key] = torch.as_tensor(W, dtype=dtype, device=device)
        return self._dense[key]

    def _apply_impl(self, z):
        """Plain form, any k and dimension; z is (N,) or a batch (B, N).

        One class (k = 1): a weighted sum of padded slices, one per tap.
        Several classes (k > 1): per class, a strided window view of the
        padded grid (output points x (2k+1)^dim taps) contracted with the
        class's dense weights in one tensordot, so an apply takes a few
        launches per class instead of two per tap."""
        dims = self.dims
        dim = len(dims)
        k = self.k
        zf = z if self.mask is None else torch.where(self.mask, 0.0, z)
        batch = z.shape[:-1]
        grid = zf.reshape(batch + tuple(reversed(dims)))  # C-order, dim0 last
        pad = k
        gp = F.pad(grid, (pad, pad) * dim)
        out = torch.zeros_like(grid)
        if self.weights.shape[0] > 1:
            W = self._dense_weights(z.dtype, z.device)
            sp = gp.stride()
            nb = len(batch)
            for ci, cls in enumerate(itertools.product(*[range(k)] * dim)):
                sl = (Ellipsis,) + tuple(slice(cls[d], None, k) for d in reversed(range(dim)))
                size = out[sl].shape
                start = gp.storage_offset() + sum(
                    cls[dim - 1 - a] * sp[nb + a] for a in range(dim))
                win = gp.as_strided(size + (2 * k + 1,) * dim,
                                    sp[:nb] + tuple(k * st for st in sp[nb:]) + sp[nb:],
                                    start)
                out[sl] = torch.tensordot(win, W[ci], dims=dim)
        else:
            w = self.weights[0]
            acc = None
            for t, off in enumerate(self.offsets):
                if w[t] == 0.0:
                    continue
                start = [pad + int(off[d]) for d in reversed(range(dim))]
                piece = gp[(Ellipsis,) + tuple(slice(s, s + n) for s, n in
                                               zip(start, grid.shape[len(batch):]))]
                acc = float(w[t]) * piece if acc is None else acc + float(w[t]) * piece
            out[...] = 0.0 if acc is None else acc
        y = out.reshape(batch + (-1,))
        return y if self.mask is None else torch.where(self.mask, z, y)

    def __call__(self, z):
        """y = A z for z (N,) or a batch (B, N)."""
        if self.uses_stencil27:
            if z.ndim > 1:
                return torch.stack([stencil27(zi, self.mask, self.w27, self.dims)
                                    for zi in z])
            return stencil27(z, self.mask, self.w27, self.dims)
        return self._apply_impl(z)

    def diagonal(self, dtype=None, device=None):
        """Exact operator diagonal from the stencil data alone: the
        zero-offset tap weight per residue class; identity (1.0) on masked
        (constrained) rows."""
        dim = len(self.dims)
        k = self.k
        t0 = int(np.nonzero(~np.any(self.offsets, axis=1))[0][0])
        dt = dtype or default_float()
        if device is None and self.mask is not None:
            device = self.mask.device
        shape = tuple(reversed(self.dims))
        if self.weights.shape[0] == 1:
            diag = torch.full(shape, float(self.weights[0][t0]), dtype=dt,
                              device=device)
        else:
            diag = torch.zeros(shape, dtype=dt, device=device)
            for ci, cls in enumerate(itertools.product(*[range(k)] * dim)):
                sl = tuple(slice(cls[d], None, k) for d in reversed(range(dim)))
                diag[sl] = float(self.weights[ci][t0])
        diag = diag.reshape(-1)
        if self.mask is not None:
            diag = torch.where(self.mask.to(diag.device), 1.0, diag)
        return diag


def compile_stencil(go, x_lin=None, time=0.0, check=True, dtype=None,
                    device=None):
    """Build a StencilOperator equivalent to go.jacobian_apply(x_lin, . ).

    Probes run in `dtype` on `device` (defaults: x_lin's, else the default
    float and the constraint mask's device, else the default device).
    Returns None when the operator/space does not qualify.
    """
    space = go.space
    if not getattr(space, "is_leaf", False):
        return None
    fem = space.fem
    mesh = space.mesh
    if mesh.geometry_type != "cube":
        return None          # a simplex mesh has no lattice stencil
    if (fem.continuity != "C0" or not hasattr(fem, "_mi")
            or not mesh.uniform or any(mesh.periodic)):
        return None
    if not getattr(go.lop, "is_linear", False):
        return None
    if x_lin is not None:
        dtype = dtype or x_lin.dtype
        device = device or x_lin.device
    dtype = dtype or default_float()
    if device is None:
        device = go.cg.mask.device if go.cg is not None else resolve_device(None)
    if go.cg is not None:
        # boundary rows must all be constrained for the masked stencil to
        # be exact (they get overwritten by identity)
        bmask = _leaf_boundary_dof_mask(space)
        if not np.all(go.cg.mask_np[np.nonzero(bmask)[0]]):
            return None
    k = fem.degree
    dim = mesh.dim
    dims = space._dof_grid_dims
    if any(c < 6 for c in mesh.cells):
        return None  # too small to host interior probes

    mask = go.cg.mask_on(device) if go.cg is not None else None
    # huge meshes: probe on a small PROXY mesh with the same spacing h;
    # translation invariance makes the weights identical. Only valid at the
    # default linearization point and without boundary kernels.
    # (a selective operator's masks are not translation invariant: it
    # takes the probes on the real mesh and the whole-domain check)
    if (mesh.nelements > PROXY_MIN_ELEMENTS and x_lin is None and not go.selective
            and not go.has.get("alpha_boundary", False)
            and not go.has.get("lambda_boundary", False)
            and not go.has.get("alpha_skeleton", False)
            and _coefficients_spatially_constant(go.lop, mesh)):
        from dune_pdelab_tpu_torch.assembly.gridoperator import GridOperator
        from dune_pdelab_tpu_torch.constraints.dirichlet import (
            constraints as make_constraints,
        )
        from dune_pdelab_tpu_torch.space.space import FunctionSpace
        pc = tuple(max(8, 4 * k + 4) for _ in range(dim))
        mesh_p = type(mesh)(mesh.lower, mesh.lower + np.array(pc) * mesh.h, pc)
        V_p = FunctionSpace(mesh_p, fem)
        go_p = GridOperator(V_p, go.lop,
                            constraints=make_constraints(True, V_p, device=device),
                            quad_order=go.qorder, skip_boundary=True)
        st_p = compile_stencil(go_p, None, time, check, dtype, device)
        if st_p is None:
            return None
        return StencilOperator(dims, k, st_p.weights, st_p.offsets, mask,
                               st_p.interior_classes)

    if x_lin is None:
        x_lin = torch.zeros(space.ndofs, dtype=dtype, device=device)

    strides = np.ones(dim, dtype=np.int64)
    for d in range(1, dim):
        strides[d] = strides[d - 1] * dims[d - 1]

    def flat(g):
        return int(np.dot(g, strides))

    offsets = np.array(list(itertools.product(
        *[range(-k, k + 1)] * dim)))[:, ::-1]   # dim0 fastest ordering
    ntaps = len(offsets)
    nclass = k**dim
    classes = list(itertools.product(*[range(k)] * dim))

    # probe J at one representative interior dof per *column* class; its
    # column gives, for every row i in the neighbourhood, the weight of
    # offset (j - i) in row-class(i)
    weights = np.zeros((nclass, ntaps))
    base = np.array([2 * k] * dim)  # interior anchor
    for cls in classes:
        j = base + np.array(cls)
        e = torch.zeros(space.ndofs, dtype=dtype, device=device)
        e[flat(j)] = 1.0
        col = go.jacobian_apply(x_lin, e, time).cpu().numpy()
        if np.iscomplexobj(col):
            if np.any(col.imag != 0):
                # complex weights: the reference keeps their real parts and
                # its whole-domain check declines the stencil
                return None
            col = col.real
        for off in itertools.product(*[range(-k, k + 1)] * dim):
            i = j + np.array(off)
            ci = tuple(int(i[d]) % k if k > 1 else 0 for d in range(dim))
            cidx = classes.index(ci) if k > 1 else 0
            t = int(np.nonzero((offsets == j - i).all(axis=1))[0][0])
            weights[cidx, t] = col[flat(i)]

    st = StencilOperator(dims, k, weights, offsets, mask, classes)
    if check and not _global_stencil_parity(go, st, x_lin, time):
        return None   # not translation invariant (anywhere in the domain)
    return st


def _coefficients_spatially_constant(lop, mesh):
    """Proxy-mesh precondition: the Jacobian-relevant coefficient fields
    (A, b, c of the convection-diffusion protocol) must not vary over the
    REAL domain. Sampled at 512 random points (a float64 CPU tensor)."""
    if getattr(lop, "spatially_invariant", False):
        return True
    problem = getattr(lop, "problem", None) or getattr(lop, "params", None)
    if problem is None:
        return False
    rng = np.random.default_rng(4)
    pts = torch.from_numpy(mesh.lower + rng.random((512, mesh.dim))
                           * (mesh.upper - mesh.lower))
    for name in ("A", "b", "c"):
        fn = getattr(problem, name, None)
        if fn is None:
            continue
        v = to_numpy(fn(pts))
        if v.ndim and v.shape[0] == len(pts):
            spread = float((np.max(v, axis=0) - np.min(v, axis=0)).max())
            if spread > 1e-12 * max(1.0, float(np.abs(v).max())):
                return False
    return True


def _global_stencil_parity(go, st, x_lin, time):
    """Whole-domain verification: one random-vector apply of the plain
    stencil form, st._apply_impl(z) == J z over the full index range
    (catches e.g. a central coefficient inclusion that corner probes miss).

    The stencil27 path (kernel on a CUDA tensor) is held against the plain
    form on the same vector and raises on a mismatch: a kernel fault must
    not read as a non-invariant operator and lower the solver tier."""
    rng = np.random.default_rng(96321)
    z = torch.as_tensor(rng.standard_normal(go.space.ndofs), dtype=x_lin.dtype,
                        device=x_lin.device)
    y_ref = go.jacobian_apply(x_lin, z, time)
    y_st = st._apply_impl(z)
    if st.uses_stencil27:
        y_k = st(z)
        err = float((y_k - y_st).abs().max())
        lim = (1e-12 if z.dtype == torch.float64 else 1e-5) * float(y_st.abs().max())
        if not err <= lim:
            raise RuntimeError(
                f"stencil27 on {z.device} disagrees with the plain stencil: "
                f"max abs error {err:.3e} > {lim:.3e}")
    scale = max(1.0, float(y_ref.abs().max()))
    tol = 1e-8 if y_ref.dtype == torch.float64 else 2e-4
    return float((y_st - y_ref).abs().max()) <= tol * scale
