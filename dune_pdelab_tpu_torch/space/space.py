"""Discrete function spaces: DOF maps as lattice arithmetic.

PyTorch port of dune_pdelab_tpu/space/space.py, limited to the single-leaf
spaces on a structured cube mesh: continuous (C0) Qk on the DOF lattice and
discontinuous (DG) Qk numbered element-major, DOF e*nb + j for local basis
function j of element e. Composite, power and permuted spaces wait for
ROADMAP slice 9; H(div) and H(curl) layouts for slice 13.

Setup stays numpy on the host, as in the reference. The (E, nlocal)
`element_dofs` map is built lazily: the structured fast paths
(SlicedDofMap, ReshapeDofMap, compiled stencils) never touch it, and at
512^3 DOFs it would cost about 8.5 GB of host memory.
"""
from __future__ import annotations

import numpy as np
import torch

from dune_pdelab_tpu_torch.fe.basis import (
    FiniteElement, lagrange_nodes_1d, q1_geometry,
)
from dune_pdelab_tpu_torch.mesh.structured import StructuredMesh
from dune_pdelab_tpu_torch.utils.common import default_float, resolve_device


def to_numpy(v) -> np.ndarray:
    """numpy view of a user callback result (tensor, array or scalar)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class FunctionSpace:
    """Leaf discrete space: mesh x finite element -> DOF map.

    Attributes:
      mesh, fem
      ndofs:         global number of DOFs
      element_dofs:  (E, nlocal) int64 numpy, local->global DOF map (lazy)
    """

    is_leaf = True

    def __init__(self, mesh: StructuredMesh, fem: FiniteElement, name: str = ""):
        if fem.geometry != mesh.geometry_type:
            raise ValueError(f"{fem} does not fit mesh geometry {mesh.geometry_type}")
        if fem.continuity not in ("C0", "DG"):
            raise NotImplementedError(
                f"{fem.continuity} spaces are not ported yet (H(div)/H(curl): "
                "ROADMAP slice 13)")
        self.mesh = mesh
        self.fem = fem
        self.name = name
        self._element_dofs = None
        if fem.continuity == "DG":
            self._dof_grid_dims = None
            self.ndofs = mesh.nelements * fem.nbasis
        else:
            self._dof_grid_dims = self._c0_dims()
            self.ndofs = int(np.prod(self._dof_grid_dims))

    @property
    def element_dofs(self) -> np.ndarray:
        """(E, nlocal) local->global DOF map (built on first use)."""
        if self._element_dofs is None:
            if self.fem.continuity == "DG":
                nb = self.fem.nbasis
                self._element_dofs = (
                    np.arange(self.mesh.nelements, dtype=np.int64)[:, None] * nb
                    + np.arange(nb, dtype=np.int64)[None, :])
            else:
                self._element_dofs = self._build_c0_map()[0]
        return self._element_dofs

    def _c0_dims(self):
        """Per-axis DOF-grid sizes of the tensor C0 layout."""
        if not hasattr(self.fem, "_mi"):
            raise NotImplementedError(
                f"C0 DOF layout requires a tensor nodal element, got {self.fem}")
        k = self.fem.degree
        return tuple(k * c + 1 for c in self.mesh.cells)

    def _build_c0_map(self):
        mesh, fem = self.mesh, self.fem
        k = fem.degree
        dims = self._c0_dims()
        strides = np.ones(mesh.dim, dtype=np.int64)
        for d in range(1, mesh.dim):
            strides[d] = strides[d - 1] * dims[d - 1]
        emi = mesh.element_multi_index()           # (E, dim)
        g = k * emi[:, None, :] + fem._mi[None, :, :]  # (E, nloc, dim)
        return g @ strides, dims

    def boundary_dof_mask(self) -> np.ndarray:
        """(ndofs,) bool mask of DOFs on the domain boundary."""
        return _leaf_boundary_dof_mask(self)

    # -- node coordinates & interpolation ------------------------------------
    def dof_coords_at(self, idx: np.ndarray) -> np.ndarray:
        """(len(idx), dim) nodal coordinates of selected DOFs, by lattice
        arithmetic (no per-element geometry sweep)."""
        k = self.fem.degree
        nodes1d = lagrange_nodes_1d(k)
        dims = self._dof_grid_dims
        g = np.asarray(idx, dtype=np.int64)
        out = np.empty((len(g), self.mesh.dim))
        for d in range(self.mesh.dim):
            gd = g % dims[d]
            g = g // dims[d]
            out[:, d] = self.mesh.lower[d] + self.mesh.h[d] * (
                gd // k + nodes1d[gd % k])
        return out

    def _geometry_at(self, ref_points: np.ndarray) -> np.ndarray:
        """Map reference points into every element: (E, npts, dim)."""
        corners = self.mesh.element_corner_coords()    # (E, C, dim)
        vals, _ = q1_geometry(self.mesh.dim).tabulate(ref_points)
        return np.einsum("pc,ecd->epd", vals, corners)

    def interpolate(self, f, dtype=None, device=None):
        """Interpolate a callable f(x) -> scalar into a DOF vector.

        f receives a float64 CPU tensor of points (npts, dim) and returns
        a tensor, array or scalar; a complex f gives a complex vector (dtype
        promoted with the values', as in the reference). Analog of `Dune::PDELab::interpolate`
        (reference: dune/pdelab/gridfunctionspace/interpolate.hh:177).
        """
        pts = self._geometry_at(np.atleast_2d(self.fem.interpolation_points))
        flat = pts.reshape(-1, pts.shape[-1])
        v = to_numpy(f(torch.from_numpy(flat)))
        fvals = np.broadcast_to(v, (flat.shape[0],)).reshape(pts.shape[:-1])
        coeffs = np.einsum("bi,ei->eb", self.fem.interpolation_matrix, fvals)
        dtype = dtype or default_float()
        if np.iscomplexobj(coeffs):                    # complex-valued f
            dtype = torch.promote_types(dtype, torch.from_numpy(coeffs[:0, :0]).dtype)
        x = np.zeros(self.ndofs, dtype=coeffs.dtype)
        x[self.element_dofs.reshape(-1)] = coeffs.reshape(-1)
        return torch.as_tensor(x, dtype=dtype, device=resolve_device(device))

    def zero(self, dtype=None, device=None):
        """Zero DOF vector on `device` (default: utils/common.default_device)."""
        return torch.zeros(self.ndofs, dtype=dtype or default_float(),
                           device=resolve_device(device))

    def __repr__(self):
        return f"FunctionSpace({self.fem!r}, ndofs={self.ndofs}, name={self.name!r})"


def _leaf_boundary_dof_mask(space: FunctionSpace) -> np.ndarray:
    """(ndofs,) bool mask of DOFs on the domain boundary.

    Face-slice writes on the nd view: O(surface) work, no O(N) index
    arithmetic.
    """
    dims = space._dof_grid_dims
    if dims is None:
        raise NotImplementedError(
            "boundary DOF masks exist for C0 lattice spaces only; DG boundary "
            "conditions are weak (face terms of the local operator)")
    dim = space.mesh.dim
    mask = np.zeros(tuple(reversed(dims)), dtype=bool)  # C-order, dim0 last
    for d in range(dim):
        ax = dim - 1 - d
        sl = [slice(None)] * dim
        sl[ax] = 0
        mask[tuple(sl)] = True
        sl[ax] = dims[d] - 1
        mask[tuple(sl)] = True
    return mask.reshape(-1)
