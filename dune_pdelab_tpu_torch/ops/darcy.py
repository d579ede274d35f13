"""Darcy-velocity post-processing and permeability adapters.

PyTorch port of dune_pdelab_tpu/ops/darcy.py, the reference's Darcy
post-processing trio:
  * DarcyVelocityFromHeadFEM (reference:
    dune/pdelab/localoperator/darcyfem.hh:24): v = -A grad(u_h) of a
    conforming head solution as a vector-valued grid function, on the
    head's device;
  * DarcyVelocityFromHeadCCFV (reference:
    dune/pdelab/localoperator/darcyccfv.hh:60): lowest-order
    Raviart-Thomas reconstruction of the face-normal velocities of a
    cell-centered (P0/TPFA) head solution, reproducing the solver's
    two-point fluxes exactly (so it inherits the scheme's local
    conservation);
  * permeability_field / diagonal_permeability_field (reference:
    dune/pdelab/localoperator/permeability_adapter.hh:11,57):
    log10-permeability fields for visualization.

The CCFV reconstruction and the adapters run on the host in float64 numpy
(post-processing, like the reference's grid-function adapters); problem
callbacks receive float64 CPU tensors there.
"""
from __future__ import annotations

import numpy as np
import torch

from dune_pdelab_tpu_torch.ops.convectiondiffusion import BCType, apply_tensor
from dune_pdelab_tpu_torch.space.functions import evaluate_at_quadrature
from dune_pdelab_tpu_torch.space.space import to_numpy


# ---------------------------------------------------------------------------
# conforming FEM head -> velocity
# ---------------------------------------------------------------------------

def darcy_velocity_at_quadrature(space, x, problem, quad_order=None):
    """v = -A(x) grad(u_h) at the volume quadrature points of every element.

    Returns (xq (E,nqp,dim), v (E,nqp,dim), factor (Eb,nqp)); integrating
    |v - v_exact|^2 against `factor` gives the vector L2 error.
    """
    xq, _, gu, factor = evaluate_at_quadrature(space, x, quad_order)
    perm = problem.A if hasattr(problem, "A") else problem.D
    v = -apply_tensor(perm(xq.to(gu.dtype)), gu)
    return xq, v, factor


class DarcyVelocityFromHeadFEM:
    """Vector grid function v = -A grad(u_h) (darcyfem.hh:24 analog)."""

    def __init__(self, problem, space, x):
        self.problem = problem
        self.space = space
        self.x = x

    def at_quadrature(self, quad_order=None):
        return darcy_velocity_at_quadrature(self.space, self.x,
                                            self.problem, quad_order)

    def at_centers(self):
        """Velocity at element centers (E, dim): midpoint rule."""
        _, v, _ = self.at_quadrature(quad_order=1)
        return v.mean(1)

    def l2_difference(self, exact_vec, quad_order=None):
        """|| v_h - exact ||_L2 for a callable exact_vec(pts) -> (..., dim)
        (pts: a float64 numpy array)."""
        xq, v, factor = self.at_quadrature(quad_order)
        flat = to_numpy(xq).reshape(-1, xq.shape[-1])
        ve = torch.as_tensor(np.array(exact_vec(flat), np.float64).reshape(v.shape),
                             dtype=v.dtype, device=v.device)
        d = v - ve
        return torch.sqrt((factor * (d * d).sum(-1)).sum())


# ---------------------------------------------------------------------------
# cell-centered head -> RT0 face-velocity reconstruction
# ---------------------------------------------------------------------------

def _eval(fn, pts):
    """A problem callback at float64 host points, as a float64 array."""
    return to_numpy(fn(torch.as_tensor(pts, dtype=torch.float64)))


def _axis_A(problem, pts, d):
    """Normal diffusivity A_dd at points (scalar A or tensor diagonal)."""
    A = np.asarray(_eval(problem.A, pts), dtype=np.float64)
    if A.ndim >= 2 and A.shape[-1] == A.shape[-2] == pts.shape[-1]:
        return A[..., d, d]
    return np.broadcast_to(A, pts.shape[:-1])


class DarcyVelocityFromHeadCCFV:
    """RT0 velocity reconstruction from a TPFA cell-centered head
    (darcyccfv.hh:60 analog).

    Face-normal velocities reproduce the CCFV solver's two-point fluxes
    (ops/ccfv.py): interior v_d = -A_h (u_out - u_in)/h_d with A_h the
    harmonic mean 2 A_in A_out / (A_in + A_out) of the normal diffusivities
    at the two cell centers; Dirichlet faces take A at the inside cell
    center and the ghost value at distance h/2; Neumann faces take the
    prescribed flux. Because they ARE the solver's fluxes,
    `cell_divergence()` of a converged solve equals the cell-mean source
    (local conservation) for any A. Only the diffusive (Darcy) flux is
    reconstructed.

    The reference evaluates A at the face center instead
    (dune_pdelab_tpu/ops/darcy.py:132,154,157), which differs from its own
    solver's fluxes wherever A jumps between a face and a cell center.
    """

    def __init__(self, mesh, problem, u):
        if not mesh.uniform or mesh.geometry_type != "cube":
            raise NotImplementedError(
                "CCFV Darcy reconstruction: uniform structured meshes")
        self.mesh = mesh
        self.problem = problem
        self.u = np.asarray(to_numpy(u), dtype=np.float64)
        self._faces = self._reconstruct()

    def _reconstruct(self):
        mesh, p = self.mesh, self.problem
        dim, cells = mesh.dim, mesh.cells
        lat = tuple(cells[::-1])                # (.., ny, nx): x fastest
        U = self.u.reshape(lat)
        lower, h = np.asarray(mesh.lower), np.asarray(mesh.h)
        out = []
        for d in range(dim):
            ax = dim - 1 - d                    # lattice axis of dim d
            shape = list(lat)
            shape[ax] += 1
            V = np.zeros(shape)
            # face centers: x_d on the face plane, tangential at cell centers
            grids = []
            for dd in range(dim):
                n = cells[dd]
                if dd == d:
                    c = lower[dd] + np.arange(n + 1) * h[dd]
                else:
                    c = lower[dd] + (np.arange(n) + 0.5) * h[dd]
                grids.append(c)
            mg = np.meshgrid(*grids[::-1], indexing="ij")   # lattice order
            pts = np.stack(mg[::-1], axis=-1)               # (..., dim)
            # cell centers below and above each face, as the solver places
            # them (face point -+ (h/2) e_d)
            e = np.zeros(dim)
            e[d] = 0.5 * h[d]
            A_below = _axis_A(p, pts - e, d)
            A_above = _axis_A(p, pts + e, d)

            def sl(part):
                return tuple(slice(None) if a != ax else part for a in range(dim))
            sl_lo, sl_hi, sl_in = sl(slice(0, 1)), sl(slice(-1, None)), sl(slice(1, -1))
            # interior: -A_h (u_next - u_prev)/h, A_h the harmonic mean of
            # the two cell centers' diffusivities
            Ai, Ao = A_below[sl_in], A_above[sl_in]
            Ah = 2.0 * Ai * Ao / (Ai + Ao + 1e-300)
            V[sl_in] = -Ah * np.diff(U, axis=ax) / h[d]
            # boundaries: Dirichlet ghost at h/2, Neumann prescribed flux
            for side, s_ in ((0, sl_lo), (1, sl_hi)):
                fpts = pts[s_]
                shp = fpts.shape[:-1]
                bct = np.broadcast_to(_eval(p.bctype, fpts), shp)
                g = np.broadcast_to(np.asarray(_eval(p.g, fpts), np.float64), shp)
                jf = np.broadcast_to(np.asarray(_eval(p.j, fpts), np.float64), shp)
                uc = U[sl_lo] if side == 0 else U[sl_hi]
                # A at the inside cell center: above the low face, below the high one
                if side == 0:      # du/dx_d ~ (u_cell - g)/(h/2)
                    vdir = -A_above[s_] * (uc - g) / (h[d] / 2)
                    vneu = -jf     # outward normal is -e_d
                else:              # du/dx_d ~ (g - u_cell)/(h/2)
                    vdir = -A_below[s_] * (g - uc) / (h[d] / 2)
                    vneu = jf
                V[s_] = np.where(bct == BCType.DIRICHLET, vdir,
                                 np.where(bct == BCType.NEUMANN, vneu, 0.0))
            out.append(V)
        return out

    def face_normal_velocities(self):
        """Per axis d: array on the face lattice (axis d has cells[d]+1)."""
        return self._faces

    def at_centers(self):
        """RT0 evaluation at element centers: (E, dim) velocities."""
        dim = self.mesh.dim
        cols = []
        for d in range(dim):
            ax = dim - 1 - d
            V = self._faces[d]
            lo = tuple(slice(None) if a != ax else slice(0, -1) for a in range(dim))
            hi = tuple(slice(None) if a != ax else slice(1, None) for a in range(dim))
            cols.append(0.5 * (V[lo] + V[hi]).reshape(-1))
        return np.stack(cols, axis=-1)

    def cell_divergence(self):
        """div(v) per cell from the face fluxes: (E,)."""
        mesh = self.mesh
        dim, h = mesh.dim, np.asarray(mesh.h)
        div = np.zeros(tuple(mesh.cells[::-1]))
        for d in range(dim):
            div += np.diff(self._faces[d], axis=dim - 1 - d) / h[d]
        return div.reshape(-1)


# ---------------------------------------------------------------------------
# permeability adapters (permeability_adapter.hh:11,57)
# ---------------------------------------------------------------------------

def permeability_field(mesh, problem):
    """log10 |K_00| at element centers (PermeabilityAdapter analog): a P0
    field ready for output."""
    pts = mesh.element_centers()
    A = np.asarray(_eval(problem.A, pts), dtype=np.float64)
    if A.ndim >= 2 and A.shape[-1] == A.shape[-2] == pts.shape[-1]:
        A = A[..., 0, 0]
    return np.log10(np.abs(np.broadcast_to(A, pts.shape[:-1])))


def diagonal_permeability_field(mesh, problem):
    """log10 diag(K) at element centers (DiagonalPermeabilityAdapter
    analog): (E, dim)."""
    pts = mesh.element_centers()
    A = np.asarray(_eval(problem.A, pts), dtype=np.float64)
    if A.ndim >= 2 and A.shape[-1] == A.shape[-2] == pts.shape[-1]:
        diag = np.stack([A[..., d, d] for d in range(pts.shape[-1])], axis=-1)
    else:
        diag = np.broadcast_to(A[..., None] if A.ndim == pts.ndim - 1 else A,
                               pts.shape)
    return np.log10(np.abs(diag))
