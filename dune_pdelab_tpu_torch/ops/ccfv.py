"""Cell-centered finite volume convection-diffusion on P0 spaces.

PyTorch port of dune_pdelab_tpu/ops/ccfv.py (reference:
dune/pdelab/localoperator/convectiondiffusionccfv.hh): two-point flux
approximation with harmonic diffusivity averaging and upwinded convection;
Dirichlet boundaries via ghost values at distance h/2. Shares the
(A, b, c, f, bctype, g, j, o) parameter protocol of ops/convectiondiffusion.py.

Per interior face (inside i, outside o, normal n, center distance d):
  flux = - A_harm (u_o - u_i)/d * |F|  +  (b.n) upwind(u_i, u_o) * |F|
accumulated +flux to r_i, -flux to r_o.

The operator is linear with no strong constraints on a P0 space, so its
solves take the block-stencil tier with one DOF per element
(solvers/linear.py `_stencil_for`): the blockstencil kernel at nb = 1,
element-major in 2D, mode-major in 3D.
"""
from __future__ import annotations

import copy

import torch

from dune_pdelab_tpu_torch.ops.base import (
    FaceContext, LocalOperator, SkeletonContext, VolumeContext,
)
from dune_pdelab_tpu_torch.ops.convectiondiffusion import (
    BCType, ConvectionDiffusionProblem, _is_zero, at_face_qp,
)


def _normal_dot(v, n, like):
    """v . n for a field v broadcast to like's (..., dim) shape."""
    v = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return (torch.broadcast_to(v, like.shape) * n).sum(-1)


class ConvectionDiffusionCCFV(LocalOperator):
    is_linear = True
    quadrature_factor = 0   # P0: midpoint rules everywhere
    quadrature_add = 0

    def __init__(self, problem: ConvectionDiffusionProblem):
        self.problem = problem

    def set_time(self, t):
        new = copy.copy(self)
        new.problem = self.problem.with_time(t)
        return new

    def _scalarA(self, x, n):
        """Normal diffusivity (scalar A; tensor: n.A n)."""
        A = torch.as_tensor(self.problem.A(x), dtype=x.dtype, device=x.device)
        if A.ndim >= 2 and A.shape[-1] == A.shape[-2] == x.shape[-1]:
            An = torch.einsum("...ij,j->...i", A, n)
            return torch.einsum("...i,i->...", An, n)
        return A

    def max_speed(self, x=None, bmax=None, mesh=None):
        """Max convective speed for CFLTimeController (the conservative
        analog of the reference's cell-influx suggestTimestep,
        convectiondiffusionccfv.hh:513). `x` is the solution state (unused:
        the flux is linear in u). Pass `bmax` for position-dependent
        velocity fields, or `mesh` so the field is sampled at element
        centers: a single-point probe of a position-dependent b can
        underestimate the CFL-critical speed."""
        if bmax is not None:
            return bmax
        if mesh is not None and hasattr(mesh, "element_centers"):
            pts = torch.as_tensor(mesh.element_centers(), dtype=torch.float64)
            b = torch.as_tensor(self.problem.b(pts), dtype=torch.float64)
            return float(b.abs().max())
        for d in (3, 2, 1):                # problem dim is not stored here
            try:
                pr = torch.zeros((1, d), dtype=torch.float64)
                b0 = torch.as_tensor(self.problem.b(pr), dtype=torch.float64)
                # probe a second point: a position-dependent field with no
                # bmax/mesh information is a CFL hazard, refuse to guess
                b1 = torch.as_tensor(self.problem.b(pr + 0.371), dtype=torch.float64)
                same = bool(torch.allclose(b0, b1))
            except (ValueError, TypeError, IndexError, RuntimeError):
                continue
            if not same:
                raise ValueError(
                    "max_speed: problem.b is position-dependent; pass "
                    "bmax=, mesh=, or sample points x= so the CFL bound "
                    "covers the whole domain")
            return float(b0.abs().max())
        return 0.0

    # -- volume: reaction + source ------------------------------------------
    def alpha_volume(self, ctx: VolumeContext, u):
        c = self.problem.c(ctx.x)
        if _is_zero(c):
            return torch.zeros_like(u)
        cq = torch.broadcast_to(torch.as_tensor(c, dtype=u.dtype, device=u.device),
                                ctx.x.shape[:-1])
        return u * (cq * ctx.factor).sum(-1)[:, None]

    def lambda_volume(self, ctx: VolumeContext):
        f = torch.broadcast_to(
            torch.as_tensor(self.problem.f(ctx.x), dtype=ctx.factor.dtype,
                            device=ctx.factor.device), ctx.x.shape[:-1])
        return -(f * ctx.factor).sum(-1)[:, None]

    # -- interior faces: TPFA -----------------------------------------------
    def alpha_skeleton(self, ctx: SkeletonContext, u_in, u_out):
        n = ctx.normal
        ui = u_in[:, 0][:, None]                            # (F, 1)
        uo = u_out[:, 0][:, None]
        # A at BOTH cell centers, harmonic average of the normal
        # diffusivities: the heterogeneous TPFA of the reference
        # (convectiondiffusionccfv.hh:152-160); centers at x -+ (h/2) n
        nn = torch.broadcast_to(n, ctx.x.shape)
        x_ci = ctx.x - 0.5 * ctx.h_inside[:, None, None] * nn
        x_co = ctx.x + 0.5 * ctx.h_outside[:, None, None] * nn
        Ai = self._scalarA(x_ci, n)                         # (F, nqp)
        Ao = self._scalarA(x_co, n)
        Ah = 2.0 * Ai * Ao / (Ai + Ao + 1e-300)
        d = 0.5 * (ctx.h_inside + ctx.h_outside)[:, None]   # center distance
        bn = _normal_dot(self.problem.b(ctx.x), n, ctx.x)
        upw = torch.where(bn >= 0, ui, uo)
        fluxd = -Ah * (uo - ui) / d                         # (F, nqp)
        flux = ((fluxd + bn * upw) * ctx.factor).sum(-1)[:, None]
        return flux, -flux

    # -- boundary faces ------------------------------------------------------
    def _boundary_terms(self, ctx: FaceContext):
        """(bctype, cell-center diffusivity A, b.n, ghost distance d)."""
        p, n = self.problem, ctx.normal
        bct = at_face_qp(p.bctype(ctx.x), ctx)
        nn = torch.broadcast_to(n, ctx.x.shape)
        x_ci = ctx.x - 0.5 * ctx.h_inside[:, None, None] * nn
        A = self._scalarA(x_ci, n)
        bn = _normal_dot(p.b(ctx.x), n, ctx.x)
        d = ctx.h_inside[:, None] / 2.0
        return bct, A, bn, d

    def alpha_boundary(self, ctx: FaceContext, u):
        ui = u[:, 0][:, None]
        bct, A, bn, d = self._boundary_terms(ctx)
        # Dirichlet: diffusive flux to the ghost value (u-dependent part)
        # plus outflow convection; upwinding against g is in lambda_boundary
        wd = torch.where(bct == BCType.DIRICHLET,
                         A * ui / d + torch.where(bn >= 0, bn * ui, 0.0), 0.0)
        wo = torch.where(bct == BCType.OUTFLOW, bn * ui, 0.0)
        return ((wd + wo) * ctx.factor).sum(-1)[:, None]

    def lambda_boundary(self, ctx: FaceContext):
        p = self.problem
        dt = ctx.factor.dtype
        bct, A, bn, d = self._boundary_terms(ctx)
        gq = at_face_qp(p.g(ctx.x), ctx, dt)
        jq = at_face_qp(p.j(ctx.x), ctx, dt)
        oq = at_face_qp(p.o(ctx.x), ctx, dt)
        w = (torch.where(bct == BCType.DIRICHLET,
                         -A * gq / d + torch.where(bn < 0, bn * gq, 0.0), 0.0)
             + torch.where(bct == BCType.NEUMANN, jq, 0.0)
             + torch.where(bct == BCType.OUTFLOW, oq, 0.0))
        return (w * ctx.factor).sum(-1)[:, None]
