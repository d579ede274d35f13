"""Every fast tier of the port declines H(div), H(curl) and mimetic leaves.

The compiled stencil (assembly/stencil.py, kernel K2), the fused structured
operator (assembly/structured_fused.py, K3), the lattice-ELL assemblies
(assembly/ell.py, K4) and the block stencil (assembly/blockstencil.py,
K5/K6) assume C0 lattice or element-major DG layouts. Each must return
None for an H(div), H(curl) or mimetic leaf and for a composite space that
holds one, even with the one operator a tier knows (ConvectionDiffusionFEM),
so these spaces run on the general torch.func.jvp apply; the linear solver
backend names every declined tier in report(). CPU, fp64; no tolerances
(None or a report line).
"""
import pytest
import torch

import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu_torch.assembly.blockstencil import compile_block_stencil
from dune_pdelab_tpu_torch.assembly.ell import (
    assemble_ell, assemble_ell_device, assemble_ell_direct,
)
from dune_pdelab_tpu_torch.assembly.stencil import compile_stencil
from dune_pdelab_tpu_torch.assembly.structured_fused import (
    make_fused_japply, make_fused_residual,
)
from dune_pdelab_tpu_torch.constraints import DirichletConstraints
from dune_pdelab_tpu_torch.fe import P0FEM
from dune_pdelab_tpu_torch.fe.hcurl import N0Cube
from dune_pdelab_tpu_torch.fe.hdiv import RT0Cube
from dune_pdelab_tpu_torch.fe.mimetic import DiffusionMFD, MimeticFEM
from dune_pdelab_tpu_torch.ops import (
    ConvectionDiffusionFEM, ConvectionDiffusionProblem, CurlCurl, CurlCurlParameters,
    DiffusionMixed, LocalOperator,
)
from dune_pdelab_tpu_torch.solvers import LinearSolverBackend
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64
KINDS = ("hdiv", "hcurl", "mimetic", "composite")


def _space(kind, dim, n):
    mesh = tpt.StructuredMesh([0] * dim, [1] * dim, (n,) * dim)
    if kind == "hdiv":
        return tpt.FunctionSpace(mesh, RT0Cube(dim))
    if kind == "hcurl":
        return tpt.FunctionSpace(mesh, N0Cube(dim))
    if kind == "mimetic":
        return tpt.FunctionSpace(mesh, MimeticFEM(dim))
    return tpt.CompositeSpace(tpt.FunctionSpace(mesh, RT0Cube(dim)),
                              tpt.FunctionSpace(mesh, P0FEM(dim)))


class HdivInner(LocalOperator):
    """The H(div) inner product u.v + div u div v, an SPD operator on one
    H(div) leaf."""

    is_linear = True

    def alpha_volume(self, ctx, u):
        tab = ctx.tab
        return (self.accumulate_hdiv(tab, ctx.factor, self.hdiv_value_at_qp(tab, u))
                + self.accumulate_div(tab, ctx.factor, self.div_at_qp(tab, u)))


def _own_operator(kind, space):
    """The space's natural operator and constraints."""
    problem = ConvectionDiffusionProblem()
    if kind == "hcurl":
        return CurlCurl(CurlCurlParameters()), DirichletConstraints(space.boundary_edge_mask())
    if kind == "mimetic":
        return DiffusionMFD(problem), tpt.constraints(True, space)
    if kind == "composite":
        return DiffusionMixed(problem), None
    return HdivInner(), None


TIERS = {
    "stencil": lambda go: compile_stencil(go),
    "fused-residual": lambda go: make_fused_residual(go),
    "fused-japply": lambda go: make_fused_japply(go),
    "ell": lambda go: assemble_ell(go),
    "ell-device": lambda go: assemble_ell_device(go),
    "ell-direct": lambda go: assemble_ell_direct(go),
    "block-stencil": lambda go: compile_block_stencil(go),
}


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("kind", KINDS)
def test_fast_tier_declines(tier, kind):
    """3D 6^3 (the fused tier's 3D uniform lattice), with the space's own
    operator and, on a single leaf, the convection-diffusion operator the
    tiers know."""
    space = _space(kind, 3, 6)
    ops = [_own_operator(kind, space)]
    if kind != "composite":         # one scalar kernel fits one leaf only
        ops.append((ConvectionDiffusionFEM(ConvectionDiffusionProblem()), None))
    for lop, cons in ops:
        go = tpt.GridOperator(space, lop, constraints=cons)
        assert TIERS[tier](go) is None


@pytest.mark.parametrize("matrix_free", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_report_names_declined_tiers(kind, matrix_free):
    """A solve through LinearSolverBackend lands on the general-jvp apply
    (or the sparse COO matrix) and report() names each declined tier."""
    space = _space(kind, 2, 4)
    lop, cons = _own_operator(kind, space)
    go = tpt.GridOperator(space, lop, constraints=cons)
    solver = "minres" if kind == "composite" else "cg"
    ls = LinearSolverBackend(solver=solver, precond="none", maxiter=3, matrix_free=matrix_free)
    x = torch.zeros(space.ndofs, dtype=F64)
    ls.solve(go, x, torch.ones(space.ndofs, dtype=F64), 1e-8)
    rep = ls.report(go)
    if matrix_free:
        assert "solve path: general-jvp" in rep
        assert "declined stencil:" in rep and "declined block_stencil:" in rep
    else:
        assert "solve path: assembled sparse COO matvec" in rep
        assert "declined lattice-ELL:" in rep
