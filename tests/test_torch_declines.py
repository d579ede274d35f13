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

Selective operators (skip_entity / skip_intersection) as well: the fused
structured operator (K3) declines them, as the reference does
(structured_fused.py:78-81); every other tier gives the masked operator's
result or declines: the compiled stencil (K2; its whole-domain check, and
no proxy mesh, whose masks would be another mesh's), the fused CG that
runs on it (K1), the lattice ELL (K4; probed through the masked J.v, or
declined by the direct assembly, which reads the volume kernel), and the
block stencil (K5/K6), on and off its proxy branch; the window-sharded
GridOperators of parallel/ raise. Results are held to
the masked jacobian_apply on a random vector within 1e-12 relative. K3's
other decline, hanging-node (affine) rows, is reachable: a user's
DirichletConstraints may carry affine rows on a uniform lattice, and K3
declines them there.
"""
import numpy as np
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


# ---- selective operators --------------------------------------------------
class LeftCD(ConvectionDiffusionFEM):
    """Convection-diffusion on the elements with centre x < 0.5."""

    def skip_entity(self, centers):
        return centers[..., 0] >= 0.5


def _left_dg():
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionDG

    class LeftDG(ConvectionDiffusionDG):
        def skip_entity(self, centers):
            return centers[..., 0] >= 0.5

        def skip_intersection(self, mids):
            return mids[..., 1] > 0.8
    return LeftDG(ConvectionDiffusionProblem())


def _q1_selective(n, lop_class=LeftCD):
    """Pure Dirichlet (skip_boundary), so that only the selection can make a
    tier decline."""
    V = tpt.FunctionSpace(tpt.StructuredMesh([0] * 3, [1] * 3, (n,) * 3), tpt.QkFEM(1, 3))
    return tpt.GridOperator(V, lop_class(ConvectionDiffusionProblem()),
                            constraints=tpt.constraints(True, V), skip_boundary=True)


def _dg_selective(n):
    V = tpt.FunctionSpace(tpt.StructuredMesh([0] * 3, [1] * 3, (n,) * 3), tpt.QkDGFEM(1, 3))
    return tpt.GridOperator(V, _left_dg())


def _masked_result(go, op):
    """None, or op's apply held to the masked J.v on a random vector."""
    if op is None:
        return None
    z = torch.as_tensor(np.random.default_rng(4).standard_normal(go.space.ndofs), dtype=F64)
    want = go.jacobian_apply(torch.zeros_like(z), z)
    got = op._apply_impl(z)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    return op


SELECTIVE = {
    "stencil": lambda mp: _masked_result(g := _q1_selective(8), compile_stencil(g, dtype=F64)),
    "stencil-proxy": lambda mp: (mp.setattr("dune_pdelab_tpu_torch.assembly.stencil."
                                            "PROXY_MIN_ELEMENTS", 512),
                                 _masked_result(g := _q1_selective(9),
                                                compile_stencil(g, dtype=F64)))[1],
    "fused-residual": lambda mp: make_fused_residual(_q1_selective(6)),
    "fused-japply": lambda mp: make_fused_japply(_q1_selective(6)),
    "ell": lambda mp: _masked_result(g := _q1_selective(6), assemble_ell(g, torch.zeros(
        g.space.ndofs, dtype=F64))),
    "ell-device": lambda mp: _masked_result(g := _q1_selective(6), assemble_ell_device(
        g, torch.zeros(g.space.ndofs, dtype=F64))),
    "ell-direct": lambda mp: assemble_ell_direct(_q1_selective(6)),
    "block-stencil": lambda mp: _masked_result(g := _dg_selective(6),
                                               compile_block_stencil(g, dtype=F64)),
    "block-stencil-proxy": lambda mp: (mp.setattr("dune_pdelab_tpu_torch.assembly.stencil."
                                                  "PROXY_MIN_ELEMENTS", 216),
                                       _masked_result(g := _dg_selective(7),
                                                      compile_block_stencil(g, dtype=F64)))[1],
}
# the tiers that must decline outright (the reference's K3 gate; the direct
# ELL assembly reads the unmasked volume kernel)
MUST_DECLINE = ("fused-residual", "fused-japply", "ell-direct")


@pytest.mark.parametrize("tier", list(SELECTIVE))
def test_selective_operator_tiers(tier, monkeypatch):
    got = SELECTIVE[tier](monkeypatch)
    if tier in MUST_DECLINE:
        assert got is None
        # the same operator without the selection takes the tier
        plain = _q1_selective(6, ConvectionDiffusionFEM)
        assert {"fused-residual": make_fused_residual, "fused-japply": make_fused_japply,
                "ell-direct": assemble_ell_direct}[tier](plain) is not None
    if tier in ("ell", "ell-device"):
        assert got is not None       # probing through the masked J.v is exact


def test_selective_operator_fused_cg_unreachable():
    """The fused CG (K1) runs only on a compiled stencil that qualifies; the
    selective operator's stencil is declined, so a CG solve lands on the
    general-jvp apply and report() names the declined stencil."""
    go = _q1_selective(8)
    assert compile_stencil(go, dtype=F64) is None
    ls = LinearSolverBackend(solver="cg", precond="jacobi", maxiter=3)
    x = torch.zeros(go.space.ndofs, dtype=F64)
    ls.solve(go, x, torch.ones(go.space.ndofs, dtype=F64), 1e-8)
    rep = ls.report(go)
    assert "solve path: general-jvp" in rep and "declined stencil:" in rep
    assert "fused" not in rep.split("solve path:")[1].splitlines()[0]


@pytest.mark.parametrize("cls", ["WindowShardedGridOperator", "ShardedGridOperator",
                                 "NonoverlappingShardedGridOperator"])
def test_selective_operator_sharded_raises(cls):
    """The window-sharded operators run the local operator's kernels on each
    rank's slice of the contexts, without the element and face masks: they
    refuse a selective operator (before any process group is needed)."""
    from dune_pdelab_tpu_torch import parallel

    with pytest.raises(ValueError, match="selective"):
        getattr(parallel, cls)(_q1_selective(4))


def test_fused_operator_declines_affine_rows():
    """Affine (hanging-node) rows reach K3's gate through a user's
    DirichletConstraints on a uniform 3D Q1 lattice; K3 declines them, as
    the reference does, and the general path computes r = P^T R(P x)."""
    V = tpt.FunctionSpace(tpt.StructuredMesh([0] * 3, [1] * 3, (6,) * 3), tpt.QkFEM(1, 3))
    base = tpt.constraints(True, V)
    mask = base.mask_np.copy()
    hang = 7 * 7 * 3 + 7 * 3 + 3                     # an interior vertex
    mask[hang] = True
    cons = DirichletConstraints(mask, affine_rows=[hang, hang],
                                affine_cols=[hang - 1, hang + 1],
                                affine_weights=[0.5, 0.5], device="cpu")
    assert cons.has_affine
    go = tpt.GridOperator(V, ConvectionDiffusionFEM(ConvectionDiffusionProblem()),
                          constraints=cons, skip_boundary=True)
    assert make_fused_residual(go) is None and make_fused_japply(go) is None
    plain = tpt.GridOperator(V, ConvectionDiffusionFEM(ConvectionDiffusionProblem()),
                             constraints=base, skip_boundary=True)
    assert make_fused_residual(plain) is not None
    r = go.residual(torch.ones(V.ndofs, dtype=F64))
    assert bool(torch.isfinite(r).all()) and float(r[hang]) == 0.0
