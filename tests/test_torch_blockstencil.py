"""Parity of the port's DG block stencil with the JAX package.

  * compile_block_stencil's W_taps and dD_sides against the JAX package's,
    direct branch (2D Q2, 3D Q1) and the port's proxy branch (threshold
    lowered, above the 6^3 proxy so it does not recurse) against the JAX
    direct branch on the same mesh (1e-12);
  * the plain element-major apply and the diagonal against the JAX
    BlockStencilOperator, 2D and 3D (1e-12 relative), also on an operator
    carried across with interop.block_stencil_from_numpy;
  * the plain mode-major and element-major applies (kernels/blockstencil.py)
    against the Pallas kernels they replace, try_mm_block_stencil(mode=
    "mxu2") (K5b) and try_pallas_block_stencil (K6) in interpret mode, at
    the smallest shape, fp32 (1e-5 max|y|);
  * assemble_block_ell and its apply against the JAX package's (1e-12);
  * the two layouts agree, the wrappers check their inputs, and the
    backend's block-stencil tier runs CG mode-major resident with the same
    iterations and solution as CG on the element-major apply.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.assembly import blockstencil as jbs
from dune_pdelab_tpu.assembly.blockstencil_mm import try_mm_block_stencil as j_try_mm
from dune_pdelab_tpu.assembly.blockstencil_pallas import (
    try_pallas_block_stencil as j_try_pallas,
)
from dune_pdelab_tpu.fe import QkDGFEM as JQkDG
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu.ops.convectiondiffusiondg import ConvectionDiffusionDG as JDG
from dune_pdelab_tpu_torch.assembly import blockstencil as tbs
from dune_pdelab_tpu_torch.assembly import stencil as tstencil
from dune_pdelab_tpu_torch.assembly.blockstencil_mm import (
    MMBlockStencil, try_mm_block_stencil,
)
from dune_pdelab_tpu_torch.assembly.blockstencil_pallas import try_pallas_block_stencil
from dune_pdelab_tpu_torch.interop import block_stencil_from_numpy
from dune_pdelab_tpu_torch.kernels import blockstencil as bk
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionDG as TDG
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem as TProblem
from dune_pdelab_tpu_torch.linalg import cg
from dune_pdelab_tpu_torch.solvers import LinearSolverBackend
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")

F64 = torch.float64


class JConv(JProblem):
    def A(self, x):
        return 1.5

    def b(self, x):
        return jnp.broadcast_to(jnp.asarray([1.0, -0.5, 0.25][:x.shape[-1]]), x.shape)

    def c(self, x):
        return 0.2


class TConv(TProblem):
    def A(self, x):
        return 1.5

    def b(self, x):
        v = torch.tensor([1.0, -0.5, 0.25][:x.shape[-1]], dtype=x.dtype)
        return torch.broadcast_to(v, x.shape)

    def c(self, x):
        return 0.2


def _pair(dim, k, cells):
    lo, hi = [0.0] * dim, [1.0] * dim
    jV = jpt.FunctionSpace(jpt.StructuredMesh(lo, hi, cells), JQkDG(k, dim))
    tV = tpt.FunctionSpace(tpt.StructuredMesh(lo, hi, cells), tpt.QkDGFEM(k, dim))
    return jpt.GridOperator(jV, JDG(JConv())), tpt.GridOperator(tV, TDG(TConv()))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module", params=[(2, 2, (6, 5)), (3, 1, (5, 6, 5))],
                ids=["2d_q2", "3d_q1"])
def compiled(request):
    dim, k, cells = request.param
    jgo, tgo = _pair(dim, k, cells)
    jst = jbs.compile_block_stencil(jgo)
    tst = tbs.compile_block_stencil(tgo, dtype=F64)
    return jgo, tgo, jst, tst


def test_compile_direct_matches_jax(compiled):
    _, _, jst, tst = compiled
    np.testing.assert_array_equal(tst.offsets, jst.offsets)
    assert np.abs(tst.W_taps - jst.W_taps).max() <= 1e-12
    assert np.abs(tst.dD_sides - jst.dD_sides).max() <= 1e-12


def test_plain_apply_and_diagonal_match_jax(compiled):
    _, tgo, jst, tst = compiled
    z = np.random.default_rng(21).standard_normal(tgo.space.ndofs)
    want = np.asarray(jst(jnp.asarray(z)))
    carried = block_stencil_from_numpy(jst.cells, jst.nb, jst.W_taps, jst.offsets,
                                       jst.dD_sides)
    for op in (tst, carried):
        assert _rel(op(torch.from_numpy(z)).numpy(), want) <= 1e-12
    assert _rel(tst.diagonal(F64).numpy(), np.asarray(jst.diagonal(jnp.float64))) <= 1e-12
    # the operator is the Jacobian: plain apply against jacobian_apply
    zt = torch.from_numpy(z)
    assert _rel(tst(zt).numpy(), tgo.jacobian_apply(torch.zeros_like(zt), zt).numpy()) <= 1e-12


def test_compile_proxy_branch_matches_jax_direct(monkeypatch):
    monkeypatch.setattr(tstencil, "PROXY_MIN_ELEMENTS", 300)   # 8^3 > 300 >= 6^3
    jgo, tgo = _pair(3, 1, (8, 8, 8))
    jst = jbs.compile_block_stencil(jgo)
    tst = tbs.compile_block_stencil(tgo, dtype=F64)
    assert tst.cells == (8, 8, 8)
    assert np.abs(tst.W_taps - jst.W_taps).max() <= 1e-12
    assert np.abs(tst.dD_sides - jst.dD_sides).max() <= 1e-12


@pytest.fixture(scope="module")
def smallest():
    jgo, tgo = _pair(3, 1, (5, 5, 5))
    jst = jbs.compile_block_stencil(jgo)
    tst = block_stencil_from_numpy(jst.cells, jst.nb, jst.W_taps, jst.offsets,
                                   jst.dD_sides, dtype=torch.float32)
    z = np.random.default_rng(22).standard_normal(tgo.space.ndofs).astype(np.float32)
    return jst, tst, z


def test_mode_major_plain_matches_pallas_mxu2(smallest):
    jst, tst, z = smallest
    apply_flat = j_try_mm(jst, interpret=True, mode="mxu2")[0]
    want = np.asarray(apply_flat(jnp.asarray(z)))
    mm = try_mm_block_stencil(tst)
    zt = torch.from_numpy(z)
    got = mm.from_mm(bk.block_stencil_mm_reference(
        mm.to_mm(zt), *tst.taps(torch.float32, "cpu"), tst.cells))
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert torch.equal(mm(zt), got)


def test_element_major_plain_matches_pallas_k6(smallest):
    jst, tst, z = smallest
    want = np.asarray(j_try_pallas(jst, interpret=True)(jnp.asarray(z)))
    zt = torch.from_numpy(z)
    got = bk.block_stencil_em_reference(zt, *tst.taps(torch.float32, "cpu"), tst.cells)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert torch.equal(try_pallas_block_stencil(tst)(zt), got)


def test_assemble_block_ell_matches_jax():
    jgo, tgo = _pair(2, 1, (5, 4))
    jell = jbs.assemble_block_ell(jgo)
    tell = tbs.assemble_block_ell(tgo, torch.zeros(tgo.space.ndofs, dtype=F64))
    assert np.abs(tell.values.numpy() - np.asarray(jell.values)).max() <= 1e-12
    z = np.random.default_rng(23).standard_normal(tgo.space.ndofs)
    assert _rel(tell(torch.from_numpy(z)).numpy(), np.asarray(jell(jnp.asarray(z)))) <= 1e-12
    assert tell.pattern_stats()["nnz_stored"] == jell.pattern_stats()["nnz_stored"]


@pytest.mark.parametrize("cells,nb", [((4, 3, 5), 8), ((3, 4, 2), 27), ((5, 3, 4), 5)])
def test_layouts_agree(cells, nb):
    """Mode-major and element-major plain versions of one random stencil
    (random W and dD, any nb) give the same values."""
    rng = np.random.default_rng(nb)
    W = torch.from_numpy(rng.standard_normal((7, nb, nb)))
    dD = torch.from_numpy(rng.standard_normal((3, 2, nb, nb)))
    z = torch.from_numpy(rng.standard_normal(int(np.prod(cells)) * nb))
    op = MMBlockStencil(tbs.BlockStencilOperator(cells, nb, np.zeros((7, nb, nb)),
                                                 tbs.face_offsets(3), np.zeros((3, 2, nb, nb))))
    em = bk.block_stencil_em(z, W, dD, cells)
    mm = op.from_mm(bk.block_stencil_mm(op.to_mm(z), W, dD, cells))
    assert _rel(mm.numpy(), em.numpy()) <= 1e-14


def test_2d_ignores_z_taps_and_wrappers_check_inputs():
    rng = np.random.default_rng(24)
    nb, cells = 4, (5, 3)
    W = torch.from_numpy(rng.standard_normal((7, nb, nb)))
    dD = torch.from_numpy(rng.standard_normal((3, 2, nb, nb)))
    z = torch.from_numpy(rng.standard_normal(15 * nb))
    W0, dD0 = W.clone(), dD.clone()
    W0[5:], dD0[2] = 0.0, 0.0
    assert torch.equal(bk.block_stencil_em(z, W, dD, cells),
                       bk.block_stencil_em(z, W0, dD0, cells))
    with pytest.raises(ValueError, match="shape"):
        bk.block_stencil_em(z[:-1], W, dD, cells)
    with pytest.raises(TypeError, match="dtype"):
        bk.block_stencil_em(z.float(), W, dD, cells)
    with pytest.raises(ValueError, match="3D"):
        bk.block_stencil_mm(z, W, dD, cells)
    with pytest.raises(ValueError, match="face tap"):
        bk.tap_tensors(np.zeros((1, nb, nb)), [[1, 1]], np.zeros((2, 2, nb, nb)),
                       F64, "cpu")


@pytest.mark.parametrize("precond", ["jacobi", "richardson"])
def test_backend_runs_block_stencil_mode_major_resident(precond):
    _, tgo = _pair(3, 1, (5, 6, 5))
    b = tgo.residual(torch.from_numpy(
        np.random.default_rng(25).standard_normal(tgo.space.ndofs)))
    x0 = torch.zeros_like(b)
    ls = LinearSolverBackend(precond=precond)
    z, s = ls.solve(tgo, x0, b, 1e-10)
    assert ("compiled block stencil MMBlockStencil [mode-major resident; blockstencil "
            "plain torch (CPU tensor)]") in ls.report(tgo)
    # the same CG on the element-major plain apply
    st = ls._stencil_for(tgo, x0, 0.0).source
    diag = st.diagonal(F64) if precond == "jacobi" else torch.ones_like(b)
    z_ref, s_ref = cg(st, b, M=lambda r: r / diag, tol=1e-10)
    assert bool(s.converged) and s.iterations == s_ref.iterations
    assert _rel(z.numpy(), z_ref.numpy()) <= 1e-9


def _random_taps(nb, dim, seed):
    """Random W_taps (in a shuffled tap order), their offsets and dD_sides."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(2 * dim + 1)
    return (rng.standard_normal((2 * dim + 1, nb, nb)), tbs.face_offsets(dim)[perm],
            rng.standard_normal((dim, 2, nb, nb)))


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("nb", [4, 8, 9, 27, 16])
def test_packed_weights_round_trip(nb, dtype):
    """pack_taps lays out tap_tensors' (W, dD) as 13 row-major blocks: the
    taps in TAP_ORDER, then the sides x-, x+, y-, y+, z-, z+ (2D: zeros for
    the z ones)."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    for dim in (2, 3):
        W_taps, offsets, dD_sides = _random_taps(nb, dim, nb + dim)
        packed = bk.pack_taps(*bk.tap_arrays(W_taps, offsets, dD_sides), dtype)
        assert packed.dtype == npdt and packed.shape == (13 * nb * nb,)
        assert packed.flags["C_CONTIGUOUS"]
        blocks = packed.reshape(13, nb, nb)
        W, dD = bk.tap_tensors(W_taps, offsets, dD_sides, dtype, "cpu")
        assert np.array_equal(blocks[:7], W.numpy())
        assert np.array_equal(blocks[7:], dD.numpy().reshape(6, nb, nb))
        for t, off in enumerate(bk.TAP_ORDER):
            hit = [i for i, o in enumerate(offsets)
                   if tuple(o) + (0,) * (3 - dim) == off]
            want = W_taps[hit[0]].astype(npdt) if hit else np.zeros((nb, nb), npdt)
            assert np.array_equal(blocks[t], want)
        for side in range(6):
            want = (dD_sides[side // 2, side % 2].astype(npdt) if side < 2 * dim
                    else np.zeros((nb, nb), npdt))
            assert np.array_equal(blocks[7 + side], want)


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("nb,path", [(4, "param"), (8, "param"), (9, "param"),
                                     (27, "shared"), (16, "shared"), (5, "shared")])
def test_path_rule(nb, path, dtype):
    """block_path: the parameter path for nb in PARAM_NB (Q1/Q2 in 2D, Q1 in
    3D), the shared-memory path for any other nb."""
    assert bk.PARAM_NB == (4, 8, 9)
    assert bk.block_path(dtype, nb) == path


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("nb", [5, 16, 27, 64, 125, 343, 1000])
def test_shared_plan_stages_any_nb(nb, dtype):
    """shared_plan: 28 outputs per pass for nb = 27, else 8, each weight row
    whole 16-byte vectors; all 13*nb rows in one stage where they fit in a
    block's shared memory (Q3 in 3D, nb = 64: 53,248 B in fp64), else as
    many rows as fit, so no nb is refused."""
    es = torch.empty((), dtype=dtype).element_size()
    ch, rows = bk.shared_plan(dtype, nb)
    assert ch == (28 if nb == 27 else 8) and (ch * es) % 16 == 0
    assert 1 <= rows <= 13 * nb and ch * rows * es <= bk.SMEM_BYTES
    assert (rows == 13 * nb) == (13 * nb * ch * es <= bk.SMEM_BYTES)
    if rows < 13 * nb:
        assert (rows + 1) * ch * es > bk.SMEM_BYTES


def test_packed_weights_built_once_per_operator_and_dtype(monkeypatch):
    nb, dim = 9, 2
    W_taps, offsets, dD_sides = _random_taps(nb, dim, 5)
    st = tbs.BlockStencilOperator((6, 5), nb, W_taps, offsets, dD_sides)
    calls = []
    real = bk.pack_taps
    monkeypatch.setattr(bk, "pack_taps", lambda W, dD, dt: calls.append(dt) or real(W, dD, dt))
    z = torch.from_numpy(np.random.default_rng(6).standard_normal(st.ndofs))
    for _ in range(3):
        st(z)
        st(z.float())
    assert calls == [F64, torch.float32]
    # the host weights kept with the operator's tensors are found without a
    # copy; tensors that tap_tensors did not make, or an in-place change of
    # W or dD since, are refused rather than packed from the card
    W, dD = st.taps(F64, "cpu")
    packed = bk._packed_for(W, dD)
    assert calls == [F64, torch.float32]
    assert np.array_equal(packed, real(*bk.tap_arrays(W_taps, offsets, dD_sides), F64))
    with pytest.raises(ValueError, match="tap_tensors"):
        bk._packed_for(W.clone(), dD)
    with pytest.raises(ValueError, match="tap_tensors"):
        bk._packed_for(W, dD.clone())
    W2, dD2 = bk.tap_tensors(W_taps, offsets, dD_sides, F64, "cpu")
    assert np.array_equal(bk._packed_for(W2, dD2), packed)
    dD2[0, 0, 0, 0] += 1.0
    with pytest.raises(ValueError, match="tap_tensors"):
        bk._packed_for(W2, dD2)


def _kernel_order(zg, packed, nb, dim):
    """CPU emulation of csrc/blockstencil.cu's order of sums on a grid view
    zg (cell axes reversed, modes last): per output a, the taps 0, -x, +x,
    -y, +y(, -z, +z), then the dD sides x-, x+, y-, y+(, z-, z+) on the face
    elements, the mode b innermost; neighbours off the grid read as 0."""
    w = torch.from_numpy(packed.reshape(13, nb, nb))
    pad = torch.nn.functional.pad(zg, (0, 0) + (1, 1) * dim)

    def shifted(d, s):
        ax = dim - 1 - d
        sl = [slice(1, -1)] * dim
        sl[ax] = slice(1 + s, 1 + s + zg.shape[ax])
        return pad[tuple(sl)]
    acc = torch.zeros_like(zg)
    for t, v in enumerate([zg] + [shifted(d, s) for d in range(dim) for s in (-1, 1)]):
        for b in range(nb):
            acc = acc + w[t, :, b] * v[..., b:b + 1]
    for side in range(2 * dim):
        face = [slice(None)] * (dim + 1)
        face[dim - 1 - side // 2] = slice(-1, None) if side % 2 else slice(0, 1)
        face = tuple(face)
        for b in range(nb):
            acc[face] = acc[face] + w[7 + side, :, b] * zg[face][..., b:b + 1]
    return acc


@pytest.mark.parametrize("cells,nb", [((7, 5), 9), ((6, 4), 4), ((5, 4), 16),
                                      ((4, 5, 3), 8), ((3, 4, 2), 27)])
def test_kernel_order_of_sums_matches_plain(cells, nb):
    """The kernel's order of sums (emulated in fp64 on the packed weights)
    equals the plain element-major and mode-major versions to 1e-13 max|y|."""
    dim = len(cells)
    W_taps, offsets, dD_sides = _random_taps(nb, dim, nb)
    W, dD = bk.tap_tensors(W_taps, offsets, dD_sides, F64, "cpu")
    packed = bk.pack_taps(*bk.tap_arrays(W_taps, offsets, dD_sides), F64)
    grid = tuple(reversed(cells)) + (nb,)
    z = torch.from_numpy(np.random.default_rng(nb + 1).standard_normal(int(np.prod(grid))))
    got = _kernel_order(z.reshape(grid), packed, nb, dim).reshape(-1)
    want = bk.block_stencil_em_reference(z, W, dD, cells)
    assert (got - want).abs().max() <= 1e-13 * want.abs().max()
    if dim == 3:
        op = MMBlockStencil(tbs.BlockStencilOperator(cells, nb, W_taps, offsets, dD_sides))
        mm = op.from_mm(bk.block_stencil_mm_reference(op.to_mm(z), W, dD, cells))
        assert (got - mm).abs().max() <= 1e-13 * mm.abs().max()


def _shared_order(zg, W, dD, nb, dim, ch, rows):
    """CPU emulation of csrc/blockstencil.cu bs_shared on a grid view zg
    (cell axes reversed, modes last): per pass of ch outputs a0.., the weight
    rows r = t*nb + b staged `rows` at a time as ws[(r - r0)*ch + c] =
    block t (a0 + c, b) (zero past nb), then each staged row's FMA in the
    order t, b; z taps skipped in 2D, sides on their face elements only."""
    blocks = torch.cat([W, dD.reshape(6, nb, nb)])
    pad = torch.nn.functional.pad(zg, (0, 0) + (1, 1) * dim)

    def shifted(d, s):
        ax = dim - 1 - d
        sl = [slice(1, -1)] * dim
        sl[ax] = slice(1 + s, 1 + s + zg.shape[ax])
        return pad[tuple(sl)]
    neigh = [zg] + [shifted(d, s) for d in range(dim) for s in (-1, 1)]
    out = torch.empty_like(zg)
    nrow = 13 * nb
    for a0 in range(0, nb, ch):
        acc = torch.zeros(zg.shape[:-1] + (ch,), dtype=zg.dtype)
        for r0 in range(0, nrow, rows):
            r1 = min(r0 + rows, nrow)
            i = torch.arange((r1 - r0) * ch)
            c, r = i % ch, r0 + i // ch
            a = a0 + c
            ws = torch.where(a < nb, blocks[r // nb, a.clamp(max=nb - 1), r % nb], 0.0)
            t = r0 // nb
            while t * nb < r1:
                side = t - 7
                if t < 7 and t >= 2 * dim + 1 or side >= 2 * dim:
                    t += 1
                    continue
                face = [slice(None)] * (dim + 1)
                if side >= 0:
                    face[dim - 1 - side // 2] = slice(-1, None) if side % 2 else slice(0, 1)
                face = tuple(face)
                v = (neigh[t] if t < 7 else zg)[face]
                for b in range(max(0, r0 - t * nb), min(nb, r1 - t * nb)):
                    wr = ws[(t * nb + b - r0) * ch:(t * nb + b - r0 + 1) * ch]
                    acc[face] = acc[face] + wr * v[..., b:b + 1]
                t += 1
            del ws
        out[..., a0:a0 + ch] = acc[..., :min(ch, nb - a0)]
    return out


@pytest.mark.parametrize("cells,nb,stage_rows", [((3, 2, 2), 64, None), ((3, 2, 2), 64, 100),
                                                 ((5, 4), 16, 37), ((3, 4, 2), 27, 50),
                                                 ((4, 3), 5, 7)])
def test_shared_path_staging_matches_plain(cells, nb, stage_rows):
    """The shared path's chunked weight staging (emulated in fp64) equals the
    plain versions to 1e-13 max|y|, in one stage as shared_plan gives (Q3 in
    3D: nb = 64) and in stages cut mid-tap, and the stages leave every sum
    bit for bit as it was."""
    dim = len(cells)
    W_taps, offsets, dD_sides = _random_taps(nb, dim, nb + 3)
    W, dD = bk.tap_tensors(W_taps, offsets, dD_sides, F64, "cpu")
    grid = tuple(reversed(cells)) + (nb,)
    z = torch.from_numpy(np.random.default_rng(nb + 4).standard_normal(int(np.prod(grid))))
    ch, rows = bk.shared_plan(F64, nb)
    assert rows == 13 * nb
    one = _shared_order(z.reshape(grid), W, dD, nb, dim, ch, rows).reshape(-1)
    want = bk.block_stencil_em_reference(z, W, dD, cells)
    assert (one - want).abs().max() <= 1e-13 * want.abs().max()
    if stage_rows is not None:
        assert (13 * nb) % stage_rows
        cut = _shared_order(z.reshape(grid), W, dD, nb, dim, ch, stage_rows).reshape(-1)
        assert torch.equal(cut, one)
    if dim == 3:
        op = MMBlockStencil(tbs.BlockStencilOperator(cells, nb, W_taps, offsets, dD_sides))
        mm = op.from_mm(bk.block_stencil_mm_reference(op.to_mm(z), W, dD, cells))
        assert (one - mm).abs().max() <= 1e-13 * mm.abs().max()
