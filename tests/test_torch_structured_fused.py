"""Parity of the port's fused structured Q1 operator (the structured_fused
kernel's plain version) and VarCoeffGMG with the JAX package.

  * fp64: make_fused_residual / make_fused_japply of the port against the
    JAX batched go.residual / go.jacobian_apply, to 1e-12 relative;
  * fp32: against the JAX Pallas kernel (K3) run in interpret mode, as
    tests/test_structured_fused.py runs it, to 1e-5 * max|y| (the sums run
    in another order);
  * out-of-scope operators give None;
  * VarCoeffGMG at 16^3: the same Chebyshev bound per level to fp32
    roundoff and the same iteration count within one;
  * the kernel's 1D tables (`tensor_rule`) rebuild the tabulation to 1e-13
    on a mesh with three different spacings, and a non-product tabulation
    raises;
  * a plain-torch emulation of the kernel's sum-factorised evaluation (x,
    y, z contractions and their transposes on those tables) matches the
    plain version and the JAX batched residual / Jacobian-apply in fp64.
Problems copied from tests/test_structured_fused.py.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.assembly.structured_fused import (
    make_fused_japply as j_japply, make_fused_residual as j_residual)
from dune_pdelab_tpu.linalg.gmg_varcoeff import VarCoeffGMG as JVarCoeffGMG
from dune_pdelab_tpu.ops import ConvectionDiffusionFEM as JFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu_torch.assembly.structured_fused import (
    make_fused_japply, make_fused_residual)
from dune_pdelab_tpu_torch.kernels import structured_fused as sfk
from dune_pdelab_tpu_torch.linalg.gmg_varcoeff import VarCoeffGMG
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM as TFEM
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem as TProblem
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")


class JVarCoeff(JProblem):
    """Scalar-field diffusion + reaction (the bench.py assembled problem)."""

    def A(self, x):
        a = 1.0 + 0.5 * jnp.sin(3 * x[..., 0]) * x[..., 1]
        return a[..., None, None] * jnp.eye(x.shape[-1], dtype=x.dtype)

    def c(self, x):
        return 0.7 + x[..., 0]

    def f(self, x):
        return jnp.ones(x.shape[:-1], x.dtype)


class TVarCoeff(TProblem):
    def A(self, x):
        a = 1.0 + 0.5 * torch.sin(3 * x[..., 0]) * x[..., 1]
        return a[..., None, None] * torch.eye(x.shape[-1], dtype=x.dtype)

    def c(self, x):
        return 0.7 + x[..., 0]

    def f(self, x):
        return torch.ones(x.shape[:-1], dtype=x.dtype)


class JTensorConv(JProblem):
    """Full anisotropic tensor + convection + source (all kernel branches)."""

    def A(self, x):
        d = x.shape[-1]
        base = jnp.eye(d, dtype=x.dtype) + 0.3 * jnp.ones((d, d), x.dtype)
        a = 1.0 + x[..., 1] * x[..., 2]
        return a[..., None, None] * base

    def b(self, x):
        return jnp.stack([x[..., 1], -x[..., 0],
                          0.5 * jnp.ones_like(x[..., 0])], axis=-1)

    def c(self, x):
        return 0.2 + x[..., 2]

    def f(self, x):
        return jnp.cos(2 * x[..., 0]) * x[..., 1]


class TTensorConv(TProblem):
    def A(self, x):
        d = x.shape[-1]
        base = torch.eye(d, dtype=x.dtype) + 0.3 * torch.ones((d, d), dtype=x.dtype)
        a = 1.0 + x[..., 1] * x[..., 2]
        return a[..., None, None] * base

    def b(self, x):
        return torch.stack([x[..., 1], -x[..., 0],
                            0.5 * torch.ones_like(x[..., 0])], dim=-1)

    def c(self, x):
        return 0.2 + x[..., 2]

    def f(self, x):
        return torch.cos(2 * x[..., 0]) * x[..., 1]


class JFieldA(JProblem):
    """The varsolve problem (bench.py:582-590): a scalar-field A."""

    def A(self, x):
        s = jnp.sin(np.pi * x[..., 0]) * jnp.sin(np.pi * x[..., 1]) * jnp.sin(np.pi * x[..., 2])
        return 1.0 + 0.5 * s

    def f(self, x):
        return jnp.ones(x.shape[:-1], x.dtype)


class TFieldA(TProblem):
    def A(self, x):
        s = torch.sin(np.pi * x[..., 0]) * torch.sin(np.pi * x[..., 1]) * torch.sin(np.pi * x[..., 2])
        return 1.0 + 0.5 * s

    def f(self, x):
        return torch.ones(x.shape[:-1], dtype=x.dtype)


PROBLEMS = {"scalar_field": (JVarCoeff, TVarCoeff),
            "tensor_convection": (JTensorConv, TTensorConv),
            "field_A": (JFieldA, TFieldA)}


def _go(pkg, Problem, FEM, cells=(9, 9, 9), k=1):
    mesh = pkg.StructuredMesh([0] * len(cells), [1] * len(cells), cells)
    V = pkg.FunctionSpace(mesh, pkg.QkFEM(k, len(cells)))
    return pkg.GridOperator(V, FEM(Problem()), constraints=pkg.constraints(True, V),
                            skip_boundary=True)


def _x(n, seed=7):
    return np.random.default_rng(seed).standard_normal(n)


def _rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_fused_fp64_matches_jax_batched(name):
    JP, TP = PROBLEMS[name]
    jgo, tgo = _go(jpt, JP, JFEM), _go(tpt, TP, TFEM)
    x = _x(jgo.space.ndofs)
    r_j = jgo.residual(jnp.asarray(x))
    r_t = make_fused_residual(tgo)(torch.as_tensor(x))
    assert _rel_max(r_t, r_j) <= 1e-12
    y_j = jgo.jacobian_apply(jnp.zeros(len(x)), jnp.asarray(x))
    y_t = make_fused_japply(tgo)(torch.as_tensor(x))
    assert _rel_max(y_t, y_j) <= 1e-12
    # constrained rows: 0 in the residual, z passed through by the apply
    m = jgo.cg.mask_np
    assert np.all(r_t.numpy()[m] == 0.0) and np.all(y_t.numpy()[m] == x[m])


@pytest.mark.parametrize("name", ["scalar_field", "tensor_convection"])
def test_fused_fp32_matches_jax_pallas_interpret(name):
    JP, TP = PROBLEMS[name]
    jgo, tgo = _go(jpt, JP, JFEM, (9, 8, 7)), _go(tpt, TP, TFEM, (9, 8, 7))
    x = _x(jgo.space.ndofs, seed=11).astype(np.float32)
    for j_make, t_make in ((j_residual, make_fused_residual),
                           (j_japply, make_fused_japply)):
        y_j = j_make(jgo, tz=4, cy=8)(jnp.asarray(x))
        y_t = t_make(tgo)(torch.as_tensor(x))
        assert y_t.dtype == torch.float32
        assert _rel_max(y_t, y_j) <= 1e-5


def test_plain_version_slabs_agree(monkeypatch):
    """The z-slab split of the plain version changes nothing: slabs of one
    element plane against the whole grid at once."""
    tgo = _go(tpt, TTensorConv, TFEM, (5, 4, 6))
    op = make_fused_residual(tgo)
    x = torch.as_tensor(_x(tgo.space.ndofs, seed=3))
    tab, coef = op.state(x.dtype, x.device)
    mask = tgo.cg.mask
    whole = sfk.structured_fused_reference(x, mask, tab, coef, op.dims, False)
    monkeypatch.setattr(sfk, "PLAIN_SLAB_ELEMENTS", 1)
    sliced = sfk.structured_fused_reference(x, mask, tab, coef, op.dims, False)
    assert float((whole - sliced).abs().max()) <= 1e-14 * float(whole.abs().max())


def test_fused_declines_out_of_scope():
    # 2D -> None
    go2 = _go(tpt, TVarCoeff, TFEM, (8, 8))
    assert make_fused_residual(go2) is None and make_fused_japply(go2) is None
    # Q2 -> None
    goq2 = _go(tpt, TVarCoeff, TFEM, (6, 6, 6), k=2)
    assert make_fused_residual(goq2) is None
    # a ConvectionDiffusionFEM subclass overriding the volume terms -> None

    class Custom(TFEM):
        def alpha_volume(self, ctx, u):
            return 2.0 * super().alpha_volume(ctx, u)

    assert make_fused_japply(_go(tpt, TVarCoeff, Custom, (6, 6, 6))) is None
    # a residual without a source term needs lambda_volume
    go = _go(tpt, TVarCoeff, TFEM, (6, 6, 6))
    go.has["lambda_volume"] = False
    assert make_fused_residual(go) is None
    assert make_fused_japply(go) is not None
    # active boundary kernels (the GridOperator's boundary face groups)
    # -> None: the kernel has no face terms
    mesh = tpt.StructuredMesh([0, 0, 0], [1, 1, 1], (6, 6, 6))
    V = tpt.FunctionSpace(mesh, tpt.QkFEM(1, 3))
    go = tpt.GridOperator(V, TFEM(TVarCoeff()), constraints=tpt.constraints(True, V))
    assert go.has["alpha_boundary"] and len(go.bnd_groups) == 6
    assert make_fused_residual(go) is None and make_fused_japply(go) is None


def test_varcoeff_gmg_matches_jax():
    """VarCoeffGMG at 16^3: per-level Chebyshev bounds to fp32 roundoff,
    iterations within one, the same fp32 floor of the true defect."""
    res = {}
    for pkg, P, FEM, G in ((jpt, JVarCoeff, JFEM, JVarCoeffGMG),
                           (tpt, TVarCoeff, TFEM, VarCoeffGMG)):
        go = _go(pkg, P, FEM, (16, 16, 16))
        gmg = G(go)
        if pkg is tpt:
            b = -go.residual(go.space.zero(torch.float32))
        else:
            b = -go.residual(jnp.zeros(go.space.ndofs, jnp.float32))
        x, info = gmg.solve_host(b, tol=1e-8, maxiter=40)
        res[pkg.__name__] = (gmg.lmax, info, np.asarray(x, np.float64))
    (lj, ij, xj), (lt, it, xt) = res["dune_pdelab_tpu"], res["dune_pdelab_tpu_torch"]
    assert len(lj) == len(lt) == 3
    assert np.allclose(lt, lj, rtol=1e-5, atol=0)
    assert it["converged"] and abs(it["iterations"] - ij["iterations"]) <= 1
    assert it["true_defect"] / it["defect0"] < 1e-4
    assert np.abs(xt - xj).max() <= 1e-4 * np.abs(xj).max()


def test_structured_fused_wrapper_checks_inputs():
    tgo = _go(tpt, TFieldA, TFEM, (4, 3, 5))
    op = make_fused_japply(tgo)
    x = torch.as_tensor(_x(tgo.space.ndofs))
    tab, coef = op.state(x.dtype, x.device)
    assert coef.a_kind == 1 and coef.b is None and coef.c is None and coef.f is None
    dims = op.dims
    with pytest.raises(ValueError, match="shape"):
        sfk.structured_fused(x[:-1], None, tab, coef, dims, True)
    with pytest.raises(TypeError, match="dtype"):
        sfk.structured_fused(x.float(), None, tab, coef, dims, True)
    with pytest.raises(ValueError, match="shape"):
        sfk.structured_fused(x, None, tab[:, :-1], coef, dims, True)
    with pytest.raises(ValueError, match="a_kind"):
        sfk.structured_fused(x, None, tab, coef._replace(a_kind=2), dims, True)
    with pytest.raises(ValueError, match="needs an A array"):
        sfk.structured_fused(x, None, tab, coef._replace(a_kind=3, A=None), dims, True)
    with pytest.raises(ValueError, match="shape"):
        sfk.structured_fused(x, None, tab, coef._replace(A=coef.A[:, :, 1:]), dims, True)
    with pytest.raises(ValueError, match="mask"):
        sfk.structured_fused(x, torch.zeros(3, dtype=torch.bool), tab, coef, dims, True)


def _aniso_state(quad_order, cells=(5, 4, 6)):
    """(go, tab) of the tensor-convection problem on [0,1]x[0,2]x[0,0.5]
    (hx != hy != hz), fp64."""
    mesh = tpt.StructuredMesh([0, 0, 0], [1, 2, 0.5], cells)
    V = tpt.FunctionSpace(mesh, tpt.QkFEM(1, 3))
    go = tpt.GridOperator(V, TFEM(TTensorConv()), constraints=tpt.constraints(True, V),
                          skip_boundary=True, quad_order=quad_order)
    tab, _ = make_fused_residual(go).state(torch.float64, torch.device("cpu"))
    return go, tab


@pytest.mark.parametrize("quad_order", [None, 4])
def test_tensor_rule_rebuilds_tab(quad_order):
    go, tab = _aniso_state(quad_order)
    rule = sfk.tensor_rule(tab)
    assert rule.q == (2 if quad_order is None else 3) and rule.q**3 == tab.shape[0]
    t = tab.numpy()
    back = sfk._rebuild(rule)
    for cols in (slice(0, 8), slice(8, 32), slice(32, 33)):
        assert np.abs(back[:, cols] - t[:, cols]).max() <= 1e-13 * np.abs(t[:, cols]).max()
    # derivative tables: -+1/h per axis (h = 0.2, 0.5, 1/12)
    for d, h in enumerate(go.mesh.h):
        np.testing.assert_allclose(rule.dphi[d], np.tile([-1 / h, 1 / h], (rule.q, 1)),
                                   rtol=1e-13)
    # the packed kernel block: phi, 1/h per axis, weights, zero-padded to QMAX
    packed = sfk._packed(rule)
    assert packed.shape == (3 * sfk.QMAX * 2 + 3 + sfk.QMAX**3,)
    np.testing.assert_allclose(packed[3 * sfk.QMAX * 2:][:3], 1 / np.asarray(go.mesh.h),
                               rtol=1e-13)
    np.testing.assert_array_equal(packed[-sfk.QMAX**3:][:rule.q**3], rule.w.reshape(-1))


def test_tensor_rule_raises_on_non_product_tab():
    _, tab = _aniso_state(None)
    bad = tab.clone()
    bad[3, 5] *= 1.0 + 1e-9                      # one basis value off the product
    with pytest.raises(ValueError, match="tensor product"):
        sfk.tensor_rule(bad)
    bad = tab.clone()
    bad[2, 32] *= 1.01                           # weights not rank one
    with pytest.raises(ValueError, match="tensor product"):
        sfk.tensor_rule(bad)
    with pytest.raises(ValueError, match="tensor rule"):
        sfk.tensor_rule(tab[:7])                 # 7 points: no q^3
    # the wrapper raises too (on the CPU as on the card)
    go = _go(tpt, TFieldA, TFEM, (4, 3, 5))
    op = make_fused_japply(go)
    x = torch.as_tensor(_x(go.space.ndofs))
    t, coef = op.state(x.dtype, x.device)
    bad = t.clone()
    bad[0, 0] += 1e-6
    with pytest.raises(ValueError, match="tensor product"):
        sfk.structured_fused(x, None, bad, coef, op.dims, True)


def _sum_factorised(x, mask, rule, coef, dims, japply):
    """Plain-torch emulation of the kernel's evaluation: per element, u and
    grad u by 1D contractions (x, then y, then z) on the tensor rule's
    tables, the fluxes at each point, and the test-function sweep by the
    transposed contractions (z, then y, then x); scatter to the corners."""
    nx, ny, nz = dims
    q = rule.q
    P, dP = torch.as_tensor(rule.phi), torch.as_tensor(rule.dphi)   # (3, q, 2)
    u = x if (mask is None or not japply) else torch.where(mask, 0.0, x)
    g = u.reshape(nz, ny, nx)
    C = torch.stack([torch.stack([torch.stack([g[dz:dz + nz - 1, dy:dy + ny - 1,
                                                 dx:dx + nx - 1] for dx in (0, 1)])
                                  for dy in (0, 1)]) for dz in (0, 1)])   # [dz, dy, dx]
    ein = torch.einsum
    Lx, Dx = ein("ic,zyc...->zyi...", P[0], C), ein("ic,zyc...->zyi...", dP[0], C)
    U = ein("jb,zbi...->zji...", P[1], Lx)
    G0 = ein("jb,zbi...->zji...", P[1], Dx)
    G1 = ein("jb,zbi...->zji...", dP[1], Lx)
    pts = [ein("kz,zji...->kji...", T, V) for T, V in ((P[2], U), (P[2], G0),
                                                       (P[2], G1), (dP[2], U))]
    uq, g0, g1, g2 = (t.reshape(q**3, *t.shape[3:]) for t in pts)   # row ix + q (iy + q iz)
    if coef.a_kind == 0:
        f = [coef.a_const * gd for gd in (g0, g1, g2)]
    elif coef.a_kind == 1:
        f = [coef.A[:, 0] * gd for gd in (g0, g1, g2)]
    else:
        f = [coef.A[:, 3 * i] * g0 + coef.A[:, 3 * i + 1] * g1 + coef.A[:, 3 * i + 2] * g2
             for i in range(3)]
    if coef.b is not None:
        f = [f[d] - uq * coef.b[:, d] for d in range(3)]
    s = torch.zeros_like(uq)
    if coef.c is not None:
        s = coef.c[:, 0] * uq
    if coef.f is not None:
        s = s - coef.f[:, 0]
    w = torch.as_tensor(rule.w.reshape(-1))[:, None, None, None]
    F0, F1, F2, S = (t.mul(w).reshape(q, q, q, *t.shape[1:]) for t in (*f, s))
    Pz = ein("kz,kji...->zji...", dP[2], F2) + ein("kz,kji...->zji...", P[2], S)
    Q1, Q0 = ein("kz,kji...->zji...", P[2], F1), ein("kz,kji...->zji...", P[2], F0)
    Rv = ein("jb,zji...->zbi...", P[1], Pz) + ein("jb,zji...->zbi...", dP[1], Q1)
    Sv = ein("jb,zji...->zbi...", P[1], Q0)
    out = ein("ic,zbi...->zbc...", P[0], Rv) + ein("ic,zbi...->zbc...", dP[0], Sv)
    r = torch.zeros_like(g)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                r[dz:dz + nz - 1, dy:dy + ny - 1, dx:dx + nx - 1] += out[dz, dy, dx]
    y = r.reshape(-1)
    return y if mask is None else torch.where(mask, x if japply else 0.0, y)


@pytest.mark.parametrize("name", ["field_A", "tensor_convection"])
@pytest.mark.parametrize("japply", [False, True])
def test_sum_factorised_emulation_matches(name, japply):
    JP, TP = PROBLEMS[name]
    jgo, tgo = _go(jpt, JP, JFEM, (9, 8, 7)), _go(tpt, TP, TFEM, (9, 8, 7))
    op = (make_fused_japply if japply else make_fused_residual)(tgo)
    x = torch.as_tensor(_x(tgo.space.ndofs, seed=21))
    tab, coef = op.state(x.dtype, x.device)
    mask = tgo.cg.mask
    got = _sum_factorised(x, mask, sfk.tensor_rule(tab), coef, op.dims, japply)
    plain = sfk.structured_fused_reference(x, mask, tab, coef, op.dims, japply)
    assert _rel_max(got, plain) <= 1e-12
    if japply:
        want = jgo.jacobian_apply(jnp.zeros(len(x)), jnp.asarray(x.numpy()))
    else:
        want = jgo.residual(jnp.asarray(x.numpy()))
    assert _rel_max(got, want) <= 1e-12


def test_probe_gershgorin_resolves_default_device():
    """device=None is default_device() (the CPU in these tests), and gives
    what an explicit device gives."""
    from dune_pdelab_tpu_torch.linalg.gmg_varcoeff import _probe_gershgorin
    tgo = _go(tpt, TFieldA, TFEM, (4, 4, 4))
    op = make_fused_japply(tgo)
    d0, l0 = _probe_gershgorin(op, op.dims)
    d1, l1 = _probe_gershgorin(op, op.dims, device="cpu")
    assert d0.device.type == "cpu" and torch.equal(d0, d1) and l0 == l1
    assert d0.dtype == torch.float32 and l0 >= 1.0


def test_rules_above_qmax_take_the_general_path():
    """A rule of more than QMAX Gauss points per axis (quad_order 8: 5) does
    not qualify for the kernel; VarCoeffGMG then runs its levels through the
    batched jvp apply and still solves. quad_order 7 (4 points) qualifies."""
    def go_of(quad_order, cells=(8, 8, 8)):
        mesh = tpt.StructuredMesh([0, 0, 0], [1, 1, 1], cells)
        V = tpt.FunctionSpace(mesh, tpt.QkFEM(1, 3))
        return tpt.GridOperator(V, TFEM(TFieldA()), constraints=tpt.constraints(True, V),
                                skip_boundary=True, quad_order=quad_order)

    assert make_fused_japply(go_of(7)) is not None
    go = go_of(8)
    assert go._vol_tab[0].shape[0] == 5**3
    assert make_fused_japply(go) is None and make_fused_residual(go) is None
    gmg = VarCoeffGMG(go)
    assert len(gmg.lmax) == 2 and all(np.isfinite(gmg.lmax))
    b = -go.residual(go.space.zero(torch.float32))
    x, info = gmg.solve_host(b, tol=1e-6, maxiter=40)
    assert info["converged"] and info["true_defect"] / info["defect0"] < 1e-5
