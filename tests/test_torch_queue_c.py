"""Three lowerings of the port held against the reference where they had
drifted from it.

* ``reduce_sum``: ``dim=[]`` reduces no axis (``jnp.sum(axis=())``
  returns X), while ``dim`` absent or ``reduce_all`` reduces every axis;
  float32 and int32 inputs, with and without ``keep_dim``. Values exact
  for int32, within rtol = atol = 1e-6 for float32 (sums in another
  order); shapes and dtypes equal.
* ``layer_norm``: Variance is the mean of squared deviations over the
  normalised axes, in fp32, as the reference computes it: on constant
  rows (0, and never negative), on rows whose variance is about 1e-6
  beside a mean of 1 (the case where 1 / rstd^2 - eps lost digits) and
  on random rows, within rtol 1e-6 (atol 1e-12) of the reference.
* A bf16 fetch of ``Executor.run`` comes back as an ``ml_dtypes.bfloat16``
  array, as the reference's does, with the same bits; without ml_dtypes,
  as float32.
* C4: ``fill_constant`` and the random initializers hold 64-bit dtypes as
  32-bit (x64 off): ``layers.fill_constant([2], "int64", 3)`` fetches
  int32 in both packages, a float64 initializer yields float32.
* C5: ``reduce_sum`` of a bool X is int32 over any axes.
* C6: ``mean`` of an integer X is float32 (int32 [0..4] gives 2.0).
* C7: ``gather`` and ``lookup_table_v2`` index as ``jnp.take``: -1 is the
  last row, an index of n (or below -n) takes the fill (NaN for floats,
  the int32 minimum for int32), and an out-of-range id gets no gradient.
* C8: ``scale`` casts the bias to X's dtype first (int32 [0..3], scale
  0.5, bias 1.5 gives float32 [1, 1.5, 2, 2.5]); ``top_k`` ranks +0.0
  before -0.0 ([0, -0, 0] gives [[0, 2, 1]]).
* C19: a 0-d value makes a 0-d VarBase, and a Python number beside a
  0-d VarBase keeps the result 0-d (a [1] VarBase stays [1]).
* C20: ``pow`` takes IEEE pow's values at -0 and -inf for factors 0.5
  and -0.5 (torch's sqrt and rsqrt did not).
* C21: ``cumsum`` with ``axis=None`` sums X flattened.
Each is exact against the reference: values, shapes and dtypes.
"""

import sys

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu import layers as jlayers
from paddle_tpu.core import registry as jax_registry

import paddle_tpu_torch as ptt
from paddle_tpu_torch import layers as players
from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.core import rng as pt_rng
from paddle_tpu_torch.core.executor import Executor

torch.set_num_threads(2)


def _jax_op(op_type, ins, attrs):
    return jax_registry.normalize_outputs(jax_registry.get(op_type).forward(
        {k: [jnp.asarray(v)] for k, v in ins.items()}, dict(attrs)))


def _pt_op(op_type, ins, attrs):
    return pt_registry.normalize_outputs(pt_registry.get(op_type).forward(
        {k: [torch.from_numpy(np.array(v))] for k, v in ins.items()},
        dict(attrs)))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("attrs", [
    {"dim": []}, {"dim": [], "keep_dim": True}, {"dim": None}, {},
    {"dim": [1], "reduce_all": True}, {"dim": [0, 2], "keep_dim": True},
    {"dim": [-1]}])
def test_reduce_sum_matches_the_reference(dtype, attrs):
    rng = np.random.RandomState(3)
    x = (rng.randn(3, 4, 5) * 10).astype(dtype)
    want = np.asarray(_jax_op("reduce_sum", {"X": x}, attrs)["Out"][0])
    got = _pt_op("reduce_sum", {"X": x}, attrs)["Out"][0].numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if attrs.get("dim") == [] and not attrs.get("reduce_all"):
        np.testing.assert_array_equal(got, x)


def _ln_rows(kind):
    rng = np.random.RandomState(11)
    if kind == "constant":
        return np.full((4, 6, 64), 3.25, np.float32)
    if kind == "var_1e-6":
        return (1.0 + 1e-3 * rng.randn(4, 6, 64)).astype(np.float32)
    return (rng.randn(4, 6, 64) * 2 + 0.5).astype(np.float32)


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("kind", ["constant", "var_1e-6", "random"])
def test_layer_norm_variance_matches_the_reference(kind, axis):
    x = _ln_rows(kind)
    h = int(np.prod(x.shape[axis:]))
    rng = np.random.RandomState(12)
    ins = {"X": x, "Scale": (rng.rand(h) + 0.5).astype(np.float32),
           "Bias": rng.randn(h).astype(np.float32)}
    attrs = {"epsilon": 1e-5, "begin_norm_axis": axis}
    want = _jax_op("layer_norm", ins, attrs)
    got = _pt_op("layer_norm", ins, attrs)
    var = got["Variance"][0].numpy()
    assert var.dtype == np.float32 and var.shape == x.shape[:axis]
    np.testing.assert_allclose(var, np.asarray(want["Variance"][0]),
                               rtol=1e-6, atol=1e-12)
    assert (var >= 0).all()
    if kind == "constant":
        assert (var == 0).all()
    np.testing.assert_allclose(got["Mean"][0].numpy(),
                               np.asarray(want["Mean"][0]), rtol=1e-6,
                               atol=1e-6)
    # Y (unchanged here): a one-ulp difference in the two means moves y by
    # ulp(mean) * rstd * scale, up to ~2e-4 on the var ~ 1e-6 rows
    mean = np.abs(np.asarray(want["Mean"][0])).max()
    rstd = 1.0 / np.sqrt(np.asarray(want["Variance"][0]).min() + 1e-5)
    slack = 4 * np.finfo(np.float32).eps * mean * rstd * ins["Scale"].max()
    np.testing.assert_allclose(got["Y"][0].numpy(), np.asarray(want["Y"][0]),
                               rtol=1e-4, atol=1e-4 + slack)


def _bf16_programs():
    """x [2, 3] fp32 fed, cast to bf16 and scaled by 3 in both packages."""
    jmain, jstart = pt.Program(), pt.Program()
    with pt.program_guard(jmain, jstart):
        x = jlayers.data("x", [3], dtype="float32")
        jy = jlayers.scale(jlayers.cast(x, "bfloat16"), scale=3.0)
    pmain, pstart = ptt.Program(), ptt.Program()
    with ptt.program_guard(pmain, pstart):
        x = players.static_data("x", [-1, 3], "float32")
        py = players.scale(players.cast(x, "bfloat16"), scale=3.0)
    return (jmain, jstart, jy), (pmain, pstart, py)


def test_bf16_fetch_is_an_ml_dtypes_array_as_in_the_reference():
    (jmain, jstart, jy), (pmain, pstart, py) = _bf16_programs()
    feed = {"x": np.array([[1.0, -2.5, 0.3], [7.1, 1e-3, -0.7]], np.float32)}
    jexe = pt.Executor(pt.CPUPlace())
    jexe.run(jstart, use_compiled=False)
    want, = jexe.run(jmain, feed=feed, fetch_list=[jy], use_compiled=False)
    exe, scope = Executor(device="cpu"), ptt.Scope()
    exe.run(pstart, scope=scope)
    got, = exe.run(pmain, feed=feed, fetch_list=[py], scope=scope)
    assert want.dtype == ml_dtypes.bfloat16
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))
    # numpy arithmetic on the fetch still holds
    np.testing.assert_allclose(got.astype(np.float32) / 3.0,
                               feed["x"], rtol=2 ** -7)


def test_bf16_fetch_without_ml_dtypes_is_float32(monkeypatch):
    _, (pmain, pstart, py) = _bf16_programs()
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    exe, scope = Executor(device="cpu"), ptt.Scope()
    exe.run(pstart, scope=scope)
    got, = exe.run(pmain, feed={"x": np.ones((2, 3), np.float32)},
                   fetch_list=[py], scope=scope)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.full((2, 3), 3.0, np.float32))


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, got.dtype, want.shape, want.dtype)
    np.testing.assert_array_equal(got, want)


def _both_ops(op_type, ins, attrs):
    want = {k: [np.asarray(v) for v in vs]
            for k, vs in _jax_op(op_type, ins, attrs).items()}
    got = {k: [v.numpy() for v in vs]
           for k, vs in _pt_op(op_type, ins, attrs).items()}
    return got, want


def test_c4_fill_constant_int64_fetches_int32_as_in_the_reference():
    jmain, jstart = pt.Program(), pt.Program()
    with pt.program_guard(jmain, jstart):
        jy = jlayers.fill_constant([2], "int64", 3)
    pmain, pstart = ptt.Program(), ptt.Program()
    with ptt.program_guard(pmain, pstart):
        py = players.fill_constant([2], "int64", 3)
    jexe = pt.Executor(pt.CPUPlace())
    want, = jexe.run(jmain, fetch_list=[jy], use_compiled=False)
    exe, scope = Executor(device="cpu"), ptt.Scope()
    got, = exe.run(pmain, fetch_list=[py], scope=scope)
    assert want.dtype == np.int32
    _same(got, want)


@pytest.mark.parametrize("op_type,dtype", [
    ("fill_constant", "int64"), ("fill_constant", "float64"),
    ("uniform_random", "float64"), ("gaussian_random", "float64"),
    ("truncated_gaussian_random", "float64")])
def test_c4_64_bit_dtypes_become_32_bit(op_type, dtype):
    attrs = {"shape": [3, 2], "dtype": dtype, "value": 3.0, "seed": 7}
    got, want = _both_ops(op_type, {}, attrs)
    g, w = got["Out"][0], want["Out"][0]
    assert g.shape == w.shape == (3, 2)
    assert g.dtype == w.dtype == np.dtype(dtype.replace("64", "32"))
    if op_type == "fill_constant":
        _same(g, w)


@pytest.mark.parametrize("attrs", [
    {"dim": [1]}, {"dim": [0], "keep_dim": True}, {"dim": [0, 1]},
    {"reduce_all": True}, {}, {"dim": []}])
def test_c5_reduce_sum_of_bool_is_int32_on_every_axis_set(attrs):
    x = np.random.RandomState(5).rand(3, 4) < 0.5
    got, want = _both_ops("reduce_sum", {"X": x}, attrs)
    assert want["Out"][0].dtype == np.int32
    _same(got["Out"][0], want["Out"][0])


@pytest.mark.parametrize("x", [np.arange(5, dtype=np.int32),
                               np.array([[1, 2], [4, 8]], np.int32),
                               np.array([True, False, True])])
def test_c6_mean_of_an_integer_x_is_float32(x):
    got, want = _both_ops("mean", {"X": x}, {})
    assert want["Out"][0].dtype == np.float32
    _same(got["Out"][0], want["Out"][0])


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("index,axis", [
    ([-1, 0, 2], 0), ([4, 1], 0), ([[-4, 3], [-5, 0]], 0), ([-1, 3], 1),
    ([5, -6], 1)])
def test_c7_gather_wraps_negatives_and_fills_out_of_range(dtype, index,
                                                          axis):
    x = (np.random.RandomState(7).randn(4, 5) * 10).astype(dtype)
    ins = {"X": x, "Index": np.asarray(index, np.int32)}
    got, want = _both_ops("gather", ins, {"axis": axis})
    _same(got["Out"][0], want["Out"][0])


@pytest.mark.parametrize("ids", [[[-1, 2], [0, -1]], [[4, 1], [-3, 5]]])
def test_c7_lookup_table_v2_and_its_gradient_index_as_jnp_take(ids):
    rng = np.random.RandomState(9)
    ins = {"W": rng.randn(4, 3).astype(np.float32),
           "Ids": np.asarray(ids, np.int32)}
    got, want = _both_ops("lookup_table_v2", ins, {})
    _same(got["Out"][0], want["Out"][0])
    # the gradient: out-of-range ids add nothing, -1 adds to the last row
    dout = rng.randn(2, 2, 3).astype(np.float32)
    w = torch.from_numpy(ins["W"]).requires_grad_()
    out = pt_registry.get("lookup_table_v2").forward(
        {"W": [w], "Ids": [torch.from_numpy(ins["Ids"])]}, {})["Out"]
    out.backward(torch.from_numpy(dout))
    import jax

    def f(wj):
        return jax_registry.get("lookup_table_v2").forward(
            {"W": [wj], "Ids": [jnp.asarray(ins["Ids"])]}, {})["Out"]

    _, vjp = jax.vjp(f, jnp.asarray(ins["W"]))
    want_dw = np.asarray(vjp(jnp.asarray(dout))[0])
    np.testing.assert_allclose(w.grad.numpy(), want_dw, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("x,attrs", [
    (np.arange(4, dtype=np.int32), {"scale": 0.5, "bias": 1.5}),
    (np.arange(4, dtype=np.int32), {"scale": 0.5, "bias": -1.5,
                                    "bias_after_scale": False}),
    (np.arange(4, dtype=np.int32), {"scale": 3, "bias": 2.7}),
    (np.arange(4, dtype=np.float32) * 0.3, {"scale": 0.5, "bias": 0.1})])
def test_c8_scale_casts_the_bias_to_x_dtype(x, attrs):
    got, want = _both_ops("scale", {"X": x}, attrs)
    _same(got["Out"][0], want["Out"][0])


@pytest.mark.parametrize("x,k", [
    (np.array([[0.0, -0.0, 0.0]], np.float32), 3),
    (np.array([[-0.0, 1.0, 0.0, -0.0, 1.0, 0.0]], np.float32), 4),
    (np.array([[2.0, -0.0, 2.0, -1.0], [0.0, 0.0, -0.0, -0.0]], np.float32),
     2),
    (np.array([[3, 1, 3, 2]], np.int32), 3)])
def test_c8_top_k_ranks_positive_zero_first(x, k):
    got, want = _both_ops("top_k", {"X": x}, {"k": k})
    _same(got["Out"][0], want["Out"][0])
    np.testing.assert_array_equal(np.signbit(got["Out"][0]),
                                  np.signbit(want["Out"][0]))
    np.testing.assert_array_equal(got["Indices"][0], want["Indices"][0])


# C9: causal flash attention with Sq > Sk. The first Sq - Sk rows see no
# key; the reference's finite mask value (-1e30) gives them the uniform
# softmax over all Sk keys (the mean of the masked v, lse -1e30), and its
# vjp gives them dq = 0, no dk and dv += (1 / Sk) mask do.
C9_SQ, C9_SK, C9_H, C9_HD = 256, 128, 2, 64


def _c9_inputs(dtype, with_bias):
    rng = np.random.RandomState(19)
    q, do = (rng.randn(1, C9_H, C9_SQ, C9_HD).astype(np.float32)
             for _ in range(2))
    k, v = (rng.randn(1, C9_H, C9_SK, C9_HD).astype(np.float32)
            for _ in range(2))
    kb = np.where(rng.rand(1, C9_SK) < 0.25, -1e4, 0.0).astype(np.float32) \
        if with_bias else None
    jt = [jnp.asarray(x, dtype) for x in (q, k, v, do)]
    tt = [torch.from_numpy(np.array(x.astype(jnp.float32)))
          .to(torch.float32 if dtype == jnp.float32 else torch.bfloat16)
          for x in jt]
    return jt, tt, kb


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_c9_rows_without_a_visible_key_match_the_reference(dtype, with_bias,
                                                           rate):
    import importlib

    import jax

    from paddle_tpu_torch.kernels import flash_attention as fa

    jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    (jq, jk, jv, jdo), (q, k, v, do), kb = _c9_inputs(jdt, with_bias)
    seed, scale = 0x9E37, C9_HD ** -0.5
    jb = None if kb is None else jnp.asarray(kb)
    tb = None if kb is None else torch.from_numpy(kb)

    def ref(q_, k_, v_):
        return jfa.reference_attention(q_, k_, v_, jb, True, scale, rate,
                                       jnp.uint32(seed))

    want_o, vjp = jax.vjp(ref, jq, jk, jv)
    want_g = vjp(jdo)
    # the lse: the reference's fused kernel (Sq != Sk) in interpret mode
    _, want_lse = jfa._fwd_pallas_fused(jq, jk, jv, jb, True, scale, True,
                                        jnp.uint32(seed), rate)
    out, lse = fa.plain_flash_fwd(q, k, v, None, scale, True, tb, rate, seed,
                                  layout="bnsd")
    grads = fa.plain_flash_bwd(q, k, v, out, lse, do, None, scale, True, tb,
                               rate, seed, layout="bnsd")
    tol = 1e-5 if dtype == "float32" else 2e-2

    def f32(x):
        return np.asarray(jnp.asarray(x, jnp.float32))

    e = C9_SQ - C9_SK   # rows 0..e-1 see no key
    np.testing.assert_allclose(out.float().numpy(), f32(want_o), rtol=tol,
                               atol=tol)
    np.testing.assert_array_equal(lse[..., :e].numpy(),
                                  np.full((1, C9_H, e), -1e30, np.float32))
    np.testing.assert_allclose(lse.numpy(), f32(want_lse), rtol=1e-5,
                               atol=1e-5)
    # the rows that see no key: the mean of the masked v, as in the reference
    mult = 1.0
    if rate:
        keep = pt_rng.attn_keep(seed, rate, 1, C9_H, C9_SQ, C9_SK, "cpu")
        mult = keep[..., :e, :].float() / (1.0 - rate)
    mean_v = (mult * torch.ones(1, C9_H, e, C9_SK)) @ v.float() / C9_SK
    np.testing.assert_allclose(out[..., :e, :].float().numpy(),
                               mean_v.numpy(), rtol=tol, atol=tol)
    for name, g, w in zip(("dq", "dk", "dv"), grads[:3], want_g):
        np.testing.assert_allclose(g.float().numpy(), f32(w), rtol=tol,
                                   atol=tol, err_msg=name)
    assert not grads[0][..., :e, :].float().any()   # dq 0 on those rows


# C11-C14: each case runs the same numpy inputs through the reference's
# lowering and the port's; values, shapes and dtypes exact.

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_c11_sign_keeps_nan_and_the_sign_of_zero(dtype):
    x = np.array([np.nan, -0.0, 0.0, -2.5, 3.0, -np.inf], np.float32)
    want = np.asarray(jnp.sign(jnp.asarray(x, dtype)), np.float32)
    got = pt_registry.get("sign").forward(
        {"X": [torch.from_numpy(x).to(getattr(torch, dtype))]}, {})["Out"]
    got = got.float().numpy()
    np.testing.assert_array_equal(got, want)
    num = ~np.isnan(want)   # a NaN's sign bit carries nothing
    np.testing.assert_array_equal(np.signbit(got[num]), np.signbit(want[num]))


C12_CASES = [
    (np.array([np.nan, 3e9, -3e9], np.float32), "int32"),
    (np.array([300.0, -1.0], np.float32), "uint8"),
    (np.array([300.0], np.float32), "int8"),
    (np.array([np.nan, 1e5, -1e5, 7.9, -7.9], np.float32), "int16"),
    (np.array([np.nan, 1e10, -1e10, np.inf, -np.inf, 2.7, -2.7],
              np.float32), "int64"),
    (np.array([-0.5, 255.9, 256.0, np.nan], np.float32), "uint8"),
]


@pytest.mark.parametrize("x,dtype", C12_CASES)
def test_c12_cast_of_a_float_to_an_integer_saturates(x, dtype):
    got, want = _both_ops("cast", {"X": x}, {"out_dtype": dtype})
    _same(got["Out"][0], want["Out"][0])


def test_c12_the_named_values():
    def cast(x, dt):
        return _pt_op("cast", {"X": np.asarray(x, np.float32)},
                      {"out_dtype": dt})["Out"][0].numpy()

    np.testing.assert_array_equal(cast([np.nan, 3e9, -3e9], "int32"),
                                  [0, 2147483647, -2147483648])
    np.testing.assert_array_equal(cast([300, -1], "uint8"), [255, 0])
    np.testing.assert_array_equal(cast([300], "int8"), [127])


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("index,axis", [
    ([[-1, 5]], 1), ([[-3, 2, 3, -4]], 1), ([[0], [-2], [2]], 0)])
def test_c13_take_along_axis_wraps_and_fills(dtype, index, axis):
    x = np.array([[1, 2, 3]], dtype) if axis == 1 else \
        np.array([[1, 2, 3], [4, 5, 6]], dtype)
    ins = {"Input": x, "Index": np.asarray(index, np.int32)}
    got, want = _both_ops("take_along_axis", ins, {"Axis": axis})
    _same(got["Result"][0], want["Result"][0])


def test_c14_clip_with_neither_bound_returns_x():
    x = np.array([-3.0, 0.5, np.inf], np.float32)
    got, want = _both_ops("clip", {"X": x}, {})
    _same(got["Out"][0], want["Out"][0])
    _same(got["Out"][0], x)


def test_c14_check_finite_and_unscale_of_no_x_finds_nothing():
    scale = np.array([4.0], np.float32)
    want = jax_registry.get("check_finite_and_unscale").forward(
        {"X": [], "Scale": [jnp.asarray(scale)]}, {})
    got = pt_registry.get("check_finite_and_unscale").forward(
        {"X": [], "Scale": [torch.from_numpy(scale)]}, {})
    assert got["Out"] == [] and list(want["Out"]) == []
    _same(got["FoundInfinite"].numpy(), np.asarray(want["FoundInfinite"]))


def test_c14_top_k_past_the_axis_raises_in_both():
    x = np.ones((2, 3), np.float32)
    with pytest.raises(ValueError):
        _jax_op("top_k", {"X": x}, {"k": 4})
    with pytest.raises(ValueError):
        _pt_op("top_k", {"X": x}, {"k": 4})


# -- C15: Variable's operators -------------------------------------------------

def _c15_program(pkg, L, expr):
    """One program per package: x [2, 3] and y [2, 3] float32 fed, one
    expression of Variable operators on them, fetched."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = L.static_data("x", [2, 3])
        y = L.static_data("y", [2, 3])
        w = L.static_data("w", [3, 4])
        out = expr(x, y, w)
    return main, out


C15_EXPRS = {
    "sub": lambda x, y, w: x - y,
    "rsub_scalar": lambda x, y, w: 1.0 - x,
    "sub_scalar": lambda x, y, w: x - 2.5,
    "pow": lambda x, y, w: x ** y,
    "pow_scalar": lambda x, y, w: x ** 2.0,
    "neg": lambda x, y, w: -x,
    "matmul": lambda x, y, w: x @ w,
    "lt": lambda x, y, w: x < y,
    "le": lambda x, y, w: x <= y,
    "gt": lambda x, y, w: x > 0.5,
    "ge": lambda x, y, w: x >= y,
    "getitem_int": lambda x, y, w: x[1],
    "getitem_slice": lambda x, y, w: x[:, 1:],
    "getitem_last": lambda x, y, w: x[-1],
    "getitem_ellipsis": lambda x, y, w: x[..., 0],
    "astype": lambda x, y, w: (x * 3.0).astype("int32"),
    "masked_bias": lambda x, y, w: (1.0 - y) * (-1e9) + x * y,
}


@pytest.mark.parametrize("name", sorted(C15_EXPRS))
def test_c15_variable_operators_build_and_run_as_the_reference(name):
    """``x - y``, ``1.0 - x``, ``x ** y``, ``-x``, ``x @ w``, the four
    comparisons, ``x[...]`` and ``astype``: the same program JSON in both
    packages and the same fetched value (the port's Variable had only +,
    * and /, so ``1.0 - mask`` raised TypeError)."""
    import json

    from paddle_tpu.core import unique_name as jax_names
    from paddle_tpu_torch.core import unique_name as pt_names

    expr = C15_EXPRS[name]
    with jax_names.guard():
        jmain, jout = _c15_program(pt, jlayers, expr)
    with pt_names.guard():
        pmain, pout = _c15_program(ptt, players, expr)
    assert json.loads(json.dumps(pmain.to_dict())) == \
        json.loads(json.dumps(jmain.to_dict()))
    rng = np.random.RandomState(15)
    feed = {"x": rng.rand(2, 3).astype(np.float32) + 0.5,
            "y": np.round(rng.rand(2, 3)).astype(np.float32),
            "w": rng.randn(3, 4).astype(np.float32)}
    want, = pt.Executor(pt.CPUPlace()).run(
        jmain, feed=feed, fetch_list=[jout], scope=pt.Scope(),
        use_compiled=False)
    got, = Executor(device="cpu").run(pmain, feed=feed,
                                      fetch_list=[pout.name],
                                      scope=ptt.Scope())
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# -- C19: 0-d VarBases --------------------------------------------------------

def _c19_values(pkg, device=None):
    """The 0-d values C19 covers, made in ``pkg``'s dygraph mode: their
    shapes and values."""
    dy = pkg.dygraph
    with dy.guard(*(() if device is None else (device,))):
        made = {
            "VarBase(np.float32(3))": dy.VarBase(np.float32(3)),
            "VarBase(np.array(2.5))": dy.VarBase(np.array(2.5)),
            "VarBase(int)": dy.VarBase(7),
            "VarBase(bf16 0-d)": dy.VarBase(
                np.array(1.5, dtype=ml_dtypes.bfloat16)),
            "to_tensor(1.5)": pkg.tensor.to_tensor(1.5),
            "to_variable(np.float32(3))": dy.to_variable(np.float32(3)),
        }
        return {k: (v.shape, np.asarray(v.numpy(), np.float64))
                for k, v in made.items()}


def test_c19_a_0d_value_stays_0d_in_varbase_and_as_tensor():
    """A 0-d value makes a 0-d VarBase (np.ascontiguousarray gave it one
    dimension), as in the reference: shapes and values equal."""
    from paddle_tpu_torch.dygraph.varbase import as_tensor

    want, got = _c19_values(pt), _c19_values(ptt, "cpu")
    for k in want:
        assert got[k][0] == want[k][0] == [], (k, got[k], want[k])
        np.testing.assert_array_equal(got[k][1], want[k][1])
    assert as_tensor(1.5, "cpu").shape == torch.Size([])
    assert as_tensor(np.array(1.5, ml_dtypes.bfloat16), "cpu").shape == \
        torch.Size([])


C19_EXPRS = {
    "s * 2.0": lambda s: s * 2.0,
    "1.0 - s": lambda s: 1.0 - s,
    "s / 3": lambda s: s / 3,
    "s ** 2": lambda s: s ** 2,
}


def _c19_run(pkg, expr, device=None):
    dy = pkg.dygraph
    with dy.guard(*(() if device is None else (device,))):
        x = dy.to_variable(np.arange(6, dtype=np.float32).reshape(2, 3))
        s = x.sum()
        one = dy.to_variable(np.array([1.5], np.float32))
        out, kept = expr(s), expr(one)
        try:
            2 ** s
            rpow = None
        except TypeError as e:
            rpow = type(e)
        return (out.shape, out.numpy(), kept.shape, kept.numpy(), rpow)


@pytest.mark.parametrize("name", sorted(C19_EXPRS))
def test_c19_scalar_operands_keep_a_0d_result_0d(name):
    """With s = x.sum() (shape []), a Python number on either side keeps
    the result 0-d, and a [1] VarBase stays [1], as in the reference.
    ``2 ** s`` raises TypeError in both packages: neither VarBase has
    ``__rpow__``."""
    want = _c19_run(pt, C19_EXPRS[name])
    got = _c19_run(ptt, C19_EXPRS[name], "cpu")
    assert got[0] == want[0] == [] and got[2] == want[2] == [1]
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6)
    assert got[4] is want[4] is TypeError


# -- C20: pow at -0 and -inf ----------------------------------------------------

C20_X = [-0.0, 0.0, -np.inf, np.inf, np.nan, -1.0, 4.0]
C20_FACTORS = (0.5, -0.5, 2, 3, 0, -1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_c20_pow_takes_ieee_pow_at_negative_zero_and_infinity(dtype):
    """``pow`` over [-0, 0, -inf, inf, nan, -1, 4] with factors 0.5,
    -0.5, 2, 3, 0, -1: the reference's values bit for bit, the sign of
    every zero included, NaN where it is NaN (its sign bit is not
    compared) (torch took 0.5 as sqrt and -0.5 as rsqrt:
    [-0, nan] and [-inf, nan] at [-0, -inf]). An integer X keeps its
    integer power (factors 2 and 3, int32)."""
    npdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    x = np.array(C20_X, npdt)
    tx = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16) \
        if dtype == "bfloat16" else torch.from_numpy(x)
    for factor in C20_FACTORS:
        want = np.asarray(jax_registry.get("pow").forward(
            {"X": [jnp.asarray(x)]}, {"factor": factor})["Out"],
            np.float32)
        got = pt_registry.get("pow").forward(
            {"X": [tx]}, {"factor": factor})["Out"].float().numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(factor))
        num = ~np.isnan(want)
        assert np.array_equal(np.signbit(got[num]), np.signbit(want[num])), \
            factor
    # an integer X keeps its integer power
    xi = np.array([-3, -1, 0, 2, 5], np.int32)
    for factor in (2, 3):
        want = np.asarray(jax_registry.get("pow").forward(
            {"X": [jnp.asarray(xi)]}, {"factor": factor})["Out"])
        got = pt_registry.get("pow").forward(
            {"X": [torch.from_numpy(xi)]}, {"factor": factor})["Out"].numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# -- C21: cumsum over axis None -------------------------------------------------

@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.bool_])
def test_c21_cumsum_of_axis_none_sums_x_flattened(dtype, reverse):
    """``axis=None`` gives the running sum of X flattened (jnp.cumsum's
    None), from the end with ``reverse``; ``flatten=True`` gives the
    same; an integer or bool X sums in int32. Values, shapes and dtypes
    equal to the reference's."""
    x = (np.random.RandomState(21).randn(3, 4) * 4).astype(dtype)
    for attrs in ({"axis": None, "reverse": reverse},
                  {"axis": 0, "flatten": True, "reverse": reverse}):
        want = np.asarray(_jax_op("cumsum", {"X": x}, attrs)["Out"][0])
        got = _pt_op("cumsum", {"X": x}, attrs)["Out"][0].numpy()
        assert got.shape == want.shape == (12,), attrs
        assert got.dtype == want.dtype, (attrs, got.dtype, want.dtype)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
