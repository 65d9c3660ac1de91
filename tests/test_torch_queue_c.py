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
