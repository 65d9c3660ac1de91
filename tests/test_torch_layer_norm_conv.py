"""The last two TPU kernels' plain versions in paddle_tpu_torch, held
against the Pallas kernels in interpret mode, and the fused_layer_norm op
against the reference op.

* ``plain_layer_norm`` against ``_ln_pallas`` (``_ln_kernel``) run in
  interpret mode through ``fused_layer_norm`` with ``PT_PALLAS=interpret``
  (H = 384 and 1024; with and without scale and bias; fp32 and bf16):
  y, mean and rstd within rtol = atol = 1e-5 in fp32; bf16 y within one
  bf16 ulp (2^-7 relative) + 1e-2 (|y| up to ~4). Also the port's
  ``FusedLayerNorm`` backward against the reference kernel's custom vjp
  (``_fused_ln_bwd``) on the same cotangent: 1e-5 (fp32).
* The ``fused_layer_norm`` op: forward outputs and its ``__vjp_grad__``
  (dX, dScale, dBias) against the reference op on its default CPU route
  (the jnp formula, differentiated by JAX): 1e-5 for fp32, and Variance
  = 1 / rstd^2 - eps.
* ``plain_conv_bn_relu`` against ``pallas_conv_bn_relu`` of
  ``tools/exp_pallas_conv.py`` in interpret mode at the tool's H = W =
  14, C = Co = 256 and N = 2, bn = 2: both sum 9 products of bf16 values
  in fp32 and round once to bf16, so one bf16 ulp (2^-7 relative) + 1e-3
  apart at most. The tool is imported with ``tools/`` on ``sys.path`` and
  ``pl.pallas_call`` set to interpret inside the test; nothing of the
  tool changes.
"""

import functools
import importlib
import json
import os
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu.core import registry as jax_registry
from paddle_tpu.core.ir import OpDesc as JOpDesc

import paddle_tpu_torch  # noqa: F401
from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.core.ir import OpDesc as POpDesc
from paddle_tpu_torch.kernels import conv_bn_relu as pcbr
from paddle_tpu_torch.kernels import layer_norm as pln

torch.set_num_threads(2)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


def _bf16_np(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


def _ln_case(h, rows, with_scale, with_bias, dtype, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, h) * 2 + 0.5).astype(np.float32)
    if dtype == "bfloat16":
        x = _bf16_np(x).astype(np.float32)
    scale = (rng.rand(h) + 0.5).astype(np.float32) if with_scale else None
    bias = rng.randn(h).astype(np.float32) if with_bias else None
    return x, scale, bias


def _jnp(x, dtype="float32"):
    import jax.numpy as jnp

    return None if x is None else jnp.asarray(x, getattr(jnp, dtype))


def _t(x, dtype=torch.float32):
    return None if x is None else torch.from_numpy(x.copy()).to(dtype)


LN_CASES = [(384, True, True, "float32"), (384, False, False, "float32"),
            (1024, True, False, "float32"), (1024, False, True, "float32"),
            (1024, True, True, "bfloat16"), (384, True, True, "bfloat16")]


@pytest.mark.parametrize("h,with_scale,with_bias,dtype", LN_CASES)
def test_ln_plain_version_matches_pallas_kernel_in_interpret_mode(
        monkeypatch, h, with_scale, with_bias, dtype):
    import jax

    monkeypatch.setenv("PT_PALLAS", "interpret")
    ref_mod = importlib.import_module("paddle_tpu.ops.pallas.layer_norm")
    x, scale, bias = _ln_case(h, 48, with_scale, with_bias, dtype, h)
    jx, js, jb = _jnp(x, dtype), _jnp(scale), _jnp(bias)
    (y, mean, rstd), vjp = jax.vjp(
        lambda a: ref_mod.fused_layer_norm(a, js, jb, eps=1e-5), jx)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tx = _t(x, tdt)
    py, pmean, prstd = pln.plain_layer_norm(tx, _t(scale), _t(bias), 1e-5)
    assert py.dtype == tdt and pmean.dtype == prstd.dtype == torch.float32
    np.testing.assert_allclose(pmean.numpy(), np.asarray(mean), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(prstd.numpy(), np.asarray(rstd), rtol=1e-5,
                               atol=1e-5)
    want = np.asarray(y).astype(np.float32)
    if dtype == "bfloat16":
        np.testing.assert_allclose(py.float().numpy(), want, rtol=2 ** -7,
                                   atol=1e-2)
        return
    np.testing.assert_allclose(py.numpy(), want, rtol=1e-5, atol=1e-5)
    # the backward: the reference kernel's custom vjp, the port's Function
    dy = np.random.RandomState(h + 1).randn(48, h).astype(np.float32)
    (jdx,) = vjp((_jnp(dy), jax.numpy.zeros(48), jax.numpy.zeros(48)))
    leaf = tx.clone().requires_grad_(True)
    ts = _t(scale).requires_grad_(True) if with_scale else None
    tb = _t(bias).requires_grad_(True) if with_bias else None
    out = pln.fused_layer_norm(leaf, ts, tb, 1e-5)[0]
    out.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jdx),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,with_scale,with_bias,dtype", LN_CASES[:4])
def test_ln_backward_is_the_reference_formula(h, with_scale, with_bias,
                                              dtype):
    """dScale and dBias too: the port's backward against the reference's
    ``_fused_ln_bwd`` on the same residuals and cotangent."""
    ref_mod = importlib.import_module("paddle_tpu.ops.pallas.layer_norm")
    x, scale, bias = _ln_case(h, 32, with_scale, with_bias, dtype, h + 7)
    dy = np.random.RandomState(h).randn(32, h).astype(np.float32)
    _, mean, rstd = pln.plain_layer_norm(_t(x), None, None, 1e-5)
    want = ref_mod._fused_ln_bwd(
        1e-5, False, (_jnp(x), _jnp(scale), _jnp(bias),
                      _jnp(mean.numpy()), _jnp(rstd.numpy())),
        (_jnp(dy), None, None))
    leaves = [_t(v).requires_grad_(True) if v is not None else None
              for v in (x, scale, bias)]
    pln.fused_layer_norm(*leaves, 1e-5)[0].backward(torch.from_numpy(dy))
    for w, leaf in zip(want, leaves):
        assert (w is None) == (leaf is None)
        if leaf is not None:
            np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_affine", [True, False])
def test_fused_layer_norm_op_and_grad_match_reference(with_affine):
    rng = np.random.RandomState(5)
    h = 256
    ins = {"X": (rng.randn(3, 7, h) * 3 + 1).astype(np.float32)}
    if with_affine:
        ins["Scale"] = (rng.rand(h) + 0.5).astype(np.float32)
        ins["Bias"] = rng.randn(h).astype(np.float32)
    attrs = {"epsilon": 1e-5}
    jins = {k: [_jnp(v)] for k, v in ins.items()}
    pins = {k: [_t(v)] for k, v in ins.items()}
    want = jax_registry.get("fused_layer_norm").forward(jins, dict(attrs))
    got = pt_registry.get("fused_layer_norm").forward(pins, dict(attrs))
    assert set(got) == set(want) == {"Y", "Mean", "Variance"}
    for slot in want:
        np.testing.assert_allclose(got[slot].numpy(), np.asarray(want[slot]),
                                   rtol=1e-5, atol=1e-5, err_msg=slot)
    # the grad op of the same OpDesc, with a cotangent on Y only
    in_names = {s: [s] for s in ins}
    out_names = {s: [s] for s in want}
    out_grads = {"Y": ["Y@GRAD"], "Mean": [None], "Variance": [None]}
    in_grads = {s: [f"{s}@GRAD"] for s in ins}
    (jg,) = jax_registry.default_grad_maker(
        JOpDesc("fused_layer_norm", in_names, out_names, attrs), out_grads,
        in_grads)
    (pg,) = pt_registry.default_grad_maker(
        POpDesc("fused_layer_norm", in_names, out_names, attrs), out_grads,
        in_grads)
    assert json.dumps(pg.to_dict(), sort_keys=True) == \
        json.dumps(jg.to_dict(), sort_keys=True)
    dy = rng.randn(3, 7, h).astype(np.float32)

    def gather(conv):
        env = dict(ins, **{"Y@GRAD": dy})
        return {slot: [None if n == "@EMPTY@" else conv(env[n])
                       for n in names] for slot, names in jg.inputs.items()}

    want = jax_registry.get("__vjp_grad__").forward(gather(_jnp),
                                                    dict(jg.attrs))
    got = pt_registry.get("__vjp_grad__").forward(gather(_t), dict(pg.attrs))
    for slot in jg.outputs:
        np.testing.assert_allclose(got[slot][0].numpy(),
                                   np.asarray(want[slot][0]), rtol=1e-5,
                                   atol=1e-5, err_msg=slot)


def test_ln_wrapper_takes_the_plain_version_on_cpu_and_meta():
    before = pln.launches
    x = torch.randn(4, 8192)
    y, mean, rstd = pln.layer_norm_fwd(x, None, None, 1e-5)
    assert y.shape == x.shape and mean.shape == rstd.shape == (4,)
    m = pln.layer_norm_fwd(torch.empty(4, 100, device="meta"), None, None,
                           1e-5)
    assert [t.device.type for t in m] == ["meta"] * 3
    assert pln.launches == before


def test_conv_plain_version_matches_pallas_kernel_in_interpret_mode(
        monkeypatch):
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    monkeypatch.syspath_prepend(TOOLS)
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    tool = importlib.import_module("exp_pallas_conv")
    n, h, w, c, co = 2, tool.H, tool.W, tool.C, tool.CO
    assert (h, w, c, co) == (14, 14, 256, 256)
    rng = np.random.RandomState(0)
    x = _bf16_np(rng.randn(n, h, w, c) * 0.5)
    xp = np.pad(x, [(0, 0), (1, 1), (1, 1), (0, 0)])
    wt = _bf16_np(rng.randn(3, 3, c, co) * 0.05)
    scale = (rng.randn(co) * 0.1 + 1.0).astype(np.float32)
    shift = (rng.randn(co) * 0.1).astype(np.float32)
    want = np.asarray(tool.pallas_conv_bn_relu(
        jnp.asarray(xp), jnp.asarray(wt), jnp.asarray(scale),
        jnp.asarray(shift), bn=2)).astype(np.float32)
    got = pcbr.plain_conv_bn_relu(
        _t(xp.astype(np.float32), torch.bfloat16),
        _t(wt.astype(np.float32), torch.bfloat16), _t(scale), _t(shift))
    assert got.dtype == torch.bfloat16 and got.shape == (n, h, w, co)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-3)
    assert float((want > 0).mean()) > 0.3       # the ReLU kept a share
    sys.modules.pop("exp_pallas_conv", None)


def test_conv_wrapper_takes_the_plain_version_on_cpu():
    before = pcbr.launches
    xp = torch.randn(1, 6, 6, 16).bfloat16()
    w = torch.randn(3, 3, 16, 8).bfloat16()
    out = pcbr.conv_bn_relu(xp, w, torch.ones(8), torch.zeros(8))
    ref = torch.relu(torch.nn.functional.conv2d(
        xp.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1)))
    np.testing.assert_allclose(out.float().numpy(),
                               ref.permute(0, 2, 3, 1).bfloat16().float()
                               .numpy(), rtol=2 ** -7, atol=1e-3)
    assert pcbr.launches == before
