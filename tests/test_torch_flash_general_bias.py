"""The flash_attention op with a bias that is not a key bias: the
reference's ``reference_general`` route (plain attention with the full
bias, fp32 softmax, the position-keyed probs dropout), in the port
against paddle_tpu's lowering on the same numpy inputs, on the CPU.

* Biases [B,H,Sq,Sk] and [B,1,Sq,Sk], in the packed [B,S,n*hd] and the
  [B,H,S,D] layouts, causal and not, with probs dropout and without:
  Out within 1e-5 (fp32) and 2e-2 (bf16, both packages compute in fp32
  and round the output once); the grad op's Q, K, V and Bias gradients
  within 1e-5 (fp32) and 5e-2 (bf16), BiasGrad in the Bias's own shape
  (summed over the heads for [B,1,Sq,Sk]).
* Lse: the true log-sum-exp of the biased, masked fp32 scores (the
  reference gives zeros on this route; ROADMAP names the choice), within
  1e-5 of a float64 numpy computation.
* Each route call counts one ``general_calls``; a key bias on the same
  op takes the kernel's route (its plain version on the CPU) and counts
  none.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu.core import registry as jax_registry

from paddle_tpu_torch import kernels
from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.kernels import flash_attention as pfa

torch.set_num_threads(2)

B, H, SQ, SK, HD = 2, 3, 24, 32, 16
RATE = 0.2


def _inputs(layout, bias_heads, dtype, seed=0):
    rng = np.random.RandomState(seed)
    if layout == "packed":
        q = rng.randn(B, SQ, H * HD)
        k, v = (rng.randn(B, SK, H * HD) for _ in range(2))
        do = rng.randn(B, SQ, H * HD)
    else:
        q = rng.randn(B, H, SQ, HD)
        k, v = (rng.randn(B, H, SK, HD) for _ in range(2))
        do = rng.randn(B, H, SQ, HD)
    bias = rng.randn(B, bias_heads, SQ, SK)
    cast = (lambda x: x.astype(np.float32).astype(ml_dtypes.bfloat16)) \
        if dtype == "bfloat16" else (lambda x: x.astype(np.float32))
    return {"Q": cast(q), "K": cast(k), "V": cast(v),
            "Bias": bias.astype(np.float32)}, cast(do)


def _attrs(layout, causal, rate):
    a = {"causal": causal, "scale": HD ** -0.5, "seed": 11, "__step__": 3}
    if rate:
        a.update(dropout_prob=rate, is_test=False)
    if layout == "packed":
        a["num_heads"] = H
    return a


def _t(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax(op, ins, attrs):
    return jax_registry.normalize_outputs(jax_registry.get(op).forward(
        {k: [jnp.asarray(v)] for k, v in ins.items()}, dict(attrs)))


def _port(op, ins, attrs):
    return pt_registry.normalize_outputs(pt_registry.get(op).forward(
        {k: [v if isinstance(v, torch.Tensor) else _t(v)]
         for k, v in ins.items()}, dict(attrs)))


def _lse64(ins, layout, causal):
    q, k = (np.asarray(ins[n], np.float64) for n in ("Q", "K"))
    if layout == "packed":
        q = q.reshape(B, SQ, H, HD).transpose(0, 2, 1, 3)
        k = k.reshape(B, SK, H, HD).transpose(0, 2, 1, 3)
    s = q @ k.transpose(0, 1, 3, 2) * HD ** -0.5 + ins["Bias"]
    if causal:
        hide = np.arange(SK)[None, :] > np.arange(SQ)[:, None] + (SK - SQ)
        s = np.where(hide, -1e30, s)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_heads", [H, 1])
@pytest.mark.parametrize("layout", ["packed", "bnsd"])
def test_general_bias_matches_the_reference(layout, bias_heads, causal, rate,
                                            dtype):
    ins, do = _inputs(layout, bias_heads, dtype,
                      seed=bias_heads + 2 * causal)
    attrs = _attrs(layout, causal, rate)
    before = pfa.general_calls
    want, got = _jax("flash_attention", ins, attrs), \
        _port("flash_attention", ins, attrs)
    out_tol = 1e-5 if dtype == "float32" else 2e-2
    assert got["Out"][0].dtype == _t(ins["Q"]).dtype
    np.testing.assert_allclose(_f32(got["Out"][0]), _f32(want["Out"][0]),
                               rtol=out_tol, atol=out_tol)
    assert tuple(got["Lse"][0].shape) == (B, H, SQ)
    np.testing.assert_allclose(got["Lse"][0].numpy(),
                               _lse64(ins, layout, causal), rtol=1e-5,
                               atol=1e-5)
    g_ins = dict(ins, OutGrad=do, Out=got["Out"][0], Lse=got["Lse"][0])
    j_ins = dict(ins, OutGrad=do, Out=np.asarray(want["Out"][0]),
                 Lse=np.asarray(want["Lse"][0]))
    jg = _jax("flash_attention_grad", j_ins, attrs)
    pg = _port("flash_attention_grad", g_ins, attrs)
    assert set(pg) == set(jg) == {"QGrad", "KGrad", "VGrad", "BiasGrad"}
    g_tol = 1e-5 if dtype == "float32" else 5e-2
    for slot in jg:
        assert tuple(pg[slot][0].shape) == tuple(jg[slot][0].shape), slot
        np.testing.assert_allclose(_f32(pg[slot][0]), _f32(jg[slot][0]),
                                   rtol=g_tol, atol=g_tol, err_msg=slot)
    assert tuple(pg["BiasGrad"][0].shape) == (B, bias_heads, SQ, SK)
    assert pfa.general_calls == before + 2


def test_a_key_bias_on_the_same_op_takes_the_kernel_route():
    ins, _ = _inputs("packed", H, "float32")
    attrs = _attrs("packed", False, RATE)
    key = dict(ins, Bias=ins["Bias"][:, :1, :1, :].copy())
    kernels.reset_launch_counts()
    got = _port("flash_attention", key, attrs)
    assert kernels.general_route_calls() == 0
    full = _port("flash_attention", ins, attrs)
    assert kernels.general_route_calls() == 1
    assert kernels.snapshot_counts()[kernels.GENERAL] == 1
    out, _ = pfa.plain_flash_fwd(_t(ins["Q"]), _t(ins["K"]), _t(ins["V"]), H,
                                 HD ** -0.5, False,
                                 _t(key["Bias"]).reshape(B, SK), RATE,
                                 rng.op_seed(attrs), "packed")
    assert torch.equal(got["Out"][0], out)
    assert not torch.equal(full["Out"][0], got["Out"][0])
