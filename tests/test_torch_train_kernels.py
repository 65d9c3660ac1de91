"""The plain PyTorch versions of the training slice's three kernels, held
against the TPU kernels they replace, run in Pallas interpret mode.

* ``plain_packed_flash_fwd`` with dropout against ``_fwd_pallas_packed``
  (``_packed_fwd_kernel``), and ``plain_packed_flash_bwd`` against
  ``_bwd_pallas_packed`` (``_packed_bwd_kernel``): B = 2, S = 64 and 128,
  2 heads of 64, with and without key bias, causal masking and dropout.
  fp32 within 1e-5 (sums in another order); bf16 within 2e-2 (one bf16
  ulp of O(1) values is 2^-8, and products of bf16-rounded
  probabilities add up over S keys). The dropout masks agree bit for
  bit: a single differing bit would move an output by p / (1 - rate),
  far outside the fp32 tolerance.
* ``plain_fused_adamw`` against ``fused_adamw`` (``_adamw_kernel``) and
  against the reference's unfused ``adamw`` op, fp32 within 1e-6.
The CUDA kernels are held against these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu.core import registry as jax_registry
from paddle_tpu.ops.pallas import fused_adam as jadam

from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import fused_adam as fad

# the module: the package re-exports a function of the same name
jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

torch.set_num_threads(2)

B, N, HD = 2, 2, 64
SCALE = HD ** -0.5
SEED = 0x9E3779B1
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _bits(x):
    """numpy bf16 (ml_dtypes) or fp32 array -> torch tensor, bit for bit."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16).view(np.int16).copy()) \
            .view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _inputs(s, dtype, bias, seed):
    rng = np.random.RandomState(seed)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    arrs = [jnp.asarray(rng.randn(B, s, N * HD).astype(np.float32), jdt)
            for _ in range(4)]
    kb = None
    if bias:
        kb = np.where(rng.rand(B, s) < 0.25, -1e4, 0.0).astype(np.float32)
    return arrs, kb


CASES = [(64, b, c, r) for b in (False, True) for c in (False, True)
         for r in (0.0, 0.1)] + \
        [(128, True, False, 0.1), (128, False, True, 0.0),
         (128, True, True, 0.1), (128, False, False, 0.0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,bias,causal,rate", CASES)
def test_plain_flash_forward_matches_the_tpu_kernel(s, bias, causal, rate,
                                                    dtype):
    (q, k, v, _), kb = _inputs(s, dtype, bias, s + int(rate * 10))
    want_o, want_lse = jfa._fwd_pallas_packed(
        q, k, v, None if kb is None else jnp.asarray(kb), causal, SCALE,
        True, jnp.uint32(SEED), rate, N)
    out, lse = fa.packed_flash_fwd(
        _bits(q), _bits(k), _bits(v), N, SCALE, causal,
        None if kb is None else torch.from_numpy(kb), rate, SEED)
    assert out.dtype == _bits(q).dtype and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want_o, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,bias,causal,rate", CASES)
def test_plain_flash_backward_matches_the_tpu_kernel(s, bias, causal, rate,
                                                     dtype):
    (q, k, v, do), kb = _inputs(s, dtype, bias, 3 * s + int(rate * 10))
    jkb = None if kb is None else jnp.asarray(kb)
    o, lse = jfa._fwd_pallas_packed(q, k, v, jkb, causal, SCALE, True,
                                    jnp.uint32(SEED), rate, N)
    want = jfa._bwd_pallas_packed(q, k, v, jkb, causal, SCALE, True, o, lse,
                                  do, jnp.uint32(SEED), rate, N)
    got = fa.packed_flash_bwd(
        _bits(q), _bits(k), _bits(v), _bits(o), _bits(lse), _bits(do), N,
        SCALE, causal, None if kb is None else torch.from_numpy(kb), rate,
        SEED)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if w is None:
            assert g is None, name
            continue
        tol = TOL[dtype] * (10 if name == "dbias" else 1)   # N * S terms
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=tol,
                                   atol=tol, err_msg=name)


def test_plain_flash_backward_is_the_gradient_of_the_plain_forward():
    rng = np.random.RandomState(4)
    q, k, v, do = (torch.from_numpy(rng.randn(B, 96, N * HD)
                                    .astype(np.float32)) for _ in range(4))
    kb = torch.from_numpy(np.where(rng.rand(B, 96) < 0.2, -1e4, 0.0)
                          .astype(np.float32))
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out, lse = fa.plain_packed_flash_fwd(*qkv, N, SCALE, True, kb, 0.2, 9)
    want = torch.autograd.grad(out, qkv, do)
    got = fa.plain_packed_flash_bwd(q, k, v, out.detach(), lse.detach(), do,
                                    N, SCALE, True, kb, 0.2, 9)
    for g, w in zip(got[:3], want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_forward_without_dropout_is_unchanged_by_the_dropout_arguments():
    """rate 0 takes the serving path's arithmetic: same bits whatever the
    seed."""
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.randn(1, 40, 128).astype(np.float32))
               for _ in range(3))
    a = fa.packed_flash_fwd(q, k, v, 2, 0.125, True)
    b = fa.packed_flash_fwd(q, k, v, 2, 0.125, True, None, 0.0, 12345)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _adam_inputs(shape, seed, pdtype=np.float32):
    rng = np.random.RandomState(seed)
    return dict(p=rng.randn(*shape).astype(pdtype),
                g=(rng.randn(*shape) * 0.1).astype(pdtype),
                m=(rng.randn(*shape) * 0.01).astype(np.float32),
                v=(rng.rand(*shape) * 1e-3).astype(np.float32),
                lr=np.array([1e-2], np.float32),
                b1p=np.array([0.9 ** 5], np.float32),
                b2p=np.array([0.999 ** 5], np.float32))


@pytest.mark.parametrize("shape", [(300, 130), (64,), (1000, 33)])
def test_plain_adamw_matches_the_tpu_kernel(shape, monkeypatch):
    monkeypatch.setenv("PT_PALLAS", "interpret")
    a = _adam_inputs(shape, sum(shape))
    want = jadam.fused_adamw(a["p"], a["g"], a["m"], a["v"], a["lr"], 0.9,
                             0.999, 1e-8, 0.01, a["b1p"], a["b2p"])
    t = {k: torch.from_numpy(x.copy()) for k, x in a.items()}
    got = fad.plain_fused_adamw(t["p"], t["g"], t["m"], t["v"], t["lr"], 0.9,
                                0.999, 1e-8, 0.01, t["b1p"], t["b2p"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    # the in-place wrapper, on the CPU, is the plain version copied in
    p, m, v = fad.fused_adamw_(t["p"], t["g"], t["m"], t["v"], t["lr"], 0.9,
                               0.999, 1e-8, 0.01, t["b1p"], t["b2p"])
    assert p is t["p"] and m is t["m"] and v is t["v"]
    for g, w in zip(got, (p, m, v)):
        assert torch.equal(g, w)


def test_plain_adamw_matches_the_unfused_reference_op():
    a = _adam_inputs((77, 19), 2)
    want = jax_registry.get("adamw").forward(
        {"Param": [a["p"]], "Grad": [a["g"]], "LearningRate": [a["lr"]],
         "Moment1": [a["m"]], "Moment2": [a["v"]], "Beta1Pow": [a["b1p"]],
         "Beta2Pow": [a["b2p"]]},
        {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8, "coeff": 0.01,
         "with_decay": True})
    t = {k: torch.from_numpy(x.copy()) for k, x in a.items()}
    got = fad.plain_fused_adamw(t["p"], t["g"], t["m"], t["v"], t["lr"], 0.9,
                                0.999, 1e-8, 0.01, t["b1p"], t["b2p"])
    for g, slot in zip(got, ("ParamOut", "Moment1Out", "Moment2Out")):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[slot]),
                                   rtol=1e-6, atol=1e-6, err_msg=slot)


def test_plain_adamw_bf16_param_keeps_fp32_moments():
    a = _adam_inputs((50, 40), 3)
    t = {k: torch.from_numpy(x.copy()) for k, x in a.items()}
    pb, gb = t["p"].bfloat16(), t["g"].bfloat16()
    got = fad.plain_fused_adamw(pb, gb, t["m"], t["v"], t["lr"], 0.9, 0.999,
                                1e-8, 0.01, t["b1p"], t["b2p"])
    ref = fad.plain_fused_adamw(pb.float(), gb.float(), t["m"], t["v"],
                                t["lr"], 0.9, 0.999, 1e-8, 0.01, t["b1p"],
                                t["b2p"])
    assert got[0].dtype == torch.bfloat16
    assert got[1].dtype == got[2].dtype == torch.float32
    assert torch.equal(got[0], ref[0].bfloat16())
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])


def test_every_kernel_has_a_source_a_module_and_a_counter():
    assert set(kernels.MODULES) == set(_build.SOURCES)
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == {n: 0 for n in _build.SOURCES}
    # CPU calls take the plain versions and count nothing
    q = torch.zeros(1, 8, 64)
    out, lse = fa.packed_flash_fwd(q, q, q, 1, 0.1, False)
    fa.packed_flash_bwd(q, q, q, out, lse, q, 1, 0.1, False)
    one = torch.ones(1)
    fad.fused_adamw_(torch.zeros(4), torch.zeros(4), torch.zeros(4),
                     torch.zeros(4), one, 0.9, 0.999, 1e-8, 0.01, one, one)
    assert not any(kernels.launch_counts().values())
