"""The plain PyTorch version of each ported kernel, held against the JAX
package's Pallas kernel run in interpret mode (``PT_PALLAS=interpret``)
and, for paged attention and the int8 GEMM, against its stock route too.

* flash forward: ``plain_packed_flash_fwd`` vs ``_packed_fwd_kernel``
  (packed route, S <= 512, (n*hd) % 128 == 0) and vs the 2-pass
  ``_fwd_kernel`` (bnsd route, S = 1024): out AND lse, causal, with and
  without a key bias;
* paged attention: ``plain_paged_attention`` vs ``_pa_kernel`` with
  partial pages, empty slots on scratch page 0, and stale positions
  poisoned with large finite values;
* int8 GEMM: ``plain_int8_gemm`` vs ``_gemm_kernel`` with bias/relu
  variants and ragged shapes.

Tolerance: fp32, ``rtol=atol=1e-5`` (summation order differs). The
wrappers' CPU/meta routing is checked here too; the CUDA kernels
themselves run in tests/test_torch_cuda.py and chip_smoke.py on the card.
"""

import contextlib
import importlib
import os

import numpy as np
import pytest
import torch

# the package re-exports a function named flash_attention over the module
jax_flash = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
jax_gemm = importlib.import_module("paddle_tpu.ops.pallas.int8_gemm")
jax_paged = importlib.import_module("paddle_tpu.ops.pallas.paged_attention")

from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import _build, conv_bn_relu, layer_norm
from paddle_tpu_torch.kernels.flash_attention import (packed_flash_fwd,
                                                      plain_packed_flash_fwd)
from paddle_tpu_torch.kernels.int8_gemm import (int8_weight_only_gemm,
                                                plain_int8_gemm)
from paddle_tpu_torch.kernels.paged_attention import (paged_decode_attention,
                                                      plain_paged_attention)

torch.set_num_threads(2)

RTOL = ATOL = 1e-5


@contextlib.contextmanager
def _pallas(mode):
    old = os.environ.get("PT_PALLAS")
    os.environ["PT_PALLAS"] = mode
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("PT_PALLAS", None)
        else:
            os.environ["PT_PALLAS"] = old


@pytest.fixture(autouse=True)
def _int_cost_estimates(monkeypatch):
    """The paged-attention and int8 GEMM launch sites hand float counts
    to ``pl.CostEstimate``, which this jax version rejects before the
    kernel runs. The estimate is only a scheduling hint: coerce it to
    ints for these tests so the Pallas kernels run in interpret mode as
    written (the JAX package itself stays unchanged)."""
    from jax.experimental import pallas as pl

    orig = pl.CostEstimate
    monkeypatch.setattr(pl, "CostEstimate", lambda **kw: orig(
        **{k: int(v) for k, v in kw.items()}))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# flash forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,bias", [(64, False), (40, False), (128, True),
                                    (512, False)])
def test_flash_plain_vs_packed_pallas_kernel(s, bias):
    """The prefill's route for buckets <= 512 (_packed_fwd_kernel)."""
    rng = np.random.RandomState(s)
    n, hd = 2, 64
    q, k, v = (rng.randn(2, s, n * hd).astype(np.float32) for _ in range(3))
    kb = None
    if bias:
        kb = np.where(rng.rand(2, s) < 0.25, -1e9, 0.0).astype(np.float32)
        kb[:, 0] = 0.0
    with _pallas("interpret"):
        ok, route, _ = jax_flash._packed_fast_applies(q, k, kb, n)
        assert ok and route == "pallas_interpret"
        out, lse = jax_flash.flash_attention_fwd_lse(
            q, k, v, bias=kb, causal=True, scale=hd ** -0.5, num_heads=n)
    got_out, got_lse = plain_packed_flash_fwd(
        _t(q), _t(k), _t(v), n, hd ** -0.5, True,
        None if kb is None else _t(kb))
    _close(got_out, out)
    _close(got_lse, lse)


def test_flash_plain_vs_two_pass_pallas_kernel():
    """The prefill's route for buckets 1024/2048 (bnsd _fwd_kernel)."""
    rng = np.random.RandomState(1)
    s, hd = 1024, 64
    q4, k4, v4 = (rng.randn(1, 1, s, hd).astype(np.float32)
                  for _ in range(3))
    with _pallas("interpret"):
        assert jax_flash._dispatch_plan(q4, k4, None)[0] == \
            "pallas_interpret"
        out, lse = jax_flash.flash_attention_fwd_lse(
            q4, k4, v4, causal=True, scale=hd ** -0.5)
    packed = [_t(t.reshape(1, s, hd)) for t in (q4, k4, v4)]
    got_out, got_lse = plain_packed_flash_fwd(*packed, 1, hd ** -0.5, True)
    _close(got_out, np.asarray(out).reshape(1, s, hd))
    _close(got_lse, lse)


def test_flash_plain_non_causal_and_cross_lengths():
    """Sq != Sk (bottom-right causal alignment) and the non-causal case,
    against the JAX reference attention."""
    rng = np.random.RandomState(2)
    n, hd = 2, 16
    q = rng.randn(1, 5, n * hd).astype(np.float32)
    k, v = (rng.randn(1, 9, n * hd).astype(np.float32) for _ in range(2))
    for causal in (True, False):
        want = jax_flash.reference_attention(
            jax_flash._packed_to_bnsd(q, n), jax_flash._packed_to_bnsd(k, n),
            jax_flash._packed_to_bnsd(v, n), causal=causal,
            scale=hd ** -0.5)
        got, _ = plain_packed_flash_fwd(_t(q), _t(k), _t(v), n, hd ** -0.5,
                                        causal)
        _close(got, jax_flash._bnsd_to_packed(want))


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------

def _paged_case(rng, pos, n=4, hd=32, page=8, mp=6, npages=24):
    b = len(pos)
    pool_k = rng.randn(npages, page, n * hd).astype(np.float32)
    pool_v = rng.randn(npages, page, n * hd).astype(np.float32)
    table = np.zeros((b, mp), np.int32)
    nxt = 1
    for i, p in enumerate(pos):
        if p < 0:
            continue            # empty slot: zero table, position 0
        need = p // page + 1
        table[i, :need] = np.arange(nxt, nxt + need)
        nxt += need
        # stale tail of the row's last page: large finite poison that
        # must get weight exactly 0
        last = table[i, p // page]
        pool_k[last, p % page + 1:] = 3e4
        pool_v[last, p % page + 1:] = 1e6
    pos = np.maximum(np.asarray(pos, np.int32), 0)
    q = rng.randn(b, n * hd).astype(np.float32)
    return q, pool_k, pool_v, table, pos, n, hd


@pytest.mark.parametrize("mode", ["interpret", "off"])
@pytest.mark.parametrize("pos", [[0, 7, 8, 44], [13, -1, -1, 47], [3]])
def test_paged_plain_vs_pallas_kernel(mode, pos):
    rng = np.random.RandomState(sum(pos) + len(mode))
    q, pk, pv, table, p, n, hd = _paged_case(rng, pos)
    with _pallas(mode):
        want = jax_paged.paged_decode_attention(q, pk, pv, table, p, n, hd,
                                                hd ** -0.5)
    got = plain_paged_attention(_t(q), _t(pk), _t(pv), _t(table), _t(p), n,
                                hd, hd ** -0.5)
    _close(got, want)
    assert np.abs(got.numpy()).max() < 100.0   # the poison got no weight


# ---------------------------------------------------------------------------
# int8 GEMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["interpret", "off"])
@pytest.mark.parametrize("m,k,n,bias,act", [
    (8, 128, 256, True, None), (8, 128, 256, True, "relu"),
    (37, 96, 200, False, None), (130, 64, 128, False, "relu")])
def test_int8_plain_vs_pallas_kernel(mode, m, k, n, bias, act):
    rng = np.random.RandomState(m + k + n)
    x = rng.randn(m, k).astype(np.float32)
    w8 = rng.randint(-127, 128, (k, n)).astype(np.int8)
    sc = ((rng.rand(n) + 0.5) / 127.0).astype(np.float32)
    b = rng.randn(n).astype(np.float32) if bias else None
    with _pallas(mode):
        want = jax_gemm.int8_weight_only_gemm(x, w8, sc, bias=b, act=act)
    got = plain_int8_gemm(_t(x), _t(w8), _t(sc),
                          None if b is None else _t(b), act)
    _close(got, want)


# ---------------------------------------------------------------------------
# wrapper routing: CPU and meta take the plain version, nothing builds
# ---------------------------------------------------------------------------

def test_wrappers_take_plain_route_on_cpu_and_meta(monkeypatch):
    def no_build(name):
        raise AssertionError(f"tried to build {name} on the CPU")

    monkeypatch.setattr(_build, "load", no_build)
    kernels.reset_launch_counts()
    rng = np.random.RandomState(4)
    q, pk, pv, table, p, n, hd = _paged_case(rng, [5, 20])
    out = paged_decode_attention(_t(q), _t(pk), _t(pv), _t(table), _t(p),
                                 n, hd, 0.1)
    assert out.shape == (2, n * hd)
    x = torch.randn(3, 4, 64)
    w8 = torch.randint(-127, 128, (64, 32), dtype=torch.int8)
    y = int8_weight_only_gemm(x, w8, torch.rand(32), act="relu")
    assert y.shape == (3, 4, 32) and (y >= 0).all()
    o, lse = packed_flash_fwd(torch.randn(1, 16, 64), torch.randn(1, 16, 64),
                              torch.randn(1, 16, 64), 2, 0.1, True)
    assert o.shape == (1, 16, 64) and lse.shape == (1, 2, 16)
    meta = packed_flash_fwd(*(torch.empty(2, 48, 128, device="meta")
                              for _ in range(3)), 2, 0.1, True)
    assert meta[0].is_meta and meta[1].shape == (2, 2, 48)
    y, mean, rstd = layer_norm.layer_norm_fwd(torch.randn(5, 64), None, None,
                                              1e-5)
    assert y.shape == (5, 64) and mean.shape == rstd.shape == (5,)
    c = conv_bn_relu.conv_bn_relu(
        torch.randn(1, 6, 6, 16).bfloat16(),
        torch.randn(3, 3, 16, 8).bfloat16(), torch.ones(8), torch.zeros(8))
    assert c.shape == (1, 4, 4, 8) and (c >= 0).all()
    assert kernels.launch_counts() == {
        "flash_attention_fwd": 0, "paged_attention": 0, "int8_gemm": 0,
        "flash_attention_bwd": 0, "fused_adamw": 0, "layer_norm": 0,
        "conv_bn_relu": 0}


def test_kernel_sources_and_build_flags():
    """Every kernel module has its CUDA source, built for sm_90a."""
    for name in _build.SOURCES:
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert "extern \"C\" int pt_" in src
        assert "cudaGetLastError" in src
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert set(kernels.MODULES) == set(_build.SOURCES)
