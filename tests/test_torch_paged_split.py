"""The paged-attention kernel's plan on the CPU: each row's context cut
into fixed chunks (``chunk_plan``), each chunk's max, sum and
unnormalised output combined in chunk order (``chunked_paged_attention``,
the kernel's algorithm in plain PyTorch), held against

* ``plain_paged_attention`` (the port's plain version);
* the reference's Pallas kernel ``_pa_kernel`` in interpret mode with its
  chunk flag at the emulation's chunk (``pallas_kv_chunk_tokens``), which
  takes the reference's own online-softmax route across chunks;
* the reference's ``stock_paged_attention``.

Cases: pos 0, pos on a page boundary, on a chunk boundary, the maximal
context, and the stale tail of each row's last page poisoned with large
finite values that must get weight exactly 0. fp32, ``rtol = atol =
1e-5``: the three sum in different orders. Also: a row's plan is a
function of its own pos, so a row alone gives the same bits as the row in
a batch, and the Python plan's chunk is the CUDA source's.
"""

import importlib
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu.core import flags

from paddle_tpu_torch.kernels import paged_attention as pa

jax_paged = importlib.import_module("paddle_tpu.ops.pallas.paged_attention")

torch.set_num_threads(2)

RTOL = ATOL = 1e-5


@pytest.fixture(autouse=True)
def _int_cost_estimates(monkeypatch):
    """The reference's launch site hands float counts to
    ``pl.CostEstimate``, which this jax version rejects before the kernel
    runs; the estimate is only a scheduling hint, so it is coerced to ints
    inside the test (the JAX package stays as it is)."""
    from jax.experimental import pallas as pl

    orig = pl.CostEstimate
    monkeypatch.setattr(pl, "CostEstimate", lambda **kw: orig(
        **{k: int(v) for k, v in kw.items()}))


def _case(seed, pos, n=2, hd=32, page=8, mp=6):
    """Pools with each row's pages in order from page 1 and the stale
    tail of its last page poisoned (k 3e4, v 1e6)."""
    rng = np.random.RandomState(seed)
    b = len(pos)
    npages = 1 + sum(p // page + 1 for p in pos)
    pool_k = rng.randn(npages, page, n * hd).astype(np.float32)
    pool_v = rng.randn(npages, page, n * hd).astype(np.float32)
    table = np.zeros((b, mp), np.int32)
    nxt = 1
    for i, p in enumerate(pos):
        need = p // page + 1
        table[i, :need] = np.arange(nxt, nxt + need)
        nxt += need
        last = table[i, p // page]
        pool_k[last, p % page + 1:] = 3e4
        pool_v[last, p % page + 1:] = 1e6
    q = rng.randn(b, n * hd).astype(np.float32)
    return q, pool_k, pool_v, table, np.asarray(pos, np.int32), n, hd


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# page 8, 6 pages a row (48 tokens), chunks of 16: pos 0, a page boundary
# (7, 8), chunk boundaries (15, 16, 31, 32), the maximal context (47)
SMALL = [[0, 7, 8, 47], [15, 16, 31, 32], [47], [3, 0, 40]]


@pytest.mark.parametrize("pos", SMALL)
def test_chunked_plan_matches_plain_pallas_and_stock(pos, monkeypatch):
    q, pk, pv, table, p, n, hd = _case(sum(pos), pos)
    scale = hd ** -0.5
    got = pa.chunked_paged_attention(_t(q), _t(pk), _t(pv), _t(table), _t(p),
                                     n, hd, scale, chunk=16)
    monkeypatch.setenv("PT_PALLAS", "interpret")
    with flags.overrides(pallas_kv_chunk_tokens=16):
        pallas = jax_paged.paged_decode_attention(q, pk, pv, table, p, n, hd,
                                                  scale)
    stock = jax_paged.stock_paged_attention(q, pk, pv, table, p, n, hd,
                                            scale)
    plain = pa.plain_paged_attention(_t(q), _t(pk), _t(pv), _t(table), _t(p),
                                     n, hd, scale)
    _close(got, pallas)
    _close(got, stock)
    _close(got, plain)
    assert float(got.abs().max()) < 100.0    # the poison got no weight


# the kernel's own chunk, CHUNK_TOKENS = 128: page 16, 48 pages a row (768
# tokens, six chunks): pos 0, page and chunk boundaries, the maximal
# context
FULL = [[0, 15, 16, 767], [255, 256, 511, 512]]


@pytest.mark.parametrize("pos", FULL)
def test_kernel_chunk_matches_plain_and_stock(pos):
    q, pk, pv, table, p, n, hd = _case(len(pos) + pos[-1], pos, page=16,
                                       mp=48)
    scale = hd ** -0.5
    got = pa.chunked_paged_attention(_t(q), _t(pk), _t(pv), _t(table), _t(p),
                                     n, hd, scale)
    stock = jax_paged.stock_paged_attention(q, pk, pv, table, p, n, hd,
                                            scale)
    plain = pa.plain_paged_attention(_t(q), _t(pk), _t(pv), _t(table), _t(p),
                                     n, hd, scale)
    _close(got, stock)
    _close(got, plain)
    assert float(got.abs().max()) < 100.0


def test_plan_is_a_function_of_the_rows_own_pos():
    """The plan's chunks start at multiples of the chunk, cover 0..pos
    once (clamped to the context), and take nothing but pos and the
    context; a row alone gives the same bits as the row in a batch whose
    other rows hold other positions and other data."""
    chunk = pa.CHUNK_TOKENS
    for ctx in (48, 768, 2048):
        for pos in range(0, ctx + 3, 5):
            plan = pa.chunk_plan(pos, ctx)
            assert plan[0][0] == 0 and plan[-1][1] == min(pos + 1, ctx)
            assert all(a == i * chunk and 0 < b - a <= chunk
                       for i, (a, b) in enumerate(plan))
            assert all(plan[i][1] == plan[i + 1][0]
                       for i in range(len(plan) - 1))
    pos = [600, 5, 767, 256]
    q, pk, pv, table, p, n, hd = _case(9, pos, page=16, mp=48)
    batch = pa.chunked_paged_attention(_t(q), _t(pk), _t(pv), _t(table),
                                       _t(p), n, hd, 0.2)
    for i in range(len(pos)):
        alone = pa.chunked_paged_attention(
            _t(q[i:i + 1]), _t(pk), _t(pv), _t(table[i:i + 1]),
            _t(p[i:i + 1]), n, hd, 0.2)
        assert torch.equal(alone[0], batch[i])


def test_python_chunk_is_the_kernels():
    src = (Path(pa.__file__).resolve().parents[1] / "csrc" /
           "paged_attention.cu").read_text()
    m = re.search(r"constexpr int CHUNK = (\d+);", src)
    assert m and int(m.group(1)) == pa.CHUNK_TOKENS
