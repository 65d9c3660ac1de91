"""The tensor-core arithmetic of the int8 GEMM kernel, from the CPU.

``csrc/int8_gemm.cu`` runs ``act((x @ float(w8)) * scale + bias)`` (x fp32,
w8 int8) on the bf16 tensor cores: each int8 weight becomes bf16 through a
byte permute into the mantissa of 2^23 and one fp32 subtract, and each fp32
activation is cut into three bf16 pieces by truncation (hi = the top 16
bits of x, mid = the top 16 bits of x - hi, lo = x - hi - mid), so three
bf16 products into one fp32 accumulator, lo first, give the fp32 product.
The kernel runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Here, with numpy bit operations on the CPU:

* every int8 value through the kernel's byte-permute conversion is the
  same value in bf16, exactly;
* hi + mid + lo reconstructs x exactly for every |x| >= 2^-110 and within
  2^-133 below, on random values and on the edges: +-0, powers of two,
  bf16 rounding ties, the smallest normals, subnormals and the largest
  finite values (where rounding hi to nearest would overflow to inf: the
  reason the pieces truncate);
* the three-piece product accumulated in fp32 in the kernel's order (per
  16-deep step lo, mid, hi; the K slices of the plan added in rank
  order) against the JAX package's ``int8_weight_only_gemm``, on its stock
  route and its Pallas kernel in interpret mode, within the card's gate
  (rtol 1e-4, atol 1e-5 max|ref| + 1e-5) at M = 8, K = 1024, N = 4096 and
  at small ragged shapes; hi alone misses the gate;
* ``plan`` is a pure function of (M, N, K) whose slices cover K exactly,
  none empty, in whole slabs of the instance, over at most one portable
  cluster, with K whole at M >= 512 (hypothesis over M, N and K).
"""

import contextlib
import importlib
import os

import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from paddle_tpu_torch.kernels import int8_gemm as ig

jax_gemm = importlib.import_module("paddle_tpu.ops.pallas.int8_gemm")

MAGIC = np.float32(8388736.0)     # 2^23 + 128


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
    """The int8 GEMM launch site hands float counts to
    ``pl.CostEstimate``, which this jax version rejects before the kernel
    runs; coerce them to ints inside the test (the estimate is a
    scheduling hint; the JAX package stays unchanged)."""
    from jax.experimental import pallas as pl

    orig = pl.CostEstimate
    monkeypatch.setattr(pl, "CostEstimate", lambda **kw: orig(
        **{k: int(v) for k, v in kw.items()}))


def byte_perm(x, y, s):
    """CUDA's __byte_perm on uint32 arrays: result byte i is byte
    (s >> 4 i) & 7 of the eight bytes {y, x} (x bytes 0-3, y 4-7)."""
    x, y = np.asarray(x, np.uint64), np.asarray(y, np.uint64)
    both = x | (y << np.uint64(32))
    out = np.zeros(np.broadcast(x, y).shape, np.uint64)
    for i in range(4):
        sel = np.uint64((s >> (4 * i)) & 7)
        out |= ((both >> (sel * np.uint64(8))) & np.uint64(0xFF)) \
            << np.uint64(8 * i)
    return out.astype(np.uint32)


def _f(bits):
    return np.asarray(bits, np.uint32).view(np.float32)


def _u(x):
    return np.asarray(x, np.float32).view(np.uint32)


def s8x4_to_bf16(words):
    """The kernel's s8x4_to_bf16 on packed int8 words: two bf16 pairs."""
    u = words ^ np.uint32(0x80808080)
    f = [_f(byte_perm(u, 0x4B000000, sel)) - MAGIC
         for sel in (0x7650, 0x7651, 0x7652, 0x7653)]
    return (byte_perm(_u(f[0]), _u(f[1]), 0x7632),
            byte_perm(_u(f[2]), _u(f[3]), 0x7632))


def bf16_pairs_to_float(pair):
    """bf16 pairs (low half first) -> their two values as fp32."""
    lo = _f((pair & np.uint32(0xFFFF)) << np.uint32(16))
    hi = _f(pair & np.uint32(0xFFFF0000))
    return lo, hi


def split3(x):
    """The kernel's three pieces of fp32 x, each an fp32 array holding a
    bf16 value (low 16 bits zero): hi, mid, lo."""
    x = np.asarray(x, np.float32)
    hi = _f(_u(x) & np.uint32(0xFFFF0000))
    r = x - hi
    mid = _f(_u(r) & np.uint32(0xFFFF0000))
    s = r - mid
    lo = _f(_u(s) & np.uint32(0xFFFF0000))
    return hi, mid, lo


def test_every_int8_value_is_exact_in_bf16_through_the_byte_permute():
    vals = np.arange(-128, 128, dtype=np.int8)
    words = vals.view(np.uint8).reshape(-1, 4).copy().view(np.uint32)[:, 0]
    p01, p23 = s8x4_to_bf16(words)
    got = np.stack(bf16_pairs_to_float(p01) + bf16_pairs_to_float(p23),
                   axis=1).reshape(-1)
    np.testing.assert_array_equal(got, vals.astype(np.float32))
    # and as bf16 values: the bits are those of bf16(b)
    want_bits = vals.astype(ml_dtypes.bfloat16).view(np.uint16)
    got_bits = np.stack([p01 & 0xFFFF, p01 >> 16, p23 & 0xFFFF, p23 >> 16],
                        axis=1).reshape(-1).astype(np.uint16)
    np.testing.assert_array_equal(got_bits, want_bits)


def _edge_values():
    e = [0.0, -0.0]
    e += [s * 2.0 ** p for p in range(-126, 128) for s in (1.0, -1.0)]
    finfo = np.finfo(np.float32)
    e += [finfo.max, -finfo.max, finfo.tiny, -finfo.tiny,
          np.nextafter(finfo.tiny, np.float32(1)), finfo.smallest_subnormal,
          -finfo.smallest_subnormal, 2.0 ** -110, 2.0 ** -111, 2.0 ** -133]
    # bf16 rounding ties: the low 16 bits exactly 0x8000, around 1 and
    # near the top and bottom of the range
    for top in (0x3F80, 0x3F81, 0x7F7F, 0x0080, 0xBF80, 0xFF7F):
        e.append(_f(np.uint32(top << 16 | 0x8000)))
    # every low-16-bit pattern that separates the pieces
    e += list(_f(np.uint32(0x3F800000) | np.arange(0, 1 << 16, 257,
                                                   dtype=np.uint32)))
    return np.array(e, np.float32)


@pytest.mark.parametrize("which", ["random", "edges"])
def test_three_pieces_reconstruct_x(which):
    if which == "random":
        rng = np.random.RandomState(0)
        x = np.concatenate([
            rng.randn(100000).astype(np.float32),
            (rng.randn(20000) * 10.0 ** rng.randint(-30, 30, 20000))
            .astype(np.float32),
            _f(rng.randint(0, 2 ** 32, 50000, dtype=np.uint64)
               .astype(np.uint32))])
        x = x[np.isfinite(x)]
    else:
        x = _edge_values()
    hi, mid, lo = split3(x)
    for piece in (hi, mid, lo):   # each piece is a bf16 value
        assert not (_u(piece) & np.uint32(0xFFFF)).any()
        assert np.isfinite(piece).all()
    err = np.abs(hi.astype(np.float64) + mid + lo - x.astype(np.float64))
    big = np.abs(x.astype(np.float64)) >= 2.0 ** -110
    assert (err[big] == 0).all()
    assert (err[~big] <= 2.0 ** -133).all()


def test_rounding_the_largest_values_to_nearest_would_overflow():
    """Why the pieces truncate: round to nearest takes the largest finite
    fp32 values to inf in bf16, and x - hi is then not finite."""
    top = np.array([np.finfo(np.float32).max], np.float32)
    assert np.isinf(top.astype(ml_dtypes.bfloat16).astype(np.float32)).all()
    hi, mid, lo = split3(top)
    assert float(hi[0]) + float(mid[0]) + float(lo[0]) == float(top[0])


def emulated_gemm(x, w8, scale, bias, act, pieces=("lo", "mid", "hi")):
    """The kernel's arithmetic: per K slice of the plan, per 16-deep step,
    each piece's 16-term product (exact: 8 x 8 bits, summed here in
    float64) added to the fp32 accumulator in the order given; the slices'
    sums added in rank order; then the epilogue in fp32, scale then
    bias."""
    m, k = x.shape
    _, _, ksplit, kc = ig.plan(m, w8.shape[1], k)
    parts = dict(zip(("hi", "mid", "lo"), split3(x)))
    wf = w8.astype(np.float64)
    total = None
    for z in range(ksplit):
        acc = np.zeros((m, w8.shape[1]), np.float32)
        for k0 in range(z * kc, min(k, (z + 1) * kc), 16):
            ks = slice(k0, min(k, k0 + 16))
            for p in pieces:
                acc = (acc + parts[p][:, ks].astype(np.float64) @ wf[ks]) \
                    .astype(np.float32)
        total = acc if total is None else (total + acc).astype(np.float32)
    out = (total * scale).astype(np.float32)
    if bias is not None:
        out = (out + bias).astype(np.float32)
    if act == "relu":
        out = np.maximum(out, 0)
    return out


def _case(m, k, n, seed, with_bias=True):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    w8 = rng.randint(-127, 128, (k, n)).astype(np.int8)
    sc = ((rng.rand(n) + 0.5) / 127.0).astype(np.float32)
    b = rng.randn(n).astype(np.float32) if with_bias else None
    return x, w8, sc, b


def _within_gate(got, ref):
    atol = 1e-5 * float(np.abs(ref).max()) + 1e-5
    return bool(np.all(np.abs(got.astype(np.float64) - ref)
                       <= atol + 1e-4 * np.abs(ref)))


@pytest.mark.parametrize("mode", ["interpret", "off"])
@pytest.mark.parametrize("m,k,n,act", [
    (8, 1024, 4096, "relu"), (13, 100, 70, None), (33, 33, 130, "relu"),
    (130, 64, 16, None)])
def test_three_piece_product_matches_the_jax_package(mode, m, k, n, act):
    x, w8, sc, b = _case(m, k, n, m + k + n)
    with _pallas(mode):
        want = np.asarray(jax_gemm.int8_weight_only_gemm(x, w8, sc, bias=b,
                                                         act=act))
    got = emulated_gemm(x, w8, sc, b, act)
    assert _within_gate(got, want.astype(np.float64))
    # and the plain version the card holds the kernel to
    plain = ig.plain_int8_gemm(torch.from_numpy(x), torch.from_numpy(w8),
                               torch.from_numpy(sc), torch.from_numpy(b)
                               if b is not None else None, act).numpy()
    assert _within_gate(got, plain.astype(np.float64))


def test_hi_alone_misses_the_gate():
    x, w8, sc, b = _case(8, 1024, 256, 5)
    want = np.asarray(jax_gemm.stock_int8_gemm(x, w8, sc, b, None))
    assert _within_gate(emulated_gemm(x, w8, sc, b, None), want)
    assert not _within_gate(emulated_gemm(x, w8, sc, b, None,
                                          pieces=("hi",)), want)


@settings(max_examples=300, deadline=None)
@given(m=st.integers(1, 4096), n=st.integers(1, 70000),
       k=st.integers(1, 70000))
def test_plan_is_a_pure_function_that_covers_k(m, n, k):
    inst, tile, ksplit, kc = ig.plan(m, n, k)
    # the cache serves what the function itself gives
    assert ig.plan.__wrapped__(m, n, k) == (inst, tile, ksplit, kc)
    assert (ksplit - 1) * kc < k <= ksplit * kc
    assert 1 <= ksplit <= ig.MAX_CLUSTER
    if m > ig.DECODE_M:
        assert inst == "prefill" and tile in (64, 128)
        assert kc % ig.PREFILL_BK == 0
        if m >= 512 or tile == 128:    # K whole
            assert ksplit == 1
    else:
        assert inst == "decode" and tile == ig.DECODE_BN
        assert kc % ig.DECODE_BK == 0
