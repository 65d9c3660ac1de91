"""The addressing and arithmetic of the tensor-core conv kernel, from the
CPU.

``csrc/conv_bn_relu.cu`` is an implicit GEMM on the bf16 tensor cores:
M = N*H*W output pixels in tiles of 128, Co in tiles of 128, K = 9*C
walked tap by tap in chunks of 64 channels. Each thread copies one
16-byte chunk (8 channels) of 4 fixed rows of the A tile, from an offset
into the padded input ``xp`` that it computes once per row (the pixel's
top-left tap) plus a per-chunk tap offset; rows past M and channels past C
are zero-filled. The kernel runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``). Here, in numpy on the
CPU:

* the A-tile gather: pixel index -> ``xp`` offset for every tap and
  chunk, on tiles that cross image rows and images and on the ragged last
  tile, read from an ``xp`` of distinct values, equals the shifted window
  the convolution reads;
* the kernel's whole product emulated tile by tile (gathered A, the
  weight's zero-filled B tile, fp32 sums, the epilogue's fp32 multiply
  then add, ReLU, one rounding to bf16) against ``plain_conv_bn_relu``
  at small shapes (C = 16, 48, 80: chunks past C; Co = 4, 68, 132: the
  weight's padded row and a ragged channel tile) and against the JAX tool's
  ``_conv_kernel`` in interpret mode at its own shape (14x14, 256 -> 256,
  N = 2): one bf16 ulp (2^-7 relative) + 1e-3, the card's gate.
"""

import functools
import importlib
import os
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import conv_bn_relu as pcbr

torch.set_num_threads(2)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
BM, BN, BK, THREADS = 128, 128, 64, 256    # csrc/conv_bn_relu.cu
BF16_TOL = dict(rtol=2 ** -7, atol=1e-3)


def a_offsets(m0, n_img, h, w, c):
    """The kernel's a_off for the 4 rows each of the 256 threads copies
    in the tile at pixel m0: {row in tile: offset of its tap-(0, 0) pixel
    in xp, or -1 past M}."""
    m_total = n_img * h * w
    out = {}
    for tid in range(THREADS):
        for i in range(4):
            r = (tid >> 3) + 32 * i
            m = m0 + r
            off = -1
            if m < m_total:
                img = m // (h * w)
                rem = m - img * h * w
                y, x = rem // w, rem - (rem // w) * w
                off = ((img * (h + 2) + y) * (w + 2) + x) * c
            assert out.setdefault(r, off) == off   # same row, same offset
    return out


def gathered_a(xp_flat, offs, kt, h, w, c):
    """The A tile of chunk kt as the kernel's copies fill it: [128, 64],
    zero past M and past C."""
    nch = -(-c // BK)
    tap, c0 = kt // nch, (kt % nch) * BK
    ky, kx = tap // 3, tap % 3
    tile = np.zeros((BM, BK), xp_flat.dtype)
    for r, off in offs.items():
        for ac in range(8):
            if off < 0 or c0 + 8 * ac >= c:
                continue
            src = off + (ky * (w + 2) + kx) * c + c0 + 8 * ac
            tile[r, 8 * ac:8 * ac + 8] = xp_flat[src:src + 8]
    return tile


@pytest.mark.parametrize("n_img,h,w,c", [
    (3, 5, 7, 16),      # M = 105: one ragged tile over three images
    (2, 14, 14, 80),    # M = 392: tiles cross rows and images, C % 64 != 0
    (1, 3, 50, 48)])    # 50-pixel image rows: a tile spans three of them
def test_a_tile_gather_reads_the_shifted_windows(n_img, h, w, c):
    xp = np.arange(n_img * (h + 2) * (w + 2) * c, dtype=np.int64) \
        .reshape(n_img, h + 2, w + 2, c)
    flat = xp.reshape(-1)
    m_total = n_img * h * w
    nch = -(-c // BK)
    for m0 in range(0, m_total, BM):
        offs = a_offsets(m0, n_img, h, w, c)
        for kt in range(9 * nch):
            tap, c0 = kt // nch, (kt % nch) * BK
            ky, kx = tap // 3, tap % 3
            got = gathered_a(flat, offs, kt, h, w, c)
            want = np.zeros((BM, BK), np.int64)
            for r in range(BM):
                m = m0 + r
                if m >= m_total:
                    continue
                img, rem = divmod(m, h * w)
                y, x = divmod(rem, w)
                cs = slice(c0, min(c, c0 + BK))
                want[r, :cs.stop - c0] = xp[img, y + ky, x + kx, cs]
            np.testing.assert_array_equal(got, want)


def _bf16(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16) \
        .astype(np.float32)


def emulated_conv(xp, w, scale, shift):
    """The kernel on float32 arrays holding bf16 values: xp [N, H+2, W+2,
    C], w [3, 3, C, Co]. Tile by tile: the gathered A, the zero-filled B
    (the weight's row padded to a multiple of 8), the fp32 sum over the
    9 * ceil(C / 64) chunks, then relu(acc * scale + shift) rounded once."""
    n_img, hp, wp, c = xp.shape
    h, wd, co = hp - 2, wp - 2, w.shape[-1]
    ldo = -(-co // 8) * 8
    wpad = np.zeros((3, 3, c, ldo), np.float32)
    wpad[..., :co] = w
    wflat = wpad.reshape(9 * c, ldo)
    flat = xp.reshape(-1)
    nch = -(-c // BK)
    m_total = n_img * h * wd
    out = np.zeros((m_total, co), np.float32)
    for m0 in range(0, m_total, BM):
        offs = a_offsets(m0, n_img, h, wd, c)
        for o0 in range(0, co, BN):
            acc = np.zeros((BM, BN), np.float32)
            for kt in range(9 * nch):
                tap, c0 = kt // nch, (kt % nch) * BK
                a = gathered_a(flat, offs, kt, h, wd, c)
                b = np.zeros((BK, BN), np.float32)
                rows = wflat[tap * c + c0:tap * c + min(c, c0 + BK),
                             o0:min(ldo, o0 + BN)]
                b[:rows.shape[0], :rows.shape[1]] = rows
                acc = (acc + a.astype(np.float64) @ b).astype(np.float32)
            rows, cols = min(BM, m_total - m0), min(BN, co - o0)
            y = acc[:rows, :cols] * scale[o0:o0 + cols]
            y = (y.astype(np.float32) + shift[o0:o0 + cols]) \
                .astype(np.float32)
            out[m0:m0 + rows, o0:o0 + cols] = np.maximum(y, 0)
    return _bf16(out).reshape(n_img, h, wd, co)


def _case(n, h, w, c, co, seed):
    rng = np.random.RandomState(seed)
    x = _bf16(rng.randn(n, h, w, c) * 0.5)
    xp = np.pad(x, [(0, 0), (1, 1), (1, 1), (0, 0)])
    wt = _bf16(rng.randn(3, 3, c, co) * 0.05)
    scale = (rng.randn(co) * 0.1 + 1.0).astype(np.float32)
    shift = (rng.randn(co) * 0.1).astype(np.float32)
    return xp, wt, scale, shift


@pytest.mark.parametrize("n,h,w,c,co", [
    (3, 7, 9, 16, 4), (1, 5, 5, 32, 68), (5, 3, 3, 48, 132),
    (2, 6, 11, 80, 136)])
def test_emulated_kernel_matches_the_plain_version(n, h, w, c, co):
    xp, wt, scale, shift = _case(n, h, w, c, co, n * h + co)
    got = emulated_conv(xp, wt, scale, shift)
    want = pcbr.plain_conv_bn_relu(
        torch.from_numpy(xp).bfloat16(), torch.from_numpy(wt).bfloat16(),
        torch.from_numpy(scale), torch.from_numpy(shift)).float().numpy()
    np.testing.assert_allclose(got, want, **BF16_TOL)
    assert float((want > 0).mean()) > 0.3


def test_emulated_kernel_matches_the_tpu_kernel_in_interpret_mode(
        monkeypatch):
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    monkeypatch.syspath_prepend(TOOLS)
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    tool = importlib.import_module("exp_pallas_conv")
    xp, wt, scale, shift = _case(2, tool.H, tool.W, tool.C, tool.CO, 0)
    want = np.asarray(tool.pallas_conv_bn_relu(
        jnp.asarray(xp.astype(ml_dtypes.bfloat16)),
        jnp.asarray(wt.astype(ml_dtypes.bfloat16)), jnp.asarray(scale),
        jnp.asarray(shift), bn=2)).astype(np.float32)
    got = emulated_conv(xp, wt, scale, shift)
    np.testing.assert_allclose(got, want, **BF16_TOL)
    sys.modules.pop("exp_pallas_conv", None)


def test_tensor_core_sources_share_one_header_and_its_build_hash(
        tmp_path, monkeypatch):
    """The conv and int8 GEMM sources are wgmma kernels on the shared
    header (no CUDA-core kernel left), and an edit of the header renames
    every library that includes it, so none loads a stale build."""
    import shutil

    from paddle_tpu_torch.kernels import _build

    for name, gone in (("conv_bn_relu", ("conv_bn_relu_kernel", "fmaf(")),
                       ("int8_gemm", ("splitk_epilogue_kernel",
                                      "int8_gemm_kernel", "fmaf("))):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "wgmma.cuh"' in src
        assert all(g not in src for g in gone)
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.lib_path(n) for n in _build.SOURCES}
    (csrc / "wgmma.cuh").write_text(
        (csrc / "wgmma.cuh").read_text() + "\n// edited\n")
    after = {n: _build.lib_path(n) for n in _build.SOURCES}
    for name in ("flash_attention_fwd", "flash_attention_bwd",
                 "conv_bn_relu", "int8_gemm"):
        assert before[name] != after[name], name
