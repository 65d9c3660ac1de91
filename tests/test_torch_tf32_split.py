"""The split-TF32 ("3xTF32") arithmetic of the fp32 flash kernels, from
the CPU.

The fp32 instances of ``csrc/flash_attention_fwd.cu`` and
``csrc/flash_attention_bwd.cu`` run every product on the tensor cores in
TF32 (``csrc/flash_tf32.cuh``): an fp32 operand x is carried as hi = x
with its low 13 mantissa bits cleared and lo = x - hi, and a product a b
as a_lo b_hi + a_hi b_lo + a_hi b_hi in fp32. The kernels run only on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``). Here, in plain
PyTorch on the CPU:

* the kernels' products emulated term by term (hi and lo through an int32
  view of the fp32 bits; lo's own low 13 bits dropped too, the worst the
  tensor core can do with them): the backward's 7 products (s and dp in
  both passes, dv, dk, dq) at B = 2, H = 2, S = 128, head_dim 32, 64 and
  128, key bias and dropout 0.1, within the fp32 gate chip_smoke.py holds
  the kernel to (``TRAIN_TOL[fp32]``: rtol 1e-4, atol 2e-5; dbias rtol =
  atol = 1e-3) of the fp32 plain backward, and the forward's 2 products
  within the serving gate (out rtol 1e-4, atol 1e-5; lse rtol 1e-5, atol
  1e-4) of the plain forward; one TF32 pass alone (hi hi) misses both;
* the emulated backward and forward against the TPU kernels they replace
  (``_fwd_pallas_fused_g`` / ``_bwd_pallas_fused_g``, Pallas interpret
  mode) within the same gates;
* the reduction order of the register A fragments: accumulator column
  2 i fed as reduction index i and 2 i + 1 as i + 4, the transposed B
  tile's positions permuted alike, is the same product.
"""

import importlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import rng
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as fa

jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

torch.set_num_threads(2)

B, H, S = 2, 2, 128
RATE, SEED = 0.1, 0x5EED1234
TRAIN_TOL = dict(rtol=1e-4, atol=2e-5)     # chip_smoke.py TRAIN_TOL[fp32]
DBIAS_TOL = dict(rtol=1e-3, atol=1e-3)     # chip_smoke.py DBIAS_TOL
OUT_TOL = dict(rtol=1e-4, atol=1e-5)       # chip_smoke.py check_flash
LSE_TOL = dict(rtol=1e-5, atol=1e-4)


def _hi(x):
    """x with its low 13 mantissa bits cleared: a TF32 value."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def _mm(a, b, terms):
    """a @ b as the kernels take it: 3 terms (lo hi + hi lo + hi hi), or
    1 (hi hi, one TF32 pass)."""
    ah, bh = _hi(a), _hi(b)
    if terms == 1:
        return ah @ bh
    al, bl = _hi(a - ah), _hi(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _scores(q, k, scale, bias, terms):
    s = _mm(q, k.transpose(-1, -2), terms) * scale
    return s + bias.reshape(q.shape[0], 1, 1, -1)


def _mult():
    keep = rng.attn_keep(SEED, RATE, B, H, S, S, torch.device("cpu"))
    return keep.float() / (1.0 - RATE)


def emulated_fwd(q, k, v, scale, bias, terms):
    """(out, lse) of the fp32 forward kernel's arithmetic, [B,H,S,hd]."""
    s = _scores(q, k, scale, bias, terms)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = _mm(p * _mult(), v, terms) / l
    return out, (m + torch.log(l)).squeeze(-1)


def emulated_bwd(q, k, v, o, lse, do, scale, bias, terms):
    """(dq, dk, dv, dbias) of the fp32 backward kernels' arithmetic: the
    dkv pass's s^T, dp^T, dv, dk and the dq pass's s, dp, dq."""
    mult = _mult()
    delta = (do * o).sum(-1, keepdim=True)
    out = {}
    for pass_ in ("dkv", "dq"):   # each pass recomputes s and dp
        p = torch.exp(_scores(q, k, scale, bias, terms) - lse[..., None])
        dp = _mm(do, v.transpose(-1, -2), terms) * mult
        ds = p * (dp - delta)
        if pass_ == "dkv":
            out["dv"] = _mm((p * mult).transpose(-1, -2), do, terms)
            out["dk"] = _mm((ds * scale).transpose(-1, -2), q, terms)
            out["dbias"] = ds.sum(dim=(1, 2))
        else:
            out["dq"] = _mm(ds * scale, k, terms)
    return out["dq"], out["dk"], out["dv"], out["dbias"]


def _inputs(hd, seed):
    r = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(r.randn(B, H, S, hd).astype(np.float32))
                   for _ in range(4))
    kb = torch.from_numpy(np.where(r.rand(B, S) < 0.25, -1e4, 0.0)
                          .astype(np.float32))
    return q, k, v, do, kb


def _within(got, want, tol):
    return torch.allclose(got, want, **tol)


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_split_tf32_backward_meets_the_fp32_gate_and_one_pass_does_not(hd):
    q, k, v, do, kb = _inputs(hd, hd)
    scale = hd ** -0.5
    o, lse = fa.plain_flash_fwd(q, k, v, None, scale, False, kb, RATE, SEED,
                                layout="bnsd")
    want = fa.plain_flash_bwd(q, k, v, o, lse, do, None, scale, False, kb,
                              RATE, SEED, layout="bnsd")
    got = emulated_bwd(q, k, v, o, lse, do, scale, kb, 3)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        tol = DBIAS_TOL if name == "dbias" else TRAIN_TOL
        torch.testing.assert_close(g, w, msg=lambda m: f"{name}: {m}", **tol)
    one = emulated_bwd(q, k, v, o, lse, do, scale, kb, 1)
    assert not all(_within(g, w, TRAIN_TOL)
                   for g, w in zip(one[:3], want[:3])), \
        "one TF32 pass met the fp32 gate: the test no longer tells them apart"


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_split_tf32_forward_meets_the_serving_gate_and_one_pass_does_not(hd):
    q, k, v, _, kb = _inputs(hd, 7 * hd)
    scale = hd ** -0.5
    want_o, want_lse = fa.plain_flash_fwd(q, k, v, None, scale, False, kb,
                                          RATE, SEED, layout="bnsd")
    o, lse = emulated_fwd(q, k, v, scale, kb, 3)
    torch.testing.assert_close(o, want_o, **OUT_TOL)
    torch.testing.assert_close(lse, want_lse, **LSE_TOL)
    o1, lse1 = emulated_fwd(q, k, v, scale, kb, 1)
    assert not (_within(o1, want_o, OUT_TOL)
                and _within(lse1, want_lse, LSE_TOL))


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_split_tf32_matches_the_tpu_kernels(hd):
    """The emulated kernels against _fwd_pallas_fused_g and
    _bwd_pallas_fused_g (the S < 256 TPU kernels) in interpret mode."""
    q, k, v, do, kb = _inputs(hd, 11 * hd)
    scale = hd ** -0.5
    args = (jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
            jnp.asarray(v.numpy()), jnp.asarray(kb.numpy()), False, scale,
            True)
    jo, jlse = jfa._fwd_pallas_fused_g(*args, 2, jnp.uint32(SEED), RATE)
    want = jfa._bwd_pallas_fused_g(*args, 2, jo, jlse,
                                   jnp.asarray(do.numpy()), jnp.uint32(SEED),
                                   RATE)
    o, lse = emulated_fwd(q, k, v, scale, kb, 3)
    torch.testing.assert_close(o, torch.from_numpy(np.array(jo)), **OUT_TOL)
    torch.testing.assert_close(lse, torch.from_numpy(np.array(jlse)),
                               **LSE_TOL)
    got = emulated_bwd(q, k, v, torch.from_numpy(np.array(jo)),
                       torch.from_numpy(np.array(jlse)), do, scale, kb, 3)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        tol = DBIAS_TOL if name == "dbias" else TRAIN_TOL
        torch.testing.assert_close(g, torch.from_numpy(np.array(w)),
                                   msg=lambda m: f"{name}: {m}", **tol)


def tperm(r):
    """csrc/flash_tf32.cuh tperm: a position's column in a transposed
    tile."""
    return (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2)


def frag_columns(j):
    """The accumulator columns frag32 feeds as reduction indices 0..7 of
    step j, in order: a0..a3 of lane t are reduction t and t + 4."""
    cols = [0] * 8
    for t in range(4):   # lane % 4
        # a0 = d[4j] (column 8j + 2t) as index t, a2 = d[4j + 1]
        # (column 8j + 2t + 1) as index t + 4; a1 / a3 are the rows + 8
        cols[t] = 8 * j + 2 * t
        cols[t + 4] = 8 * j + 2 * t + 1
    return cols


def test_register_fragments_and_transposed_tiles_reduce_in_one_order():
    header = (_build.CSRC / "flash_tf32.cuh").read_text()
    # the two rules, as the header spells them
    assert "return (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);" in header
    assert re.search(r"const float x\[4\] = \{d\[4 \* j\], d\[4 \* j \+ 2\], "
                     r"d\[4 \* j \+ 1\], d\[4 \* j \+ 3\]\};", header)
    r = np.random.RandomState(0)
    n_pos = 32
    a = r.randn(64, n_pos)   # an accumulator: rows x positions
    b = r.randn(n_pos, 16)   # the next product's B, positions x cols
    # B^T as the split pass writes it: position r at column tperm(r)
    bt = np.zeros((16, n_pos))
    for r in range(n_pos):
        bt[:, tperm(r)] = b[r]
    assert sorted(tperm(r) for r in range(n_pos)) == list(range(n_pos))
    got = np.zeros((64, 16))
    for j in range(n_pos // 8):
        for idx, col in enumerate(frag_columns(j)):
            got += np.outer(a[:, col], bt[:, 8 * j + idx])
    np.testing.assert_allclose(got, a @ b, rtol=1e-12, atol=1e-12)
