"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at edge shapes the serving and training paths do not reach (ragged
tiles, Sq != Sk, every head_dim instance, contexts past 48 KB of shared
memory, bf16 and fp32, dropout on and off), and the flash kernels in both
layouts: [B,H,S,D] against its plain version at S = 128 to 2048, bit for
bit equal to the packed layout on the same values, and refusing strides
they cannot read instead of copying. The flash kernels' bf16 instances run
on the tensor cores: every head_dim, ragged and cross-attention shapes,
causal, bias and dropout, their keep masks read back bit for bit, and
their 8-element stride rule; so do the fp32 instances in split TF32, held
at the fp32 gates and bit for bit from run to run. The layer-norm kernel
at the path's widths and 1 to 20480 rows. Paged attention at every
head_dim, each row alone bit for bit its row in the batch. AdamW on
misaligned views and ragged lengths, its beta powers advanced in the same
launch bit for bit as the plain route, one kernel an ``adamw`` op. Both
in CUDA graphs replayed on two streams at once beside eager calls: a
captured call owns its workspace and tickets. The
int8 GEMM at the serving ladder's M (8 to 2048) and weight shapes, on the
instance its M picks, and bit for bit independent of the other rows.
Transformer-big's two new flash forms at B=48 S=256 (causal with no
bias, cross-attention under the key-padding bias); ``increment``, every
``lr_schedule`` branch and ``one_hot`` in one CUDA graph captured with
no host sync; ``lookup_table_v2``'s gradient the same bits every run,
eager and replayed; and a compiled WMT step whose rate follows noam
replay by replay. The prefix-sharing decode path at a small width: a hit
equals the cold run bit for bit, and the captured chunk program equals
its op-by-op run. ``serve_decode`` at a small width: ids over HTTP equal
the in-process engine's, and a decode-role engine behind it installs the
shipments it fetches. The inference predictor: a replayed BERT batch runs
one bnsd split-TF32 flash forward a layer, as the trace and the counters
both show; BERT-base behind the micro-batching engine answers each
request bit for bit as the predictor does on its rows padded to the
served bucket, and within 1e-5 of the unbatched run. The int8 serving
path: the int8 GEMM at BERT-base's shapes, the static int8_matmul
through ``torch._int_mm`` (M and N padded) bit for bit equal to the
CPU's exact path, and a small int8 BERT (weight-only and static) through
the predictor's CUDA graph. Queue C's C12 and C13 (the saturating cast,
take_along_axis's wrapped and filled indices) bit for bit the CPU's; the
flash op's general-bias route against the CPU with no kernel launch;
``run_steps`` equal to k ``run()`` calls bit for bit; the threefry dropout
mask (from an int key and from a key-table slot) the CPU's mask. The
math, tensor, RNN, sequence and beam-search ops of every case of
``tools/glue_cases.py`` on the card against the CPU, a small seq2seq
training step and its two decoders against the CPU, and the LSTM op in
a captured CUDA graph. The CRF's cost, gradients and Viterbi paths
against the CPU; a DynamicRNN training step captured and bit for bit
its op-by-op run; a gradient-merge step (uncaptured: conditional_block
decides on the host) against one whole-batch Adam step. The imperative
mode: eager MultiHeadAttention at S=128 under a key-padding bias runs one
bnsd flash forward and one bnsd backward launch, its output and
gradients the CPU's within 2e-5 (no_grad: the forward alone); eager
AdamW steps launch one kernel per parameter tensor through the captured
micro-program, the CPU's within 1e-5; ``auto_cast`` runs bf16 matmuls.
``@to_static``: a small MLP's and a 2-layer BERT's graph replays equal
their block run op by op on the card bit for bit; a block holding an
unbounded ``while_loop`` runs uncaptured, counted; the launch counters
count replays only.
Marked ``cuda``: they skip where torch.cuda is unavailable.

This file imports neither jax nor paddle_tpu, so on a machine with the
card and no JAX it runs without the repo's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

import threading

import numpy as np
import pytest
import torch

from paddle_tpu_torch import kernels
from paddle_tpu_torch.core import rng, telemetry
from paddle_tpu_torch.kernels import conv_bn_relu as cbr
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import fused_adam as fad
from paddle_tpu_torch.kernels import int8_gemm as ig
from paddle_tpu_torch.kernels import layer_norm as ln
from paddle_tpu_torch.kernels import paged_attention as pa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


@pytest.mark.parametrize("b,sq,sk,n,hd,causal,bias", [
    (1, 1, 1, 1, 64, True, False), (2, 70, 70, 3, 64, True, True),
    (1, 200, 333, 2, 32, True, False), (1, 129, 129, 2, 128, False, True),
    (2, 64, 64, 4, 64, False, False), (1, 300, 100, 1, 64, True, False)])
def test_flash_kernel_matches_plain(dev, b, sq, sk, n, hd, causal, bias):
    g = torch.Generator(device=dev).manual_seed(sq * sk)
    q = torch.randn(b, sq, n * hd, device=dev, generator=g)
    k, v = (torch.randn(b, sk, n * hd, device=dev, generator=g)
            for _ in range(2))
    kb = None
    if bias:
        kb = torch.where(torch.rand(b, sk, device=dev, generator=g) < 0.3,
                         -1e9, 0.0)
    before = fa.launches
    out, lse = fa.packed_flash_fwd(q, k, v, n, hd ** -0.5, causal, kb)
    ref_out, ref_lse = fa.plain_packed_flash_fwd(q, k, v, n, hd ** -0.5,
                                                 causal, kb)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    torch.testing.assert_close(out, ref_out, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)


def _qkv(dev, b, sq, sk, n, hd, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, sq, n * hd, device=dev, generator=g).to(dtype)
    k, v = (torch.randn(b, sk, n * hd, device=dev, generator=g).to(dtype)
            for _ in range(2))
    kb = torch.where(torch.rand(b, sk, device=dev, generator=g) < 0.3,
                     -1e4, 0.0)
    return q, k, v, kb, g


# fp32: sums in another order. bf16: the tensor-core kernels accumulate in
# fp32 and carry p and ds as bf16 hi + lo pairs, so they are held against
# the plain version run in fp32 on the same values and rounded to bf16 once:
# one bf16 ulp (2^-7 relative) plus 1e-3, about 2 % of a typical |out| at
# S = 512 with N(0, 1) inputs.
TOL = {torch.float32: dict(rtol=1e-4, atol=2e-5),
       torch.bfloat16: dict(rtol=2 ** -7, atol=1e-3)}


def _f32(*tensors):
    return [None if t is None else t.float() for t in tensors]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,n,hd,causal,bias,rate", [
    (2, 128, 128, 2, 64, False, True, 0.1), (1, 70, 70, 3, 64, True, True, 0.3),
    (1, 200, 333, 2, 32, True, False, 0.1), (1, 129, 129, 2, 128, False, True, 0.0),
    (2, 512, 512, 16, 64, False, True, 0.1)])
def test_flash_dropout_bf16_forward_matches_plain(dev, dtype, b, sq, sk, n,
                                                  hd, causal, bias, rate):
    q, k, v, kb, _ = _qkv(dev, b, sq, sk, n, hd, dtype, sq + sk)
    kb = kb if bias else None
    before = fa.launches
    out, lse = fa.packed_flash_fwd(q, k, v, n, hd ** -0.5, causal, kb, rate,
                                   12345)
    ref_out, ref_lse = fa.plain_packed_flash_fwd(*_f32(q, k, v), n,
                                                 hd ** -0.5, causal, kb, rate,
                                                 12345)
    torch.cuda.synchronize()
    assert fa.launches == before + 1 and out.dtype == dtype
    torch.testing.assert_close(out.float(), ref_out.to(dtype).float(),
                               **TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)


def test_flash_forward_keep_mask_is_the_plain_mask_bitwise(dev):
    """q = 0 makes every probability 1/Sk; v one-hot over a 64-key chunk
    makes out[q, d] = keep(q, chunk + d) / ((1 - rate) Sk): the kernel's
    mask, read exactly, against core/rng.attn_keep."""
    b, s, n, hd, rate, seed = 2, 192, 3, 64, 0.25, 987654321
    q = torch.zeros(b, s, n * hd, device=dev)
    want = rng.attn_keep(seed, rate, b, n, s, s, dev)
    for c in range(s // hd):
        v = torch.zeros(b, s, n, hd, device=dev)
        v[:, c * hd:(c + 1) * hd] = torch.eye(hd, device=dev)[None, :, None]
        out, _ = fa.packed_flash_fwd(q, q, v.reshape(b, s, n * hd), n, 1.0,
                                     False, None, rate, seed)
        got = out.reshape(b, s, n, hd).permute(0, 2, 1, 3) != 0
        assert torch.equal(got, want[..., c * hd:(c + 1) * hd])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,n,hd,causal,bias,rate", [
    (2, 128, 128, 2, 64, False, True, 0.1), (1, 70, 70, 3, 64, True, True, 0.3),
    (1, 200, 333, 2, 32, True, False, 0.1), (1, 129, 129, 2, 128, False, True, 0.0),
    (2, 64, 64, 4, 64, False, False, 0.0), (2, 512, 512, 16, 64, False, True, 0.1)])
def test_flash_backward_matches_plain(dev, dtype, b, sq, sk, n, hd, causal,
                                      bias, rate):
    q, k, v, kb, g = _qkv(dev, b, sq, sk, n, hd, dtype, sq * sk)
    kb = kb if bias else None
    do = torch.randn(b, sq, n * hd, device=dev, generator=g).to(dtype)
    scale = hd ** -0.5
    out, lse = fa.plain_packed_flash_fwd(q, k, v, n, scale, causal, kb, rate,
                                         77)
    before = fa.bwd_launches
    got = fa.packed_flash_bwd(q, k, v, out, lse, do, n, scale, causal, kb,
                              rate, 77)
    ref = fa.plain_packed_flash_bwd(*_f32(q, k, v, out), lse, do.float(), n,
                                    scale, causal, kb, rate, 77)
    torch.cuda.synchronize()
    assert fa.bwd_launches == before + 1
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        if r is None:
            assert a is None
            continue
        if name == "dbias":   # fp32 sums of n * sq terms, |dbias| ~ 1
            tol = dict(rtol=1e-3, atol=1e-3)
        else:
            tol, r = TOL[dtype], r.to(dtype)
        torch.testing.assert_close(a.float(), r.float(),
                                   msg=lambda m: f"{name}: {m}", **tol)


def test_flash_backward_agrees_with_autograd_of_plain_forward(dev):
    b, s, n, hd = 2, 96, 2, 64
    q, k, v, kb, g = _qkv(dev, b, s, s, n, hd, torch.float32, 5)
    do = torch.randn(b, s, n * hd, device=dev, generator=g)
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out, lse = fa.plain_packed_flash_fwd(*qkv, n, 0.125, False, kb, 0.2, 9)
    want = torch.autograd.grad(out, qkv, do)
    got = fa.packed_flash_bwd(q, k, v, out.detach(), lse.detach(), do, n,
                              0.125, False, kb, 0.2, 9)
    for a, r in zip(got[:3], want):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=2e-5)


def _bnsd(dev, b, sq, sk, n, hd, dtype, seed):
    """q, k, v, dout [B,n,S,hd] and a key bias [B,Sk]."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(b, n, sq, hd, device=dev, generator=g).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, n, sk, hd, device=dev, generator=g).to(dtype)
            for _ in range(2))
    kb = torch.where(torch.rand(b, sk, device=dev, generator=g) < 0.3,
                     -1e4, 0.0)
    return q, k, v, do, kb


def _packed(t4):
    b, n, s, hd = t4.shape
    return t4.transpose(1, 2).reshape(b, s, n * hd)


BNSD_CASES = [
    (2, 128, 128, 4, 64, False, True, 0.1), (2, 128, 128, 4, 64, True, False,
                                             0.0),
    (1, 512, 512, 16, 64, False, True, 0.1), (1, 512, 512, 4, 64, True, True,
                                              0.1),
    (1, 2048, 2048, 2, 64, True, True, 0.1), (1, 2048, 2048, 2, 64, False,
                                              True, 0.0),
    (2, 512, 256, 4, 64, False, True, 0.1), (1, 256, 512, 2, 128, True, True,
                                             0.1),
    (1, 300, 100, 2, 32, True, False, 0.1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,n,hd,causal,bias,rate", BNSD_CASES)
def test_flash_bnsd_matches_plain(dev, dtype, b, sq, sk, n, hd, causal, bias,
                                  rate):
    q, k, v, do, kb = _bnsd(dev, b, sq, sk, n, hd, dtype, sq + 7 * sk)
    kb = kb if bias else None
    scale = hd ** -0.5
    kernels.reset_launch_counts()
    out, lse = fa.flash_fwd(q, k, v, None, scale, causal, kb, rate, 31,
                            layout="bnsd")
    ref_out, ref_lse = fa.plain_flash_fwd(*_f32(q, k, v), None, scale, causal,
                                          kb, rate, 31, layout="bnsd")
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.dtype == dtype
    torch.testing.assert_close(out.float(), ref_out.to(dtype).float(),
                               **TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
    got = fa.flash_bwd(q, k, v, ref_out.to(dtype), ref_lse, do, None, scale,
                       causal, kb, rate, 31, layout="bnsd")
    ref = fa.plain_flash_bwd(*_f32(q, k, v, ref_out.to(dtype)), ref_lse,
                             do.float(), None, scale, causal, kb, rate, 31,
                             layout="bnsd")
    torch.cuda.synchronize()
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        if r is None:
            assert a is None
            continue
        if name == "dbias":
            tol = dict(rtol=1e-3, atol=1e-3)
        else:
            assert a.shape == (q if name == "dq" else k).shape
            tol, r = TOL[dtype], r.to(dtype)
        torch.testing.assert_close(a.float(), r.float(),
                                   msg=lambda m: f"{name}: {m}", **tol)
    assert kernels.layout_counts() == {
        "flash_attention_fwd": {"packed": 0, "bnsd": 1},
        "flash_attention_bwd": {"packed": 0, "bnsd": 1}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,n,hd,causal,bias,rate", [
    (2, 512, 512, 16, 64, False, True, 0.1), (1, 2048, 2048, 4, 64, True,
                                              True, 0.1),
    (1, 512, 256, 4, 64, False, True, 0.1), (2, 70, 200, 3, 128, True, True,
                                             0.0)])
def test_flash_layouts_agree_bit_for_bit(dev, dtype, b, sq, sk, n, hd, causal,
                                         bias, rate):
    """The same values in [B,H,S,D] and packed: the same bits out of both
    kernels (the arithmetic does not depend on the strides), and the same
    bits again on a second run (no atomics)."""
    q, k, v, do, kb = _bnsd(dev, b, sq, sk, n, hd, dtype, 3 * sq + sk)
    kb = kb if bias else None
    scale = hd ** -0.5
    runs = {}
    for layout, conv in (("bnsd", lambda t: t),
                         ("packed", lambda t: _packed(t).contiguous()),
                         ("again", lambda t: t)):
        lay = "bnsd" if layout == "again" else layout
        q_, k_, v_, do_ = (conv(t) for t in (q, k, v, do))
        out, lse = fa.flash_fwd(q_, k_, v_, n, scale, causal, kb, rate, 5,
                                layout=lay)
        grads = fa.flash_bwd(q_, k_, v_, out, lse, do_, n, scale, causal, kb,
                             rate, 5, layout=lay)
        back = (lambda t: t) if lay == "bnsd" else (
            lambda t: t.reshape(t.shape[0], t.shape[1], n, hd)
            .transpose(1, 2))
        runs[layout] = [back(out), lse] + [back(g) for g in grads[:3]] + \
            list(grads[3:])
    torch.cuda.synchronize()
    for other in ("packed", "again"):
        for name, a, c in zip(("out", "lse", "dq", "dk", "dv", "dbias"),
                              runs["bnsd"], runs[other]):
            assert (a is None) == (c is None), name
            if a is not None:
                assert torch.equal(a, c), f"{name}: bnsd != {other}"


def test_flash_kernels_read_views_in_place_and_refuse_what_they_cannot(dev):
    b, s, n, hd = 2, 96, 4, 64
    q, k, v, do, kb = _bnsd(dev, b, s, s, n, hd, torch.float32, 11)
    qp, kp, vp = (_packed(t).contiguous() for t in (q, k, v))
    want = fa.flash_fwd(qp, kp, vp, n, 0.125, True, kb)
    # a [B,H,S,D] view of the packed tensors: strides (S*n*hd, hd, n*hd)
    views = [t.reshape(b, s, n, hd).transpose(1, 2) for t in (qp, kp, vp)]
    assert not views[0].is_contiguous()
    got = fa.flash_fwd(*views, None, 0.125, True, kb, layout="bnsd")
    assert torch.equal(_packed(got[0]), want[0]) and torch.equal(got[1],
                                                                  want[1])
    # packed q/k/v as column slices of one fused [B,S,3*n*hd] projection
    fused = torch.cat([qp, kp, vp], dim=-1)
    w = n * hd
    got = fa.flash_fwd(fused[..., :w], fused[..., w:2 * w], fused[..., 2 * w:],
                       n, 0.125, True, kb)
    assert torch.equal(got[0], want[0])
    lse = want[1]
    bad = {
        "head_dim not contiguous": q.transpose(2, 3).contiguous()
        .transpose(2, 3),
        "row stride off the alignment": torch.zeros(
            b, n, s, hd + 2, device=dev)[..., :hd],
        "address off the alignment": torch.zeros(
            b * n * s * hd + 2, device=dev)[2:].reshape(b, n, s, hd),
    }
    for why, t in bad.items():
        with pytest.raises(ValueError):
            fa.flash_fwd(t, k, v, None, 0.125, True, kb, layout="bnsd")
        with pytest.raises(ValueError):
            fa.flash_bwd(t, k, v, q, lse, do, None, 0.125, True, kb,
                         layout="bnsd")
    with pytest.raises(ValueError):   # a packed q in the bnsd layout
        fa.flash_fwd(qp, kp, vp, n, 0.125, True, layout="bnsd")

    # bf16, the tensor-core instance: 16-byte copies need every stride a
    # multiple of 8 elements. A view with 8-element row strides is read in
    # place (the same bits as the contiguous tensor); one with 4 raises
    # rather than being copied or sent to another instance.
    qb, kb16, vb, dob = (t.bfloat16() for t in (q, k, v, do))
    want = fa.flash_fwd(qb, kb16, vb, None, 0.125, True, kb, 0.1, 3,
                        layout="bnsd")
    wide = torch.zeros(b, n, s, hd + 8, device=dev, dtype=torch.bfloat16)
    wide[..., :hd] = qb
    got = fa.flash_fwd(wide[..., :hd], kb16, vb, None, 0.125, True, kb, 0.1,
                       3, layout="bnsd")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    fused = torch.cat([_packed(t) for t in (qb, kb16, vb)], dim=-1)
    got = fa.flash_fwd(fused[..., :w], fused[..., w:2 * w], fused[..., 2 * w:],
                       n, 0.125, True, kb, 0.1, 3)
    assert torch.equal(got[0], _packed(want[0]))
    kernels.reset_launch_counts()
    off = torch.zeros(b, n, s, hd + 4, device=dev,
                      dtype=torch.bfloat16)[..., :hd]
    with pytest.raises(ValueError):
        fa.flash_fwd(off, kb16, vb, None, 0.125, True, kb, layout="bnsd")
    with pytest.raises(ValueError):
        fa.flash_bwd(off, kb16, vb, want[0], want[1], dob, None, 0.125, True,
                     kb, layout="bnsd")
    assert kernels.dtype_counts() == {
        k_: dict.fromkeys(fa.INSTANCES, 0)
        for k_ in ("flash_attention_fwd", "flash_attention_bwd")}


# the bf16 tensor-core instances at every head_dim: self-attention at a
# ragged S = 200, cross-attention Sq != Sk both ways, causal (bottom-right,
# with rows that see no key when Sq > Sk), with and without bias and
# dropout
WGMMA_SHAPES = [(2, 200, 200, False), (1, 200, 333, False),
                (1, 333, 200, False), (2, 200, 200, True),
                (1, 300, 100, True)]


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("b,sq,sk,causal", WGMMA_SHAPES)
@pytest.mark.parametrize("bias,rate", [(False, 0.0), (True, 0.1)])
def test_flash_bf16_wgmma_matches_plain_in_both_layouts(dev, hd, b, sq, sk,
                                                        causal, bias, rate):
    n = 3
    q, k, v, do, kb = _bnsd(dev, b, sq, sk, n, hd, torch.bfloat16,
                            hd + sq + 3 * sk)
    kb = kb if bias else None
    scale = hd ** -0.5
    ref_out, ref_lse = fa.plain_flash_fwd(*_f32(q, k, v), None, scale,
                                          causal, kb, rate, 19, layout="bnsd")
    ref = fa.plain_flash_bwd(*_f32(q, k, v), ref_out.bfloat16().float(),
                             ref_lse, do.float(), None, scale, causal, kb,
                             rate, 19, layout="bnsd")
    kernels.reset_launch_counts()
    runs = {}
    for layout in ("bnsd", "packed"):
        conv = (lambda t: t) if layout == "bnsd" else \
            (lambda t: _packed(t).contiguous())
        q_, k_, v_, do_ = (conv(t) for t in (q, k, v, do))
        out, lse = fa.flash_fwd(q_, k_, v_, n, scale, causal, kb, rate, 19,
                                layout=layout)
        grads = fa.flash_bwd(q_, k_, v_, conv(ref_out.bfloat16()), ref_lse,
                             do_, n, scale, causal, kb, rate, 19,
                             layout=layout)
        back = (lambda t: t) if layout == "bnsd" else \
            (lambda t: fa._heads(t, n, "packed"))
        runs[layout] = [back(out), lse] + [back(g) for g in grads[:3]] + \
            [grads[3]]
    torch.cuda.synchronize()
    assert kernels.dtype_counts() == {
        k_: {"fp32_tf32x3": 0, "bf16_wgmma": 2}
        for k_ in ("flash_attention_fwd", "flash_attention_bwd")}
    out, lse, dq, dk, dv, dbias = runs["bnsd"]
    torch.testing.assert_close(out.float(), ref_out.bfloat16().float(),
                               **TOL[torch.bfloat16])
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
    for name, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref[:3]):
        torch.testing.assert_close(a.float(), r.bfloat16().float(),
                                   msg=lambda m: f"{name}: {m}",
                                   **TOL[torch.bfloat16])
    if bias:
        torch.testing.assert_close(dbias, ref[3], rtol=1e-3, atol=1e-3)
    else:
        assert dbias is None
    for name, x, y in zip(("out", "lse", "dq", "dk", "dv", "dbias"),
                          runs["bnsd"], runs["packed"]):
        assert (x is None) == (y is None) and (
            x is None or torch.equal(x, y)), f"{name}: bnsd != packed"


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("b,sq,sk,causal", WGMMA_SHAPES)
@pytest.mark.parametrize("bias,rate", [(False, 0.0), (True, 0.1)])
def test_flash_fp32_tf32x3_matches_plain_in_both_layouts(dev, hd, b, sq, sk,
                                                         causal, bias, rate):
    """The fp32 instances, split TF32 on the tensor cores, against the
    fp32 plain versions at the fp32 gates, in both layouts, bit for bit
    from layout to layout and from run to run."""
    n = 3
    q, k, v, do, kb = _bnsd(dev, b, sq, sk, n, hd, torch.float32,
                            hd + 2 * sq + sk)
    kb = kb if bias else None
    scale = hd ** -0.5
    ref_out, ref_lse = fa.plain_flash_fwd(q, k, v, None, scale, causal, kb,
                                          rate, 23, layout="bnsd")
    ref = fa.plain_flash_bwd(q, k, v, ref_out, ref_lse, do, None, scale,
                             causal, kb, rate, 23, layout="bnsd")
    kernels.reset_launch_counts()
    runs = {}
    for layout, rep in (("bnsd", 0), ("packed", 0), ("bnsd", 1)):
        conv = (lambda t: t) if layout == "bnsd" else \
            (lambda t: _packed(t).contiguous())
        q_, k_, v_, do_ = (conv(t) for t in (q, k, v, do))
        out, lse = fa.flash_fwd(q_, k_, v_, n, scale, causal, kb, rate, 23,
                                layout=layout)
        grads = fa.flash_bwd(q_, k_, v_, conv(ref_out), ref_lse, do_, n,
                             scale, causal, kb, rate, 23, layout=layout)
        back = (lambda t: t) if layout == "bnsd" else \
            (lambda t: fa._heads(t, n, "packed"))
        runs[layout, rep] = [back(out), lse] + \
            [back(g) for g in grads[:3]] + [grads[3]]
    torch.cuda.synchronize()
    assert kernels.dtype_counts() == {
        k_: {"fp32_tf32x3": 3, "bf16_wgmma": 0}
        for k_ in ("flash_attention_fwd", "flash_attention_bwd")}
    out, lse, dq, dk, dv, dbias = runs["bnsd", 0]
    torch.testing.assert_close(out, ref_out, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
    for name, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref[:3]):
        torch.testing.assert_close(a, r, msg=lambda m: f"{name}: {m}",
                                   **TOL[torch.float32])
    if bias:
        torch.testing.assert_close(dbias, ref[3], rtol=1e-3, atol=1e-3)
    else:
        assert dbias is None
    for other in (("packed", 0), ("bnsd", 1)):
        for name, x, y in zip(("out", "lse", "dq", "dk", "dv", "dbias"),
                              runs["bnsd", 0], runs[other]):
            assert (x is None) == (y is None) and (
                x is None or torch.equal(x, y)), f"{name}: bnsd != {other}"


def test_flash_bf16_keep_masks_are_the_plain_mask_bitwise(dev):
    """Both bf16 kernels' dropout masks, read exactly. Forward: q = 0 makes
    every probability 1/Sk and v one-hot over a 64-key chunk makes
    out[q, d] = keep(q, chunk + d) / ((1 - rate) Sk). Backward: q = k = v
    = 0 and lse = log Sk make p = 1/Sk and ds = 0, and do one-hot over a
    64-row chunk makes dv[k, d] = keep(chunk + d, k) / ((1 - rate) Sk)."""
    b, s, n, hd, rate, seed = 2, 192, 3, 64, 0.25, 987654321
    zero = torch.zeros(b, s, n * hd, device=dev, dtype=torch.bfloat16)
    lse = torch.full((b, n, s), float(np.log(s)), device=dev)
    want = rng.attn_keep(seed, rate, b, n, s, s, dev)
    eye = torch.eye(hd, device=dev, dtype=torch.bfloat16)[None, :, None]
    for c in range(s // hd):
        chunk = torch.zeros(b, s, n, hd, device=dev, dtype=torch.bfloat16)
        chunk[:, c * hd:(c + 1) * hd] = eye
        chunk = chunk.reshape(b, s, n * hd)
        out, _ = fa.packed_flash_fwd(zero, zero, chunk, n, 1.0, False, None,
                                     rate, seed)
        got = out.reshape(b, s, n, hd).permute(0, 2, 1, 3) != 0
        assert torch.equal(got, want[..., c * hd:(c + 1) * hd])
        dv = fa.packed_flash_bwd(zero, zero, zero, zero, lse, chunk, n, 1.0,
                                 False, None, rate, seed)[2]
        got = dv.reshape(b, s, n, hd).permute(0, 2, 3, 1) != 0
        assert torch.equal(got, want[:, :, c * hd:(c + 1) * hd])


@pytest.mark.parametrize("pdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1,), (1000, 33), (1024, 4096)])
def test_adamw_kernel_matches_plain(dev, pdt, shape):
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    p = torch.randn(shape, device=dev, generator=g).to(pdt)
    grad = (torch.randn(shape, device=dev, generator=g) * 0.1).to(pdt)
    m = torch.randn(shape, device=dev, generator=g) * 0.01
    v = torch.rand(shape, device=dev, generator=g) * 1e-3
    lr = torch.tensor([1e-3], device=dev)
    b1p, b2p = (torch.tensor([x], device=dev) for x in (0.9 ** 3, 0.999 ** 3))
    want = fad.plain_fused_adamw(p, grad, m, v, lr, 0.9, 0.999, 1e-8, 0.01,
                                 b1p, b2p)
    pows = [b1p.clone(), b2p.clone()]
    before = fad.launches
    got = fad.fused_adamw_(p, grad, m, v, lr, 0.9, 0.999, 1e-8, 0.01, *pows)
    torch.cuda.synchronize()
    assert fad.launches == before + 1 and got[0] is p
    _assert_pows_advanced(pows, (b1p, b2p))
    # fp32: the compiler contracts a * b + c into one fma, the plain
    # version rounds twice; bf16 params: one bf16 ulp where they differ
    ptol = dict(rtol=1e-6, atol=1e-6) if pdt == torch.float32 \
        else dict(rtol=8e-3, atol=1e-6)
    torch.testing.assert_close(got[0].float(), want[0].float(), **ptol)
    torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=1e-9)


def _adamw_state(dev, pdt, numel, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    p = torch.randn(numel, device=dev, generator=g).to(pdt)
    grad = (torch.randn(numel, device=dev, generator=g) * 0.1).to(pdt)
    m = torch.randn(numel, device=dev, generator=g) * 0.01
    v = torch.rand(numel, device=dev, generator=g) * 1e-3
    return p, grad, m, v


def _assert_pows_advanced(got, before):
    # the launch's b1^t * b1 and b2^t * b2: one fp32 multiply each, the
    # bits of the plain route's mul_ on the CPU
    for g, b, f in zip(got, before, (0.9, 0.999)):
        assert torch.equal(g.cpu(), b.cpu() * f), (g, b)


def _adamw_tol(pdt):
    # as test_adamw_kernel_matches_plain: fp32 one fma contraction, bf16
    # params one bf16 ulp
    return dict(rtol=1e-6, atol=1e-6) if pdt == torch.float32 \
        else dict(rtol=8e-3, atol=1e-6)


@pytest.mark.parametrize("pdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("numel,offsets", [
    (1, (0, 0, 0, 0)), (7, (1, 1, 1, 1)), (1000 * 33 + 5, (0, 0, 0, 0)),
    (1000 * 33 + 5, (1, 1, 1, 1)), (1000 * 33 + 5, (3, 3, 1, 1)),
    (1000 * 33 + 5, (1, 2, 3, 0)), (1 << 20, (7, 7, 3, 3))])
def test_adamw_kernel_on_misaligned_views_and_ragged_lengths(
        dev, pdt, numel, offsets):
    """Views offset by a few elements in each stream (param, grad, m, v)
    and lengths that are not a whole number of 16-byte vectors: the
    scalar head and tail and the vector body update every element of the
    view once, at the plain version's tolerances, and nothing outside."""
    bases = _adamw_state(dev, pdt, numel + 8, numel)
    views = [t[o:o + numel] for t, o in zip(bases, offsets)]
    before = [t.clone() for t in bases]
    lr = torch.tensor([1e-3], device=dev)
    b1p, b2p = (torch.tensor([x], device=dev) for x in (0.9 ** 3, 0.999 ** 3))
    want = fad.plain_fused_adamw(*views, lr, 0.9, 0.999, 1e-8, 0.01, b1p,
                                 b2p)
    pows = [b1p.clone(), b2p.clone()]
    fad.fused_adamw_(*views, lr, 0.9, 0.999, 1e-8, 0.01, *pows)
    torch.cuda.synchronize()
    _assert_pows_advanced(pows, (b1p, b2p))
    torch.testing.assert_close(views[0].float(), want[0].float(),
                               **_adamw_tol(pdt))
    torch.testing.assert_close(views[2], want[1], rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(views[3], want[2], rtol=1e-6, atol=1e-9)
    for t, t0, o in zip(bases, before, offsets):
        assert torch.equal(t[:o], t0[:o]) and torch.equal(
            t[o + numel:], t0[o + numel:])


@pytest.mark.parametrize("pdt", [torch.float32, torch.bfloat16])
def test_adamw_beta_powers_advance_as_the_plain_route_bitwise(dev, pdt):
    """Five launches with the beta powers folded in, at a size of many
    blocks, beside the CPU route on the same state: after each, b1^t and
    b2^t equal the plain route's bit for bit, and the update read the
    powers from before the launch."""
    numel = 1024 * 4096 + 3
    card = list(_adamw_state(dev, pdt, numel, 5))
    cpu = [t.cpu() for t in card]
    lr = torch.tensor([1e-3], device=dev)
    pows = [torch.tensor([x], device=dev) for x in (0.9, 0.999)]
    cpu_pows = [t.cpu() for t in pows]
    for step in range(5):
        fad.fused_adamw_(*card, lr, 0.9, 0.999, 1e-8, 0.01, *pows)
        fad.fused_adamw_(*cpu, lr.cpu(), 0.9, 0.999, 1e-8, 0.01, *cpu_pows)
        torch.cuda.synchronize()
        for got, want in zip(pows, cpu_pows):
            assert got.cpu().numpy().tobytes() == want.numpy().tobytes(), \
                step
        torch.testing.assert_close(card[0].cpu().float(), cpu[0].float(),
                                   **_adamw_tol(pdt))
        card = [c.copy_(t) for c, t in zip(card, cpu)]   # one step each
    assert float(pows[0]) == pytest.approx(0.9 ** 6, rel=1e-6)


def test_adamw_graphs_replay_beside_eager_launches(dev):
    """Launches captured into CUDA graphs own their beta-power tickets:
    two graphs captured on one stream and replayed at once on two other
    streams, beside an eager launch on the capture stream, advance every
    power bit for bit as the plain route, step after step, and update
    every state at the plain version's tolerance."""
    numel = (1 << 20) + 3
    states = [list(_adamw_state(dev, torch.float32, numel, 20 + i))
              for i in range(3)]
    pows = [[torch.tensor([x], device=dev) for x in (0.9, 0.999)]
            for _ in range(3)]
    lr = torch.tensor([1e-3], device=dev)
    hyper = (0.9, 0.999, 1e-8, 0.01)
    capture, s1, s2 = (torch.cuda.Stream() for _ in range(3))
    capture.wait_stream(torch.cuda.current_stream())
    graphs = [torch.cuda.CUDAGraph() for _ in range(2)]
    with torch.cuda.stream(capture):
        scratch = [t.clone() for t in states[2]]   # builds the kernel
        fad.fused_adamw_(*scratch, lr, *hyper, *[t.clone() for t in pows[2]])
        for i, graph in enumerate(graphs):
            with torch.cuda.graph(graph, stream=capture):
                fad.fused_adamw_(*states[i], lr, *hyper, *pows[i])
    torch.cuda.synchronize()
    cpu = [[t.cpu() for t in st] for st in states]
    cpu_pows = [[t.cpu() for t in pw] for pw in pows]
    for step in range(4):
        for s in (capture, s1, s2):
            s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s1):
            graphs[0].replay()
        with torch.cuda.stream(s2):
            graphs[1].replay()
        with torch.cuda.stream(capture):
            fad.fused_adamw_(*states[2], lr, *hyper, *pows[2])
        torch.cuda.synchronize()
        for st, pw, c, cp in zip(states, pows, cpu, cpu_pows):
            fad.fused_adamw_(*c, lr.cpu(), *hyper, *cp)
            for got, want in zip(pw, cp):
                assert got.cpu().numpy().tobytes() == \
                    want.numpy().tobytes(), step
            torch.testing.assert_close(st[0].cpu(), c[0], rtol=1e-6,
                                       atol=1e-6)
            for t, ct in zip(st, c):   # one update compared at a time
                t.copy_(ct)
    assert float(pows[0][0]) == pytest.approx(0.9 ** 5, rel=1e-6)


def _paged_inputs(dev, hd, page, mp, pos, n=4, seed=0):
    """Pools with each row's pages in order from page 1, the stale tail
    of its last page poisoned (k 3e4, v 1e6); q, table and positions."""
    b = len(pos)
    num_pages = 1 + sum(p // page + 1 for p in pos)
    g = torch.Generator(device=dev).manual_seed(seed)
    pk = torch.randn(num_pages, page, n * hd, device=dev, generator=g)
    pv = torch.randn(num_pages, page, n * hd, device=dev, generator=g)
    table = torch.zeros(b, mp, dtype=torch.int32)
    nxt = 1
    for i, p in enumerate(pos):
        table[i, :p // page + 1] = torch.arange(nxt, nxt + p // page + 1)
        nxt += p // page + 1
        last = int(table[i, p // page])
        pk[last, p % page + 1:] = 3e4
        pv[last, p % page + 1:] = 1e6
    table = table.to(dev)
    posd = torch.tensor(pos, dtype=torch.int32, device=dev)
    q = torch.randn(b, n * hd, device=dev, generator=g)
    return q, pk, pv, table, posd


@pytest.mark.parametrize("hd,page,mp,pos", [
    (64, 16, 128, [0, 1, 15, 16, 2047, 700]), (32, 8, 4, [31, 0, 9]),
    (128, 16, 256, [4095, 2000])])
def test_paged_kernel_matches_plain(dev, hd, page, mp, pos):
    n = 4
    q, pk, pv, table, posd = _paged_inputs(dev, hd, page, mp, pos, n,
                                           seed=hd + mp)
    out = pa.paged_decode_attention(q, pk, pv, table, posd, n, hd, 0.1)
    ref = pa.plain_paged_attention(q, pk, pv, table, posd, n, hd, 0.1)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    assert float(out.abs().max()) < 100.0


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_paged_rows_alone_are_the_rows_in_the_batch_bitwise(dev, hd):
    """Contexts of one to ten chunks (page 16, 80 pages: 1280 tokens),
    pos on chunk and page boundaries: each row launched alone, and in a
    batch whose other rows are reordered, gives the same bits as in the
    batch; a second launch gives the same bits again (the chunks combine
    in chunk order, whatever order their blocks finish in)."""
    n, page, mp = 4, 16, 80
    pos = [1279, 0, 255, 256, 700, 15, 1024, 511]
    q, pk, pv, table, posd = _paged_inputs(dev, hd, page, mp, pos, n,
                                           seed=hd)
    scale = hd ** -0.5
    kernels.reset_launch_counts()
    out = pa.paged_decode_attention(q, pk, pv, table, posd, n, hd, scale)
    ref = pa.plain_paged_attention(q, pk, pv, table, posd, n, hd, scale)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    for i in range(len(pos)):
        alone = pa.paged_decode_attention(q[i:i + 1], pk, pv,
                                          table[i:i + 1], posd[i:i + 1], n,
                                          hd, scale)
        assert torch.equal(alone[0], out[i]), i
    perm = torch.tensor([3, 7, 0, 5, 1, 6, 2, 4], device=dev)
    shuffled = pa.paged_decode_attention(q[perm], pk, pv, table[perm],
                                         posd[perm], n, hd, scale)
    again = pa.paged_decode_attention(q, pk, pv, table, posd, n, hd, scale)
    torch.cuda.synchronize()
    assert torch.equal(shuffled, out[perm]) and torch.equal(again, out)
    assert kernels.launch_counts()["paged_attention"] == len(pos) + 3


def test_paged_graphs_replay_beside_eager_calls(dev):
    """Calls captured into CUDA graphs own their combine workspace: two
    graphs captured on one stream and replayed at once on two other
    streams, beside eager calls on the capture stream, each give the
    bits of the same call made eagerly, replay after replay."""
    n, hd, page, mp = 4, 64, 16, 80
    pos = [1279, 0, 255, 256, 700, 15, 1024, 511]
    q, pk, pv, table, posd = _paged_inputs(dev, hd, page, mp, pos, n,
                                           seed=7)
    qs = [q, q.flip(0).contiguous() * 2.0]

    def call(x):
        return pa.paged_decode_attention(x, pk, pv, table, posd, n, hd, 0.1)

    want = [call(x) for x in qs]
    torch.testing.assert_close(want[0], pa.plain_paged_attention(
        q, pk, pv, table, posd, n, hd, 0.1), rtol=1e-4, atol=1e-5)
    capture, s1, s2 = (torch.cuda.Stream() for _ in range(3))
    capture.wait_stream(torch.cuda.current_stream())
    graphs = [torch.cuda.CUDAGraph() for _ in range(2)]
    outs = []
    with torch.cuda.stream(capture):
        call(q)   # the capture stream's own workspace, made outside
        for x, graph in zip(qs, graphs):
            with torch.cuda.graph(graph, stream=capture):
                outs.append(call(x))
    torch.cuda.synchronize()
    for rep in range(4):
        for s in (capture, s1, s2):
            s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s1):
            graphs[0].replay()
        with torch.cuda.stream(s2):
            graphs[1].replay()
        with torch.cuda.stream(capture):
            eager = [call(x) for x in qs]
        torch.cuda.synchronize()
        for got in (outs, eager):
            assert all(torch.equal(g, w) for g, w in zip(got, want)), rep


@pytest.mark.parametrize("m,k,n,bias,act", [
    (1, 64, 64, False, None), (16, 100, 70, True, "relu"),
    (17, 1024, 130, True, None), (100, 33, 4096, False, "relu")])
def test_int8_kernel_matches_plain(dev, m, k, n, bias, act):
    g = torch.Generator(device=dev).manual_seed(m * k + n)
    x = torch.randn(m, k, device=dev, generator=g)
    w8 = torch.randint(-127, 128, (k, n), device=dev, dtype=torch.int8,
                       generator=g)
    sc = (torch.rand(n, device=dev, generator=g) + 0.5) / 127.0
    bb = torch.randn(n, device=dev, generator=g) if bias else None
    out = ig.int8_weight_only_gemm(x, w8, sc, bb, act)
    ref = ig.plain_int8_gemm(x, w8, sc, bb, act)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-4,
                               atol=1e-5 * float(ref.abs().max()) + 1e-5)


# the serving path's GEMMs: decode (M = 8), a prefix chunk (M = 16, the
# decode instance's largest), the prefill buckets, and the three weight
# shapes of the decoder LM (q/k/v/o, FFN in, FFN out)
INT8_SERVE = [(m, k, n) for m in (8, 16, 64, 512, 2048)
              for k, n in ((1024, 1024), (1024, 4096), (4096, 1024))]


@pytest.mark.parametrize("m,k,n", INT8_SERVE)
def test_int8_kernel_at_the_serve_shapes(dev, m, k, n):
    """Both instances at the serving ladder, against the plain fp32
    version at the card gate; the launch lands on the instance M picks."""
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    x = torch.randn(m, k, device=dev, generator=g)
    w8 = torch.randint(-127, 128, (k, n), device=dev, dtype=torch.int8,
                       generator=g)
    sc = (torch.rand(n, device=dev, generator=g) + 0.5) / 127.0
    bb = torch.randn(n, device=dev, generator=g)
    act = "relu" if m % 3 else None
    kernels.reset_launch_counts()
    out = ig.int8_weight_only_gemm(x, w8, sc, bb, act)
    ref = ig.plain_int8_gemm(x, w8, sc, bb, act)
    torch.cuda.synchronize()
    inst = ig.plan(m, n, k)[0]
    assert inst == ("decode" if m <= 16 else "prefill")
    assert kernels.int8_instance_counts()[inst] == 1
    torch.testing.assert_close(out, ref, rtol=1e-4,
                               atol=1e-5 * float(ref.abs().max()) + 1e-5)


@pytest.mark.parametrize("m,k,n", [(8, 1024, 4096), (512, 1024, 4096),
                                   (13, 4096, 1024), (100, 33, 70)])
def test_int8_rows_do_not_depend_on_the_other_rows(dev, m, k, n):
    """A row's output is the same bits whatever the other rows hold and
    wherever the row sits: no sum runs across rows (serving's bitwise
    continuous == sequential rests on it)."""
    g = torch.Generator(device=dev).manual_seed(m * n)
    x = torch.randn(m, k, device=dev, generator=g)
    w8 = torch.randint(-127, 128, (k, n), device=dev, dtype=torch.int8,
                       generator=g)
    sc = (torch.rand(n, device=dev, generator=g) + 0.5) / 127.0
    out = ig.int8_weight_only_gemm(x, w8, sc)
    other = x.clone()
    other[1:] = torch.randn(m - 1, k, device=dev, generator=g) * 100.0
    perm = torch.randperm(m, device=dev, generator=g)
    out_other = ig.int8_weight_only_gemm(other, w8, sc)
    out_perm = ig.int8_weight_only_gemm(x[perm].contiguous(), w8, sc)
    again = ig.int8_weight_only_gemm(x, w8, sc)
    torch.cuda.synchronize()
    assert torch.equal(out_other[0], out[0])
    assert torch.equal(out_perm, out[perm])
    assert torch.equal(again, out)


# BERT-base's int8 GEMMs at the inference buckets 8 and 32 (M = B * 128):
# the three projection shapes, the pooler (M = B) and the classifier
INT8_BERT_BASE = [(b * 128, k, n) for b in (8, 32)
                  for k, n in ((768, 768), (768, 3072), (3072, 768))] + \
    [(b, 768, n) for b in (8, 32) for n in (768, 2)]


@pytest.mark.parametrize("m,k,n", INT8_BERT_BASE)
def test_int8_kernel_at_the_bert_base_shapes(dev, m, k, n):
    """The weight-only int8 GEMM as an int8 BERT-base runs it (bias in
    the epilogue, as a converted fc), against plain_int8_gemm at the card
    gate, on the instance M picks."""
    g = torch.Generator(device=dev).manual_seed(m * 7 + k + n)
    x = torch.randn(m, k, device=dev, generator=g)
    w8 = torch.randint(-127, 128, (k, n), device=dev, dtype=torch.int8,
                       generator=g)
    sc = (torch.rand(n, device=dev, generator=g) + 0.5) / 127.0
    bb = torch.randn(n, device=dev, generator=g)
    kernels.reset_launch_counts()
    out = ig.int8_weight_only_gemm(x, w8, sc, bb)
    ref = ig.plain_int8_gemm(x, w8, sc, bb)
    torch.cuda.synchronize()
    assert kernels.int8_instance_counts()[ig.plan(m, n, k)[0]] == 1
    torch.testing.assert_close(out, ref, rtol=1e-4,
                               atol=1e-5 * float(ref.abs().max()) + 1e-5)


# static-quant int8_matmul through torch._int_mm: M <= 16 rows and N, K
# off the multiples of 8 are padded (the pooler at M = B, the 2-wide
# classifier), and BERT-base's projection shapes
INT8_STATIC = [(3, 768, 2), (8, 768, 768), (16, 100, 70), (17, 36, 9),
               (1024, 768, 3072), (4096, 3072, 768)]


@pytest.mark.parametrize("m,k,n", INT8_STATIC)
def test_static_int8_matmul_through_int_mm_equals_the_plain_path(dev, m, k,
                                                                n):
    """The card's static int8_matmul (quantise, torch._int_mm, epilogue)
    equals the CPU's plain exact path bit for bit, with the weight
    row-major (copied column-major for the call) and column-major (as the
    predictor lays it out): the quantisation divides by a 0-d tensor on
    both, the integer product is exact."""
    from paddle_tpu_torch.ops import quant_ops as qo

    g = torch.Generator(device=dev).manual_seed(m + 31 * k + n)
    x = torch.randn(2, m, k, device=dev, generator=g) * 2.0
    w8 = torch.randint(-127, 128, (k, n), device=dev, dtype=torch.int8,
                       generator=g)
    sy = (torch.rand(n, device=dev, generator=g) + 0.5) / 127.0
    attrs = {"act_scale": 6.5}
    calls = qo.static_int8_calls
    out = qo.int8_matmul({"X": [x], "Y": [w8], "YScale": [sy]},
                         attrs)["Out"]
    assert qo.static_int8_calls == calls + 1
    cpu = qo.int8_matmul({"X": [x.cpu()], "Y": [w8.cpu()],
                          "YScale": [sy.cpu()]}, attrs)["Out"]
    assert out.shape == (2, m, n)
    assert torch.equal(out.cpu(), cpu)
    col = qo.column_major(w8)
    assert col.stride() == (1, k) and torch.equal(col, w8)
    assert qo.column_major(col).data_ptr() == col.data_ptr()   # no copy
    again = qo.int8_matmul({"X": [x], "Y": [col], "YScale": [sy]},
                           attrs)["Out"]
    assert torch.equal(again, out)
    with pytest.raises(ValueError, match="int8 tensor"):
        qo.int8_matmul({"X": [x], "Y": [w8.float()], "YScale": [sy]}, attrs)


@pytest.mark.parametrize("static", [False, True])
def test_int8_bert_predictor_replays_its_first_run(dev, tmp_path, static):
    """A small BERT converted to int8 (weight-only, or static with the
    PTQ scales of two batches on the card), saved and loaded: the int8
    weights load int8 on the card, a replayed batch equals its op-by-op
    first run bit for bit, a weight-only replay adds one int8 GEMM launch
    per converted op, and the logits are within 2e-2 of the fp32 model's
    (int8 weights; static: int8 activations too)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import io
    from paddle_tpu_torch.contrib import slim
    from paddle_tpu_torch.inference import AnalysisConfig, create_predictor

    feeds = ["src_ids", "sent_ids", "pos_ids", "input_mask"]
    cfg, path = _bert_infer_dir(tmp_path, vocab_size=1000, hidden_size=128,
                                num_hidden_layers=2, num_attention_heads=2,
                                intermediate_size=256)
    scope = ptt.Scope()
    prog, _, fetch = io.load_inference_model(
        path, executor=ptt.Executor(device=dev), scope=scope)
    act_scales = None
    if static:
        ptq = slim.PostTrainingQuantization(
            ptt.Executor(device=dev), prog.clone(for_test=True), feeds,
            scope, [_bert_rows(cfg, 4, s) for s in (1, 2)])
        ptq.quantize()
        act_scales = ptq.calibrated_scales
    prog = slim.convert_to_int8_program(prog, scope, act_scales)
    n_int8 = sum(op.type == "int8_matmul" and not op.attrs.get("act_scale")
                 for op in prog.global_block().ops)
    assert n_int8 == (0 if static else 6 * 2 + 2)
    qpath = str(tmp_path / "int8")
    io.save_inference_model(qpath, feeds, fetch, main_program=prog,
                            scope=scope)
    pred = create_predictor(AnalysisConfig(qpath))
    int8 = [t for t in pred._params.values()
            if isinstance(t, torch.Tensor) and t.dtype == torch.int8]
    assert len(int8) == 6 * 2 + 2
    # a static weight is laid out column-major once, a weight-only one
    # stays as stored (the kernel reads it row-major)
    assert all(t.stride() == ((1, t.shape[0]) if static else (t.shape[1], 1))
               for t in int8)
    feed = _bert_rows(cfg, 4, 0)
    first, = pred.run(feed)
    kernels.reset_launch_counts()
    again, = pred.run(feed)
    assert again.tobytes() == first.tobytes()
    assert kernels.launch_counts()["int8_gemm"] == n_int8
    fp32, = create_predictor(AnalysisConfig(path)).run(feed)
    np.testing.assert_allclose(again, fp32, rtol=0, atol=2e-2)


def test_wrappers_raise_instead_of_falling_back(dev):
    x = torch.randn(4, 64, device=dev, dtype=torch.float64)
    w8 = torch.zeros(64, 32, device=dev, dtype=torch.int8)
    with pytest.raises(ValueError):
        ig.int8_weight_only_gemm(x, w8, torch.ones(32, device=dev))
    q = torch.randn(1, 8, 3 * 48, device=dev)   # head_dim 48: no instance
    with pytest.raises(ValueError):
        fa.packed_flash_fwd(q, q, q, 3, 0.1, True)
    lse = torch.zeros(1, 3, 8, device=dev)
    with pytest.raises(ValueError):
        fa.packed_flash_bwd(q, q, q, q, lse, q, 3, 0.1, True)
    p = torch.zeros(8, device=dev, dtype=torch.float16)
    one = torch.ones(1, device=dev)
    with pytest.raises(ValueError):
        fad.fused_adamw_(p, p, p.float(), p.float(), one, 0.9, 0.999, 1e-8,
                         0.01, one, one)
    with pytest.raises(ValueError):   # grad must have param's dtype
        fad.fused_adamw_(p.bfloat16(), p.float(), p.float(), p.float(), one,
                         0.9, 0.999, 1e-8, 0.01, one, one)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,h,affine", [
    (1, 1, True), (7, 100, False), (513, 1024, True), (33, 384, True),
    (64, 8192, True), (5, 3000, False)])
def test_layer_norm_kernel_matches_plain(dev, dtype, rows, h, affine):
    g = torch.Generator(device=dev).manual_seed(rows * h)
    x = (torch.randn(rows, h, device=dev, generator=g) * 2 + 0.5).to(dtype)
    sc = torch.rand(h, device=dev, generator=g) + 0.5 if affine else None
    bi = torch.randn(h, device=dev, generator=g) if affine else None
    before = ln.launches
    y, mean, rstd = ln.layer_norm_fwd(x, sc, bi, 1e-5)
    # bf16: against the plain version run in fp32 on the same values and
    # rounded once (one bf16 ulp + 1e-3)
    ry, rmean, rrstd = ln.plain_layer_norm(x.float(), sc, bi, 1e-5)
    torch.cuda.synchronize()
    assert ln.launches == before + 1 and y.dtype == dtype
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 \
        else dict(rtol=2 ** -7, atol=1e-3)
    torch.testing.assert_close(y.float(), ry.to(dtype).float(), **tol)
    torch.testing.assert_close(mean, rmean, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rstd, rrstd, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [1000, 1024, 4096, 8192])
@pytest.mark.parametrize("rows", [1, 7, 1500, 20480])
def test_layer_norm_kernel_at_the_path_widths(dev, dtype, rows, h):
    """The widths of the port's layer norms (1024: ERNIE-large and the
    decoder LM; 4096 and 8192: FFN-wide rows; 1000: not a multiple of
    the 256-thread block) at 1 to 20480 rows, with scale and bias."""
    g = torch.Generator(device=dev).manual_seed(rows + h)
    x = (torch.randn(rows, h, device=dev, generator=g) * 2 + 0.5).to(dtype)
    sc = torch.rand(h, device=dev, generator=g) + 0.5
    bi = torch.randn(h, device=dev, generator=g)
    before = ln.launches
    y, mean, rstd = ln.layer_norm_fwd(x, sc, bi, 1e-5)
    ry, rmean, rrstd = ln.plain_layer_norm(x.float(), sc, bi, 1e-5)
    torch.cuda.synchronize()
    assert ln.launches == before + 1
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 \
        else dict(rtol=2 ** -7, atol=1e-3)
    torch.testing.assert_close(y.float(), ry.to(dtype).float(), **tol)
    torch.testing.assert_close(mean, rmean, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rstd, rrstd, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,h,w,c,co", [
    (2, 14, 14, 256, 256), (3, 7, 9, 16, 4), (1, 5, 5, 32, 68),
    (5, 3, 3, 48, 132)])
def test_conv_bn_relu_kernel_matches_plain(dev, n, h, w, c, co):
    g = torch.Generator(device=dev).manual_seed(n * h * c + co)
    x = (torch.randn(n, h, w, c, device=dev, generator=g) * 0.5).bfloat16()
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1)).contiguous()
    wt = (torch.randn(3, 3, c, co, device=dev, generator=g) * 0.05) \
        .bfloat16()
    sc = torch.randn(co, device=dev, generator=g) * 0.1 + 1.0
    sh = torch.randn(co, device=dev, generator=g) * 0.1
    before = cbr.launches
    out = cbr.conv_bn_relu(xp, wt, sc, sh)
    ref = cbr.plain_conv_bn_relu(xp, wt, sc, sh)
    torch.cuda.synchronize()
    assert cbr.launches == before + 1 and out.shape == (n, h, w, co)
    # both sum the bf16 products in fp32 and round once
    torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7,
                               atol=1e-3)


def test_new_kernels_refuse_what_they_cannot_read(dev):
    with pytest.raises(ValueError):     # wider than the kernel's row
        ln.layer_norm_fwd(torch.zeros(2, ln.MAX_H + 1, device=dev), None,
                          None, 1e-5)
    with pytest.raises(ValueError):     # fp16 has no instance
        ln.layer_norm_fwd(torch.zeros(2, 8, device=dev).half(), None, None,
                          1e-5)
    xp = torch.zeros(1, 6, 6, 24, device=dev, dtype=torch.bfloat16)
    one = torch.ones(8, device=dev)
    with pytest.raises(ValueError):     # C not a multiple of 16
        cbr.conv_bn_relu(xp, torch.zeros(3, 3, 24, 8, device=dev,
                                         dtype=torch.bfloat16), one, one)
    xp = torch.zeros(1, 6, 6, 32, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 32, 8, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):     # a strided NHWC view
        cbr.conv_bn_relu(xp.permute(0, 2, 1, 3), w, one, one)
    with pytest.raises(ValueError):     # fp32 input
        cbr.conv_bn_relu(xp.float(), w, one, one)


def test_ernie_tiny_trains_on_card_as_on_cpu(dev):
    """ERNIE-tiny, fp32: 3 steps on the card and on the CPU from one
    state: the same dropout masks bit for bit, losses within 1e-4, and
    per step one flash forward + backward per layer and one AdamW launch
    per parameter."""
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig(vocab_size=512, hidden_size=128,
                          num_hidden_layers=2, num_attention_heads=2,
                          intermediate_size=512, max_position_embeddings=64,
                          use_flash_attention=True)
    with unique_name.guard():
        main, startup, _, fetches = bert.build_pretraining_program(
            cfg, seq_len=64, max_predictions_per_seq=8)
    scope = Scope()
    Executor(device="cpu").run(startup, scope=scope)
    state = {n: (v.numpy() if isinstance(v, torch.Tensor) else v)
             for n, v in scope.items()}
    batch = bert.synthetic_pretraining_batch(cfg, 4, 64, seed=1,
                                             max_predictions_per_seq=8)
    masks = [o.outputs["Mask"][0] for o in main.global_block().ops
             if o.type == "dropout"]
    n_params = len([o for o in main.global_block().ops if o.type == "adamw"])
    runs = {}
    for device in ("cuda:0", "cpu"):
        sc = bert.scope_from_numpy(state, device)
        exe = Executor(device=device)
        kernels.reset_launch_counts()
        runs[device] = [exe.run(main, feed=batch, scope=sc,
                                fetch_list=[fetches["loss"]] + masks)
                        for _ in range(3)]
        counts = kernels.launch_counts()
        want = (6, 6, 3 * n_params) if device != "cpu" else (0, 0, 0)
        assert (counts["flash_attention_fwd"], counts["flash_attention_bwd"],
                counts["fused_adamw"]) == want
    for a, b in zip(runs["cuda:0"], runs["cpu"]):
        np.testing.assert_allclose(a[0], b[0], rtol=1e-4, atol=1e-4)
        assert all(np.array_equal(x, y) for x, y in zip(a[1:], b[1:]))


def test_each_adamw_op_of_an_ernie_step_is_one_kernel(dev):
    """ERNIE-tiny on the card: each ``adamw`` op of the program, run as
    the executor runs it, launches one CUDA kernel (torch.profiler's
    count), the AdamW kernel, which also advances its Beta1Pow and
    Beta2Pow."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.executor import Executor, run_op
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig(vocab_size=512, hidden_size=128,
                          num_hidden_layers=2, num_attention_heads=2,
                          intermediate_size=512, max_position_embeddings=64,
                          use_flash_attention=True)
    with unique_name.guard():
        main, startup, _, fetches = bert.build_pretraining_program(
            cfg, seq_len=64, max_predictions_per_seq=8)
    scope = Scope()
    exe = Executor(device="cuda:0")
    exe.run(startup, scope=scope)
    batch = bert.synthetic_pretraining_batch(cfg, 4, 64, seed=1,
                                             max_predictions_per_seq=8)
    exe.run(main, feed=batch, scope=scope, fetch_list=[fetches["loss"]])
    ops = [o for o in main.global_block().ops if o.type == "adamw"]
    assert ops
    env = dict(scope.items())
    for op in ops:
        p = env[op.inputs["Param"][0]]
        env[op.inputs["Grad"][0]] = torch.randn_like(p) * 1e-2
        want = env[op.inputs["Beta1Pow"][0]].cpu() * float(op.attrs["beta1"])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run_op(op, env)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        assert len(names) == 1 and "adamw" in names[0], names
        got = env[op.outputs["Beta1PowOut"][0]].cpu()
        assert got.numpy().tobytes() == want.numpy().tobytes()


def test_engine_on_card_uses_kernels_and_batches_bitwise(dev):
    from paddle_tpu_torch.models.decoder_lm import (DecoderLMConfig,
                                                    decoder_lm_params)
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    cfg = DecoderLMConfig(vocab_size=256, d_model=128, n_head=2, n_layers=2,
                          d_inner=256, max_seq_len=64)
    params = decoder_lm_params(cfg, 1)
    rng = np.random.RandomState(0)
    reqs = [dict(prompt=rng.randint(3, 250, n).astype(np.int32),
                 max_new_tokens=8, stop_at_eos=False) for n in (3, 20, 40)]
    outs = {}
    for device in ("cuda:0", "cpu"):
        eng = DecodeEngine(cfg, params, DecodeConfig(
            max_slots=4, page_size=8, kv_pages=32, weight_quant="int8"),
            device=device)
        kernels.reset_launch_counts()
        eng.start()
        try:
            hs = [eng.submit(**r) for r in reqs]
            together = [h.result(timeout=120) for h in hs]
            alone = [eng.generate(timeout=120, **r) for r in reqs]
        finally:
            eng.close()
        assert all(np.array_equal(a, b) for a, b in zip(together, alone))
        counts = kernels.launch_counts()
        serving = ("flash_attention_fwd", "paged_attention", "int8_gemm")
        assert all(counts[k] > 0 for k in serving) == (device != "cpu")
        outs[device] = together
    for a, b in zip(outs["cuda:0"], outs["cpu"]):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the compiled step: the seed on the device, CUDA graphs of whole steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_seed_by_pointer_gives_the_int_seeds_masks(dev, dtype):
    """The flash kernels read the seed through a pointer: a 0-d int64
    tensor gives the int seed's output bit for bit, and one forward and
    one backward captured into a CUDA graph draw, on each replay, the
    mask of the seed the tensor holds then (q = k = v = 0 and one-hot v
    or do read the mask exactly, as in the tests above)."""
    b, s, n, hd, rate = 2, 128, 2, 64, 0.25
    zero = torch.zeros(b, s, n * hd, device=dev, dtype=dtype)
    lse = torch.full((b, n, s), float(np.log(s)), device=dev)
    eye = torch.zeros(b, s, n, hd, device=dev, dtype=dtype)
    eye[:, :hd] = torch.eye(hd, device=dev, dtype=dtype)[None, :, None]
    eye = eye.reshape(b, s, n * hd)
    seed_t = torch.zeros((), dtype=torch.int64, device=dev)
    for seed in (5, 2 ** 31 + 7, rng.M32):
        seed_t.fill_(seed)
        for tensor_seed in (seed_t, seed_t.to(torch.int32)):
            a = fa.packed_flash_fwd(zero, zero, eye, n, 1.0, False, None,
                                    rate, tensor_seed)[0]
            b_ = fa.packed_flash_fwd(zero, zero, eye, n, 1.0, False, None,
                                     rate, seed)[0]
            assert torch.equal(a, b_)
    capture = torch.cuda.Stream()
    capture.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=capture):
        out = fa.packed_flash_fwd(zero, zero, eye, n, 1.0, False, None,
                                  rate, seed_t)[0]
        dv = fa.packed_flash_bwd(zero, zero, zero, zero, lse, eye, n, 1.0,
                                 False, None, rate, seed_t)[2]
    for seed in (11, 987654321, 3735928559):
        seed_t.fill_(seed)
        graph.replay()
        torch.cuda.synchronize()
        want = rng.attn_keep(seed, rate, b, n, s, s, dev)
        got = out.reshape(b, s, n, hd).permute(0, 2, 1, 3) != 0
        assert torch.equal(got, want[..., :hd])
        got = dv.reshape(b, s, n, hd).permute(0, 2, 3, 1) != 0
        assert torch.equal(got, want[:, :, :hd])


def _tiny_ernie(dtype="float32"):
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig(vocab_size=512, hidden_size=128,
                          num_hidden_layers=2, num_attention_heads=2,
                          intermediate_size=512, max_position_embeddings=64,
                          use_flash_attention=True, dtype=dtype)
    with unique_name.guard():
        main, startup, _, fetches = bert.build_pretraining_program(
            cfg, seq_len=64, max_predictions_per_seq=8)
    scope = Scope()
    Executor(device="cpu").run(startup, scope=scope)
    state = {n: (v.numpy() if isinstance(v, torch.Tensor)
                 and v.dtype != torch.bfloat16 else
                 (v.view(torch.int16).numpy().view(np.uint16), "bfloat16")
                 if isinstance(v, torch.Tensor) else v)
             for n, v in scope.items()}
    batch = bert.synthetic_pretraining_batch(cfg, 4, 64, seed=1,
                                             max_predictions_per_seq=8)
    masks = [o.outputs["Mask"][0] for o in main.global_block().ops
             if o.type == "dropout"]
    return main, state, batch, [fetches["loss"].name] + masks


def _ernie_steps(main, state, batch, fetch, use_compiled, steps=4):
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.models import bert

    scope = bert.scope_from_numpy(state, "cuda:0")
    exe = Executor(device="cuda:0")
    kernels.reset_launch_counts()
    outs = [exe.run(main, feed=batch, scope=scope, fetch_list=fetch,
                    use_compiled=use_compiled) for _ in range(steps)]
    return outs, kernels.snapshot_counts()


def _ernie_layer_program(dtype):
    """Two ERNIE encoder layers (hidden 128, 2 heads of 64, FFN 512,
    packed flash attention with dropout 0.1, hidden dropout 0.1, layer
    norms) on a fed [4, 64, 128] input and key mask, loss mean(y^2),
    AdamW: an ERNIE layer step without the embedding lookups."""
    from paddle_tpu_torch import layers, optimizer
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.ir import Program, program_guard
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig(hidden_size=128, num_attention_heads=2,
                          intermediate_size=512, use_flash_attention=True,
                          dtype=dtype)
    main, startup = Program(), Program()
    with unique_name.guard(), program_guard(main, startup):
        x = layers.static_data("x", [4, 64, 128], dtype)
        mask = layers.static_data("mask", [4, 64], "float32")
        bias = bert._attn_bias_from_mask(mask)
        y = x
        for i in range(2):
            y = bert._encoder_layer(y, bias, cfg, f"layer_{i}")
        y = layers.cast(y, "float32")
        loss = layers.mean(layers.elementwise_mul(y, y))
        optimizer.AdamWOptimizer(1e-3, weight_decay=0.01).minimize(loss)
    scope = Scope()
    Executor(device="cpu").run(startup, scope=scope)
    r = np.random.RandomState(0)
    feed = {"x": r.randn(4, 64, 128).astype(np.float32),
            "mask": (r.rand(4, 64) > 0.2).astype(np.float32)}
    masks = [o.outputs["Mask"][0] for o in main.global_block().ops
             if o.type == "dropout"]
    return main, dict(scope.items()), feed, [loss.name] + masks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_captured_ernie_layer_step_replays_to_the_eager_bits(dev, dtype):
    """Two ERNIE layers on the card, 5 steps op by op and 5 compiled (the
    second run captures, the later ones replay) from one state: the
    losses, the dropout masks and every parameter, moment and beta power
    after the steps bit for bit, the masks new each step, and the same
    launches, by kernel, layout and instance."""
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope

    main, state, feed, fetch = _ernie_layer_program(dtype)
    runs = {}
    for comp in (False, True):
        scope = Scope()
        for n, v in state.items():
            scope.set(n, v.to(dev) if isinstance(v, torch.Tensor) else v)
        exe = Executor(device=dev)
        kernels.reset_launch_counts()
        outs = [exe.run(main, feed=feed, scope=scope, fetch_list=fetch,
                        use_compiled=comp) for _ in range(5)]
        runs[comp] = (outs, scope, kernels.snapshot_counts())
    (eager, es, ec), (comp, cs, cc) = runs[False], runs[True]
    assert cc == ec and ec["flash_attention_fwd"] == 10
    for a, b in zip(eager, comp):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(comp[2][1], comp[3][1])
    names = [n for n, v in state.items() if isinstance(v, torch.Tensor)]
    assert len(names) > 40
    for n in names:
        assert torch.equal(cs.find_var(n), es.find_var(n)), n


def test_compiled_launch_counts_per_replay(dev):
    """Each replay adds the captured step's launches: 5 compiled steps
    count 5 times one op-by-op step, by kernel, layout and instance."""
    main, state, batch, fetch = _tiny_ernie()
    _, one = _ernie_steps(main, state, batch, fetch, False, 1)
    _, five = _ernie_steps(main, state, batch, fetch, True, 5)
    assert five == {k: 5 * v for k, v in one.items()}
    assert five["flash_attention_fwd"] == five["flash_attention_bwd"] == 10
    assert five[("launches_by_layout", "packed")] == 10
    assert five[("bwd_launches_by_dtype", "fp32_tf32x3")] == 10


def test_batch_norm_state_is_written_back_on_the_card(dev):
    """Tiny ResNet-50 compiled on the card: the running statistics,
    written out of place by the lowering, land in the tensors the scope
    held when the step was captured, step after step, at the op-by-op
    values (within 1e-4 of the largest magnitude: cuDNN's backward sums
    in its own order)."""
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.models import resnet

    cfg = resnet.ResNetConfig(50, 10, (3, 32, 32), stages=[1, 1, 1, 1])
    with unique_name.guard():
        main, startup, _, fetches = resnet.build_classifier_program(
            cfg, batch_size=4, amp=False, lr=0.01)
    batch = resnet.synthetic_batch(cfg, 4, seed=2)
    sc = Scope()
    Executor(device="cpu").run(startup, scope=sc)
    state = {n: v for n, v in sc.items()}
    stats = [o.outputs["MeanOut"][0] for o in main.global_block().ops
             if o.type in ("batch_norm", "fused_bn_add_act")]
    scopes = {}
    for comp in (False, True):
        scope = Scope()
        for n, v in state.items():
            scope.set(n, v.to(dev) if isinstance(v, torch.Tensor) else v)
        exe = Executor(device=dev)
        exe.run(main, feed=batch, fetch_list=[fetches["loss"]], scope=scope,
                use_compiled=comp)
        held = {n: scope.find_var(n) for n in stats}
        for _ in range(3):
            before = {n: t.clone() for n, t in held.items()}
            exe.run(main, feed=batch, fetch_list=[fetches["loss"]],
                    scope=scope, use_compiled=comp)
            if comp:
                for n, t in held.items():
                    assert scope.find_var(n) is t
                    assert not torch.equal(t, before[n]), n
        scopes[comp] = scope
    for n in stats:
        a, b = scopes[False].find_var(n), scopes[True].find_var(n)
        tol = 1e-4 * max(1.0, float(a.abs().max()))
        assert float((a - b).abs().max()) <= tol, n


def test_decode_graphs_replay_beside_eager_calls(dev):
    """The engine's captured prefill and step programs, replayed between
    op-by-op runs of the same programs on a copy of the pools: the same
    logits bit for bit, and the launches of a replay counted."""
    from paddle_tpu_torch.core.executor import run_block
    from paddle_tpu_torch.models.decoder_lm import (DecoderLMConfig,
                                                    decoder_lm_params)
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    cfg = DecoderLMConfig(vocab_size=256, d_model=128, n_head=2, n_layers=2,
                          d_inner=256, max_seq_len=64)
    eng = DecodeEngine(cfg, decoder_lm_params(cfg, 3), DecodeConfig(
        max_slots=2, page_size=8, kv_pages=24, prefill_buckets=[32]),
        device=dev)
    assert eng.warmup() == 2
    pools = {n: t.clone() for n, t in eng._pools.items()}
    r = np.random.RandomState(2)
    table = np.zeros((1, eng._mp), np.int32)
    table[0, :3] = [1, 2, 3]
    tokens = np.zeros((1, 32), np.int32)
    tokens[0, :20] = r.randint(3, 256, 20)
    oh = np.zeros((1, 32), np.float32)
    oh[0, 19] = 1.0
    feeds = [("prefill", 32, {"tokens": tokens, "lengths":
                              np.array([20], np.int32), "last_onehot": oh,
                              "page_table": table})]
    for pos in (20, 21, 22):
        t2 = np.zeros((2, eng._mp), np.int32)
        t2[0] = table[0]
        feeds.append(("step", 2, {
            "tokens": np.array([r.randint(3, 256), 0], np.int32),
            "positions": np.array([pos, 0], np.int32), "page_table": t2}))
    for phase, bucket, feed in feeds:
        kernels.reset_launch_counts()
        got = eng._run(phase, bucket, feed)
        counts = kernels.launch_counts()
        env = dict(eng._params, **pools)
        env.update({n: torch.from_numpy(v).to(dev) for n, v in feed.items()})
        kernels.reset_launch_counts()
        run_block(eng._block(phase, bucket), env)
        assert kernels.launch_counts() == counts
        assert np.array_equal(got, env["logits"].cpu().numpy())
    eng.close()


def test_prefix_hit_equals_cold_and_chunk_replay_equals_eager(dev):
    """The prefix-sharing path at a small width on the card: a prefix hit
    gives the cold run's ids bit for bit (greedy and sampled), and the
    captured chunk program, replayed, gives an op-by-op run's logits and
    pool writes bit for bit on a copy of the pools, as does the engine's
    chunk loop over feeds already on the card."""
    from paddle_tpu_torch.core.executor import run_block
    from paddle_tpu_torch.models.decoder_lm import (DecoderLMConfig,
                                                    decoder_lm_params)
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    cfg = DecoderLMConfig(vocab_size=256, d_model=128, n_head=2, n_layers=2,
                          d_inner=256, max_seq_len=64)

    def engine():
        eng = DecodeEngine(cfg, decoder_lm_params(cfg, 3), DecodeConfig(
            prefix_cache=True, max_slots=2, page_size=8, kv_pages=24,
            prefill_buckets=[32]), device=dev)
        assert eng.warmup() == 3            # step, prefill 32, chunk 8
        return eng

    r = np.random.RandomState(6)
    system = r.randint(3, 256, 17)
    prompts = [np.concatenate([system, r.randint(3, 256, n)]).astype(
        np.int32) for n in (3, 11)]
    kw = [dict(max_new_tokens=8), dict(max_new_tokens=8, temperature=0.8,
                                       seed=5, stop_at_eos=False)]
    warm = engine().start()
    try:
        hits = [np.asarray(warm.generate(prompts[0], timeout=120, **kw[0]))]
        hits += [np.asarray(warm.generate(p, timeout=120, **k_))
                 for p, k_ in zip(prompts[1:], kw[1:])]
        assert warm.stats()["prefix_store"]["prefix_hits"] >= 1
        assert warm.pool.audit(owned=warm.prefix_store.owned_pages()) == []
    finally:
        warm.close()
    for p, k_, hit in zip(prompts, kw, hits):
        cold = engine().start()
        try:
            assert np.array_equal(
                np.asarray(cold.generate(p, timeout=120, **k_)), hit)
        finally:
            cold.close()

    eng = engine()
    pools = {n: t.clone() for n, t in eng._pools.items()}
    table = np.zeros((1, eng._mp), np.int32)
    table[0, :3] = [4, 5, 6]
    for lo, n in ((0, 8), (8, 8), (16, 3)):
        tokens = np.zeros((1, 8), np.int32)
        tokens[0, :n] = prompts[1][lo:lo + n]
        oh = np.zeros((1, 8), np.float32)
        oh[0, n - 1] = 1.0
        feed = {"tokens": tokens,
                "positions": (lo + np.arange(8, dtype=np.int32))[None, :],
                "chunk_start": np.array([lo], np.int32),
                "lengths": np.array([n], np.int32), "last_onehot": oh,
                "page_table": table}
        got = eng._run("chunk", 8, feed)
        env = dict(eng._params, **pools)
        env.update({k_: torch.from_numpy(v).to(dev) for k_, v in feed.items()})
        run_block(eng._block("chunk", 8), env)
        assert np.array_equal(got, env["logits"].cpu().numpy())
        for name, pool in eng._pools.items():
            assert torch.equal(pool, env[name + "_out"]), name
    # the engine's own loop (the feeds sent once, sliced on the device,
    # only the last logits read) gives the same logits and pools
    again = engine()
    last = again._run_chunks(again._chunk_feeds(prompts[1][:19], table[0],
                                                0))
    assert np.array_equal(last, got)
    for name, pool in again._pools.items():
        assert torch.equal(pool, eng._pools[name]), name
    again.close()
    eng.close()


def test_serve_decode_over_http_equals_in_process(dev, tmp_path):
    """serve_decode on the card at a small width: ids over HTTP (greedy
    and sampled, at once) are the in-process engine's bit for bit, the
    kernels launched, and a decode-role engine behind a prefill server
    (the shipment fetched and installed) gives the same ids with no flash
    forward launch of its own."""
    import json
    import urllib.request

    from paddle_tpu_torch.models.decoder_lm import (DecoderLMConfig,
                                                    decoder_lm_params,
                                                    save_decoder_lm)
    from paddle_tpu_torch.serving import (DecodeConfig, DecodeEngine,
                                          serve_decode)

    cfg = DecoderLMConfig(vocab_size=256, d_model=128, n_head=2, n_layers=2,
                          d_inner=256, max_seq_len=64)
    params = decoder_lm_params(cfg, 4)
    save_decoder_lm(str(tmp_path), cfg, params)
    conf = dict(max_slots=4, page_size=8, kv_pages=32)
    rng = np.random.RandomState(2)
    reqs = [dict(prompt=rng.randint(3, 250, n).astype(np.int32),
                 max_new_tokens=8, stop_at_eos=False) for n in (3, 20, 40)]
    reqs[1].update(temperature=0.8, seed=9)
    eng = DecodeEngine(cfg, params, DecodeConfig(**conf), device=dev).start()
    try:
        want = [eng.generate(timeout=120, **r).tolist() for r in reqs]
    finally:
        eng.close()

    def post(url, r):
        body = dict(prompt_ids=r["prompt"].tolist(),
                    **{k_: v for k_, v in r.items() if k_ != "prompt"})
        req = urllib.request.Request(
            url + "/v1/generate", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.loads(resp.read())["tokens"]

    srv = serve_decode(str(tmp_path), config=DecodeConfig(**conf),
                       device=dev)
    try:
        kernels.reset_launch_counts()
        got = [None] * len(reqs)
        threads = [threading.Thread(target=lambda i=i: got.__setitem__(
            i, post(srv.url, reqs[i]))) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        counts = kernels.launch_counts()
        assert got == want
        assert counts["flash_attention_fwd"] > 0
        assert counts["paged_attention"] > 0
        decode = DecodeEngine(cfg, params, DecodeConfig(
            role="decode", prefill_urls=srv.url, **conf), device=dev)
        decode.start(warmup=True)
        try:
            installs0 = telemetry.counter_get("disagg.installs")
            before = kernels.launch_counts()["flash_attention_fwd"]
            hs = [decode.submit(**r) for r in reqs]
            shipped = [h.result(timeout=120).tolist() for h in hs]
            # the prefill server's flash launches count in this process
            # too: one prefill of 2 layers a request, none of the engine's
            assert kernels.launch_counts()["flash_attention_fwd"] - \
                before == cfg.n_layers * len(reqs)
            assert telemetry.counter_get("disagg.installs") - installs0 \
                == len(reqs)
        finally:
            decode.close()
        assert shipped == want
    finally:
        srv.decode_engine.close()
        srv.shutdown()


# Transformer-big's attention (tools/bench_models.py bench_transformer_big:
# b48 s256, 16 heads of 64, bf16, dropout 0.1): the decoder's causal
# self-attention with no bias, and cross-attention (q from the decoder, k
# and v from the encoder) under the source key-padding bias, (mask - 1) *
# 1e9 with 128 to 256 live keys a row, as models.transformer's
# synthetic_batch makes them
def _wmt_attention(dev, cross):
    b, s, n, hd = 48, 256, 16, 64
    g = torch.Generator(device=dev).manual_seed(48 + cross)
    q, k, v, do = (torch.randn(b, s, n * hd, device=dev, generator=g)
                   .bfloat16() for _ in range(4))
    bias = None
    if cross:
        lens = torch.randint(s // 2, s + 1, (b,), device=dev, generator=g)
        live = torch.arange(s, device=dev)[None, :] < lens[:, None]
        bias = (live.float() - 1.0) * 1e9
    return q, k, v, do, bias, n, hd ** -0.5


@pytest.mark.parametrize("cross", [False, True])
def test_flash_at_the_transformer_big_shapes(dev, cross):
    q, k, v, do, bias, n, scale = _wmt_attention(dev, cross)
    causal = not cross
    kernels.reset_launch_counts()
    out, lse = fa.flash_fwd(q, k, v, n, scale, causal, bias, 0.1, 7)
    ref_out, ref_lse = fa.plain_flash_fwd(*_f32(q, k, v), n, scale, causal,
                                          bias, 0.1, 7)
    saved = ref_out.bfloat16()
    grads = fa.flash_bwd(q, k, v, saved, ref_lse, do, n, scale, causal, bias,
                         0.1, 7)
    ref = fa.plain_flash_bwd(*_f32(q, k, v), saved.float(), ref_lse,
                             do.float(), n, scale, causal, bias, 0.1, 7)
    torch.cuda.synchronize()
    assert kernels.dtype_counts() == {
        k_: {"fp32_tf32x3": 0, "bf16_wgmma": 1}
        for k_ in ("flash_attention_fwd", "flash_attention_bwd")}
    torch.testing.assert_close(out.float(), saved.float(),
                               **TOL[torch.bfloat16])
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
    for name, a, r in zip(("dq", "dk", "dv"), grads[:3], ref[:3]):
        torch.testing.assert_close(a.float(), r.bfloat16().float(),
                                   msg=lambda m: f"{name}: {m}",
                                   **TOL[torch.bfloat16])
    if cross:
        torch.testing.assert_close(grads[3], ref[3], rtol=1e-3, atol=1e-3)
    else:
        assert grads[3] is None


SCHEDULE_ATTRS = (
    {"schedule": "noam", "d_model": 1024, "warmup_steps": 4,
     "learning_rate": 2.0},
    {"schedule": "exponential", "learning_rate": 0.1, "decay_steps": 2,
     "decay_rate": 0.5, "staircase": True},
    {"schedule": "natural_exp", "learning_rate": 0.1, "decay_steps": 3,
     "decay_rate": 0.3, "staircase": False},
    {"schedule": "inverse_time", "learning_rate": 0.2, "decay_steps": 2,
     "decay_rate": 0.5, "staircase": False},
    {"schedule": "polynomial", "learning_rate": 0.1, "decay_steps": 3,
     "end_learning_rate": 1e-4, "power": 2.0, "cycle": True},
    {"schedule": "piecewise", "boundaries": [2.0, 4.0],
     "values": [1.0, 0.5, 0.25]},
    {"schedule": "cosine", "learning_rate": 0.1, "step_each_epoch": 2,
     "epochs": 5},
    {"schedule": "linear_warmup", "warmup_steps": 3, "start_lr": 0.0,
     "end_lr": 0.1, "base_lr": 0.05})


def test_lr_ops_capture_in_a_graph_without_a_host_sync(dev):
    """increment, every lr_schedule branch and one_hot recorded into one
    CUDA graph (a host sync or a host-to-device copy fails the capture)
    and replayed: each replay advances the counter on the card and gives
    the CPU lowerings' rates at that step and the same one-hot rows."""
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.core.graph import StepGraph

    inc, sched, one_hot = (registry.get(t).forward for t in (
        "increment", "lr_schedule", "one_hot"))
    counter = torch.full((1,), -1.0, device=dev)
    ids = torch.randint(0, 96, (2, 32, 1), dtype=torch.int32, device=dev)

    def step():
        counter.copy_(inc({"X": [counter]}, {"step": 1.0})["Out"])
        rates = [sched({"Step": [counter]}, dict(a))["Out"]
                 for a in SCHEDULE_ATTRS]
        return rates + [one_hot({"X": [ids]}, {"depth": 96})["Out"]]

    graph = StepGraph(step, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph.capture()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(counter) == -1.0            # a capture runs nothing
    want_hot = one_hot({"X": [ids.cpu()]}, {"depth": 96})["Out"]
    for k in range(7):
        outs = graph.replay()
        torch.cuda.synchronize()
        assert float(counter) == float(k)
        step_k = torch.tensor([float(k)])
        for a, got in zip(SCHEDULE_ATTRS, outs[:-1]):
            want = sched({"Step": [step_k]}, dict(a))["Out"]
            torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=0,
                                       msg=lambda m: f"{a['schedule']}@{k}")
        assert torch.equal(outs[-1].cpu(), want_hot)


@pytest.mark.parametrize("shape,vocab,high,d,dtype", [
    ((48, 256), 32000, 32000, 1024, torch.float32),
    ((48, 256), 32000, 64, 1024, torch.float32),
    ((40, 512), 512, 512, 1024, torch.bfloat16),
    ((40, 512), 4, 2, 1024, torch.bfloat16),
    ((2, 32), 96, 96, 128, torch.float32)])
def test_lookup_table_gradient_is_the_same_bits_every_run(dev, shape, vocab,
                                                          high, d, dtype):
    """lookup_table_v2's gradient into its table at Transformer-big's
    shape (12288 ids into [32000, 1024]) and with those ids crowded onto
    64 rows, at ERNIE-large's position and sentence tables (20480 ids, bf16,
    on 512 rows and on 2) and at the tiny tests' width: two eager runs and
    two replays of a graph captured with no host sync give the same bits.
    Against a float64 scatter-add of the same values on the CPU: rtol one
    rounding of the table's dtype (1e-5 fp32, 2^-8 bf16), atol 2e-7 times
    the most ids a row takes (fp32 sums of unit normals in another
    order)."""
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.core.graph import StepGraph

    lookup = registry.get("lookup_table_v2").forward
    g = torch.Generator(device=dev).manual_seed(high)
    w = torch.randn(vocab, d, device=dev, generator=g).to(dtype)
    w.requires_grad_()
    ids = torch.randint(0, high, shape, device=dev, generator=g,
                        dtype=torch.int32)
    dy = torch.randn(*shape, d, device=dev, generator=g).to(dtype)

    def grad():
        out = lookup({"W": [w], "Ids": [ids]}, {})["Out"]
        return [torch.autograd.grad(out, w, dy)[0]]

    eager = [grad()[0] for _ in range(2)]
    graph = StepGraph(grad, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph.capture()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    replays = [graph.replay()[0].clone() for _ in range(2)]
    for got in eager[1:] + replays:
        assert torch.equal(got, eager[0])
    flat = ids.cpu().reshape(-1).long()
    want = torch.zeros(vocab, d, dtype=torch.float64).index_add_(
        0, flat, dy.cpu().reshape(-1, d).double())
    most = int(torch.bincount(flat).max())
    torch.testing.assert_close(
        eager[0].cpu().double(), want, atol=2e-7 * most,
        rtol=1e-5 if dtype == torch.float32 else 2 ** -8)


def test_compiled_wmt_step_advances_the_learning_rate(dev):
    """The WMT program at a tiny width (2+2 layers, d_model 128, 2 heads of
    64, vocab 96, s32, batch 2, bf16 AMP, noam over 4000 steps) run 6
    times through Executor: the first op by op, then one capture and
    replays. The rate fetched at run k is the noam formula at step k: the
    graph advances the device counter on every replay. One compiled step
    is built, and each run launches 6 flash forwards and 6 backwards."""
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.executor import Executor, _CompiledStep
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.models import transformer

    cfg = transformer.transformer_big()
    for k_, v_ in dict(n_encoder_layers=2, n_decoder_layers=2, d_model=128,
                       n_head=2, d_inner=256, src_vocab_size=96,
                       tgt_vocab_size=96).items():
        setattr(cfg, k_, v_)
    with unique_name.guard():
        main, startup, _, fetches = transformer.build_wmt_program(
            cfg, seq_len=32, amp=True)
    lr = next(o for o in main.global_block().ops
              if o.type == "lr_schedule").outputs["Out"][0]
    exe, scope = Executor(device=dev), Scope()
    exe.run(startup, scope=scope)
    batch = transformer.synthetic_batch(cfg, 2, 32, seed=1)
    kernels.reset_launch_counts()
    runs = [exe.run(main, feed=batch, scope=scope,
                    fetch_list=[fetches["loss"], lr]) for _ in range(6)]
    assert exe.compiled_builds == 1
    (step,) = [s for per_scope in exe._compiled[main].values()
               for s in per_scope.values() if isinstance(s, _CompiledStep)]
    assert step.graph.graph is not None             # captured, replayed
    for k, (loss, got) in enumerate(runs):
        s = np.float32(k + 1)
        want = np.float32(2.0 * 128 ** -0.5) * min(
            s ** np.float32(-0.5), s * np.float32(4000 ** -1.5))
        np.testing.assert_allclose(got, [want], rtol=1e-6)
        assert np.isfinite(np.asarray(loss, np.float32)).all()
    assert float(scope.find_var("@LR_DECAY_COUNTER@").cpu()[0]) == 5.0
    counts = kernels.launch_counts()
    assert (counts["flash_attention_fwd"],
            counts["flash_attention_bwd"]) == (36, 36)


def _bert_infer_dir(tmp_path, **cfg_kw):
    """A BERT inference dir (NSP logits) built and saved by the port, its
    weights from the startup program on the card."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import io
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig(**cfg_kw)
    # a fresh name generator: the NSP logits are fc_0.tmp_1
    old = unique_name.switch()
    try:
        main, startup, _, _ = bert.build_pretraining_program(
            cfg, seq_len=128, with_optimizer=False, is_test=True)
    finally:
        unique_name.switch(old)
    scope = ptt.Scope()
    ptt.Executor(device="cuda:0").run(startup, scope=scope,
                                      use_compiled=False)
    path = str(tmp_path / "bert")
    io.save_inference_model(path, ["src_ids", "sent_ids", "pos_ids",
                                   "input_mask"], ["fc_0.tmp_1"],
                            main_program=main, scope=scope)
    return cfg, path


def _bert_rows(cfg, n, seed):
    rng = np.random.RandomState(seed)
    lens = rng.randint(16, 129, n)[:, None]
    mask = np.arange(128)[None, :] < lens
    return {"src_ids": (rng.randint(1, cfg.vocab_size, (n, 128)) * mask)
            .astype(np.int64),
            "sent_ids": (rng.randint(0, 2, (n, 128)) * mask).astype(np.int64),
            "pos_ids": np.tile(np.arange(128), (n, 1)).astype(np.int64),
            "input_mask": mask.astype(np.float32)}


def test_predictor_bnsd_flash_launches_equal_the_traced_kernels(dev,
                                                                tmp_path):
    """The passes put one bnsd flash_attention op a layer on the path;
    a replayed batch runs one split-TF32 flash forward kernel a layer, as
    many as the launch counters add for it, and the graph's output equals
    its op-by-op first run."""
    from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
    from paddle_tpu_torch.tools.profile_train import traced

    cfg, path = _bert_infer_dir(tmp_path, vocab_size=1000, hidden_size=128,
                                num_hidden_layers=3, num_attention_heads=2,
                                intermediate_size=256)
    pred = create_predictor(AnalysisConfig(path))
    feed = _bert_rows(cfg, 4, 0)
    first, = pred.run(feed)                  # op by op, then captured
    kernels.reset_launch_counts()
    trace = traced(lambda: pred.run(feed), 1)
    layers = cfg.num_hidden_layers
    assert trace["traced_launches"]["flash_attention_fwd"] == layers
    assert kernels.launch_counts()["flash_attention_fwd"] == layers
    assert kernels.layout_counts()["flash_attention_fwd"]["bnsd"] == layers
    assert kernels.dtype_counts()["flash_attention_fwd"][
        "fp32_tf32x3"] == layers
    again, = pred.run(feed)
    assert again.tobytes() == first.tobytes()
    cpu, = create_predictor(AnalysisConfig(path), device="cpu").run(feed)
    np.testing.assert_allclose(again, cpu, rtol=0, atol=1e-4)


def test_bert_base_engine_response_against_the_unbatched_run(dev, tmp_path):
    """BERT-base behind the engine on the card: each response equals the
    predictor's run of its rows padded to the bucket it was served at, bit
    for bit, and its unbatched run within 1e-5 with the same argmax
    (cuBLAS picks its GEMMs by M, so the reference's bit-for-bit promise
    against the unbatched run does not hold here)."""
    from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    cfg, path = _bert_infer_dir(tmp_path)
    ref = create_predictor(AnalysisConfig(path))
    engine = ServingEngine(create_predictor(AnalysisConfig(path)),
                           ServingConfig(max_batch_size=8,
                                         batch_timeout_ms=20.0))
    feeds = [_bert_rows(cfg, n, i) for i, n in enumerate((1, 3, 2, 4, 1))]
    reqs = [engine.submit(f) for f in feeds]
    engine.start()
    try:
        for f, req in zip(feeds, reqs):
            got, = req.result(timeout=120)
            rows = len(got)
            pad = {k: np.concatenate([v, np.zeros((req.served_bucket - rows,)
                                                  + v.shape[1:], v.dtype)])
                   for k, v in f.items()}
            assert got.tobytes() == ref.run(pad)[0][:rows].tobytes()
            alone, = ref.run(f)
            np.testing.assert_allclose(got, alone, rtol=0, atol=1e-5)
            assert (got.argmax(1) == alone.argmax(1)).all()
    finally:
        engine.close(drain=True, timeout=60)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout,rate,tensor_seed", [
    ("packed", 0.1, False), ("packed", 0.1, True), ("bnsd", 0.0, False)])
def test_flash_autograd_function_is_the_direct_backward_bitwise(
        dev, dtype, layout, rate, tensor_seed):
    """``FlashAttentionFunction`` on the card: one forward launch, and in
    the backward pass one backward launch whose dq, dk, dv equal a direct
    ``flash_bwd`` call on the saved Out/Lse bit for bit (the same kernel
    on the same inputs), with the seed an int or a device int64."""
    b, s, n, hd = 2, 128, 4, 64
    g = torch.Generator(device=dev).manual_seed(3)
    shape = (b, n, s, hd) if layout == "bnsd" else (b, s, n * hd)
    q, k, v, do = (torch.randn(shape, device=dev, generator=g).to(dtype)
                   for _ in range(4))
    kb = torch.where(torch.rand(b, s, device=dev, generator=g) < 0.2,
                     -1e4, 0.0)
    seed = torch.full((), 77, dtype=torch.int64, device=dev) \
        if tensor_seed else 77
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    kernels.reset_launch_counts()
    out, lse = fa.flash_attention(*leaves, n, 0.125, False, kb, rate, seed,
                                  layout)
    out.backward(do)
    counts = kernels.launch_counts()
    assert counts["flash_attention_fwd"] == 1
    assert counts["flash_attention_bwd"] == 1
    want = fa.flash_bwd(q, k, v, out.detach(), lse, do, n, 0.125, False, kb,
                        rate, seed, layout)
    for leaf, w in zip(leaves, want[:3]):
        assert torch.equal(leaf.grad, w)
        assert leaf.grad.abs().sum() > 0


def _fleet_ernie(recompute=True, amp=False, dropout=0.1):
    """ERNIE-tiny (2 layers, hidden 128, 2 heads of 64, seq 64) built
    without its optimizer and trained through fleet: LAMB with
    global-norm clipping, recompute at each encoder layer's output, AMP
    with dynamic loss scaling when ``amp``."""
    from paddle_tpu_torch import clip, optimizer
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.ir import program_guard
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig(vocab_size=512, hidden_size=128,
                          num_hidden_layers=2, num_attention_heads=2,
                          intermediate_size=512, max_position_embeddings=64,
                          use_flash_attention=True,
                          hidden_dropout_prob=dropout,
                          attention_probs_dropout_prob=dropout)
    with unique_name.guard():
        main, startup, _, fetches = bert.build_pretraining_program(
            cfg, seq_len=64, with_optimizer=False, max_predictions_per_seq=8)
        with program_guard(main, startup):
            s = fleet.DistributedStrategy()
            s.recompute = recompute
            s.recompute_configs = {
                "checkpoints": bert.encoder_checkpoints(main)}
            s.amp = amp
            s.amp_configs = dict(s.amp_configs,
                                 use_dynamic_loss_scaling=True)
            s.lamb = True
            fleet.distributed_optimizer(optimizer.LambOptimizer(
                1e-3, grad_clip=clip.ClipGradByGlobalNorm(1.0)),
                s).minimize(fetches["loss"])
    scope = Scope()
    Executor(device="cpu").run(startup, scope=scope)
    batch = bert.synthetic_pretraining_batch(cfg, 4, 64, seed=1,
                                             max_predictions_per_seq=8)
    return main, dict(scope.items()), batch, fetches["loss"].name


def _on(state, device):
    from paddle_tpu_torch.core.scope import Scope

    scope = Scope()
    for n, v in state.items():
        scope.set(n, v.to(device) if isinstance(v, torch.Tensor) else v)
    return scope


def test_recomputed_flash_and_dropout_segments_match_the_plain_program(dev):
    """A ``block_call`` per encoder layer holding flash attention with
    attention-probs dropout and the hidden dropouts, on the card: 2
    forward flash launches a layer (the call and its recompute) and 1
    backward through ``FlashAttentionFunction``, against the program
    without recompute (``flash_attention_grad``): the loss and every
    gradient within 1e-5 (relative to the tensor's largest magnitude;
    autograd sums contributions in another order than the ``sum`` ops),
    and no gradient all zero."""
    from paddle_tpu_torch.core.executor import Executor

    out = {}
    for rc in (True, False):
        main, state, batch, loss = _fleet_ernie(recompute=rc)
        grads = [main.grad_var_map[p.name] for p in main.all_parameters()]
        kernels.reset_launch_counts()
        out[rc] = Executor(device=dev).run(
            main, feed=batch, fetch_list=[loss] + grads,
            scope=_on(state, dev), use_compiled=False)
        out[(rc, "counts")] = kernels.launch_counts()
    assert out[(True, "counts")]["flash_attention_fwd"] == 4
    assert out[(True, "counts")]["flash_attention_bwd"] == 2
    assert out[(False, "counts")]["flash_attention_fwd"] == 2
    assert out[(False, "counts")]["flash_attention_bwd"] == 2
    for g, w in zip(out[True], out[False]):
        scale = max(float(np.abs(w).max()), 1e-30)
        assert np.abs(g).max() > 0
        np.testing.assert_allclose(g / scale, w / scale, rtol=0, atol=1e-5)


def test_compiled_step_handles_an_overflow_on_the_device(dev):
    """The fleet program with bf16 AMP and dynamic loss scaling, compiled
    on the card: with the scale set to inf in place, two replays count
    two bad steps and restart the counters (the scale halves: inf stays
    inf), then good steps from 32768; (scale, good, bad) after every step
    equal the CPU's op-by-op run bit for bit, and the losses stay
    finite."""
    from paddle_tpu_torch.core.executor import Executor

    main, state, batch, loss = _fleet_ernie(amp=True)
    names = sorted(n for n in state if n.split("_")[0] in ("loss", "good",
                                                           "bad"))
    assert len(names) == 3
    seqs = {}
    for device in (dev, torch.device("cpu")):
        scope, exe = _on(state, device), Executor(device=device)
        seq = []
        for step, scale in enumerate([None, None, float("inf"), None,
                                      32768.0, None]):
            if scale is not None:
                scope.find_var("loss_scaling_0").fill_(scale)
            lv, = exe.run(main, feed=batch, fetch_list=[loss], scope=scope,
                          use_compiled=device.type == "cuda")
            assert np.isfinite(lv).all()
            seq.append([scope.find_var(n).cpu().numpy().tolist()
                        for n in names])
        seqs[device.type] = seq
        if device.type == "cuda":
            assert exe.compiled_builds == 1
    assert seqs["cuda"] == seqs["cpu"]
    by_name = [dict(zip(names, s)) for s in seqs["cuda"]]
    assert [(d["bad_steps_0"][0], d["good_steps_0"][0]) for d in by_name] == \
        [(0, 1), (0, 2), (1, 0), (0, 0), (0, 1), (0, 2)]


# ---------------------------------------------------------------------------
# queue C's C12 and C13, the general-bias flash route, run_steps and the
# threefry dropout mask on the card
# ---------------------------------------------------------------------------

C12_CARD = [([float("nan"), 3e9, -3e9], "int32", [0, 2147483647, -2147483648]),
            ([300.0, -1.0], "uint8", [255, 0]), ([300.0], "int8", [127]),
            ([float("nan"), 1e5, -1e5, 7.9, -7.9], "int16",
             [0, 32767, -32768, 7, -7]),
            ([float("nan"), 1e10, float("-inf"), 2.7], "int64",
             [0, 2147483647, -2147483648, 2])]


@pytest.mark.parametrize("src", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x,dtype,want", C12_CARD)
def test_c12_cast_saturates_on_the_card_as_on_the_cpu(dev, src, x, dtype,
                                                      want):
    from paddle_tpu_torch.core import registry

    cast = registry.get("cast").forward
    t = torch.tensor(x, dtype=src)
    got = cast({"X": [t.to(dev)]}, {"out_dtype": dtype})["Out"].cpu()
    cpu = cast({"X": [t]}, {"out_dtype": dtype})["Out"]
    assert got.dtype == cpu.dtype and torch.equal(got, cpu)
    if src == torch.float32:
        assert got.tolist() == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("x,idx,axis", [
    ([[1, 2, 3]], [[-1, 5]], 1), ([[1, 2, 3]], [[-3, 2, 3, -4]], 1),
    ([[1, 2, 3], [4, 5, 6]], [[0], [-2], [2]], 0)])
def test_c13_take_along_axis_on_the_card_as_on_the_cpu(dev, dtype, x, idx,
                                                       axis):
    from paddle_tpu_torch.core import registry

    op = registry.get("take_along_axis").forward
    ins = {"Input": torch.tensor(x, dtype=dtype),
           "Index": torch.tensor(idx, dtype=torch.int32)}
    got = op({k: [v.to(dev)] for k, v in ins.items()},
             {"Axis": axis})["Result"].cpu()
    cpu = op({k: [v] for k, v in ins.items()}, {"Axis": axis})["Result"]
    assert got.dtype == cpu.dtype
    assert torch.equal(torch.nan_to_num(got.float(), 7.5),
                       torch.nan_to_num(cpu.float(), 7.5))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("heads", [4, 1])
def test_general_bias_route_on_the_card(dev, dtype, tol, heads):
    """A [B,H,Sq,Sk] or [B,1,Sq,Sk] bias: the flash op and its grad op on
    the card against the CPU within rtol = atol = ``tol``, no kernel
    launch, one general-route call each; a key bias on the same op
    launches the kernel."""
    from paddle_tpu_torch.core import registry

    g = torch.Generator().manual_seed(3)
    b, s, h, hd = 2, 96, 4, 64
    q, k, v, do = (torch.randn(b, s, h * hd, generator=g).to(dtype)
                   for _ in range(4))
    bias = torch.randn(b, heads, s, s, generator=g)
    attrs = {"num_heads": h, "dropout_prob": 0.1, "is_test": False,
             "seed": 5, "__step__": 2, "causal": True}
    res = {}
    for d in (dev, torch.device("cpu")):
        kernels.reset_launch_counts()
        ins = {"Q": [q.to(d)], "K": [k.to(d)], "V": [v.to(d)],
               "Bias": [bias.to(d)]}
        f = registry.get("flash_attention").forward(ins, dict(attrs))
        gr = registry.get("flash_attention_grad").forward(
            dict(ins, Out=[f["Out"]], Lse=[f["Lse"]], OutGrad=[do.to(d)]),
            dict(attrs))
        res[d.type] = (f, gr, kernels.general_route_calls(),
                       sum(kernels.launch_counts().values()))
    (fc, gc, calls, launched), (fr, gr, _, _) = res["cuda"], res["cpu"]
    assert calls == 2 and launched == 0
    for a, w in [(fc["Out"], fr["Out"]), (fc["Lse"], fr["Lse"])] + [
            (gc[n], gr[n]) for n in ("QGrad", "KGrad", "VGrad", "BiasGrad")]:
        torch.testing.assert_close(a.cpu().float(), w.float(), rtol=tol,
                                   atol=tol)
    assert tuple(gc["BiasGrad"].shape) == tuple(bias.shape)
    kernels.reset_launch_counts()
    registry.get("flash_attention").forward(
        {"Q": [q.to(dev)], "K": [k.to(dev)], "V": [v.to(dev)],
         "Bias": [bias[:, :1, :1, :].to(dev).contiguous()]}, dict(attrs))
    assert fa.launches == 1 and kernels.general_route_calls() == 0


def test_run_steps_equals_k_runs_on_the_card(dev):
    """ERNIE-tiny with dropout and AdamW: run_steps over 4 stacked batches
    equals 4 run() calls bit for bit (losses, masks, every state tensor,
    the step counter), its AdamW and flash launches 4 times a step's."""
    from paddle_tpu_torch.core.executor import STEP_COUNTER, Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig(vocab_size=512, hidden_size=128,
                          num_hidden_layers=2, num_attention_heads=2,
                          intermediate_size=512, max_position_embeddings=64,
                          use_flash_attention=True)
    with unique_name.guard():
        main, startup, _, fetches = bert.build_pretraining_program(
            cfg, seq_len=64, optimizer_name="adamw",
            max_predictions_per_seq=8)
    mask = next(o.outputs["Mask"][0] for o in main.global_block().ops
                if o.type == "dropout")
    fetch = [fetches["loss"].name, mask]
    batches = [bert.synthetic_pretraining_batch(
        cfg, 4, 64, seed=i, max_predictions_per_seq=8) for i in range(4)]
    exe, seq = Executor(device=dev), Scope()
    exe.run(startup, scope=seq)
    fused = Scope()
    for n, t in seq.items():
        fused.set(n, t.clone() if isinstance(t, torch.Tensor) else t)
    kernels.reset_launch_counts()
    want = [exe.run(main, feed=b, fetch_list=fetch, scope=seq)
            for b in batches]
    runs = kernels.launch_counts()
    kernels.reset_launch_counts()
    got = Executor(device=dev).run_steps(
        main, feed={n: np.stack([b[n] for b in batches])
                    for n in batches[0]}, fetch_list=fetch, scope=fused)
    assert kernels.launch_counts() == runs
    for i in range(4):
        for j in range(2):
            assert np.array_equal(got[j][i], want[i][j])
    for n, t in seq.items():
        if isinstance(t, torch.Tensor):
            assert torch.equal(fused.find_var(n), t), n
    assert int(fused.find_var(STEP_COUNTER)) == int(seq.find_var(
        STEP_COUNTER))


def test_threefry_dropout_mask_on_the_card_is_the_cpu_mask(dev, monkeypatch):
    """The threefry branch (the threshold lowered so that a small tensor
    takes it) on the card: mask and output bit for bit the CPU's, from an
    int key and from a key-table slot (a 0-d int64 tensor)."""
    from paddle_tpu_torch.core import registry

    monkeypatch.setattr(rng, "THREEFRY_MIN", 1 << 12)
    monkeypatch.setattr(rng, "THREEFRY_CHUNK", 1 << 13)
    x = torch.randn(37, 1000, generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    attrs = {"dropout_prob": 0.3, "seed": 17, "__step__": 9}
    op = registry.get("dropout").forward
    cpu = op({"X": [x]}, dict(attrs))
    key = torch.tensor(rng.key_values([17], 9)[0], device=dev)
    for extra in ({}, {"__key__": key}):
        got = op({"X": [x.to(dev)]}, dict(attrs, **extra))
        assert torch.equal(got["Mask"].cpu(), cpu["Mask"])
        assert torch.equal(got["Out"].cpu(), cpu["Out"])
    idx = torch.arange(0, 1 << 34, (1 << 34) // 4096, dtype=torch.int64)
    k = rng.op_key(attrs)
    assert torch.equal(rng.threefry_bits_at(k, idx.to(dev)).cpu(),
                       rng.threefry_bits_at(k, idx))


def _card_mlp(dev):
    """A small fc program with SGD (no random op: no seed-table copy) and
    a CPU-free executor on the card."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import layers, optimizer
    from paddle_tpu_torch.core.executor import Executor

    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = layers.data("x", [256], stop_gradient=True)
        loss = layers.mean(layers.fc(layers.fc(x, 512, act="relu"), 8))
        optimizer.SGDOptimizer(0.01).minimize(loss)
    exe, scope = Executor(device=dev), ptt.Scope()
    exe.run(startup, scope=scope, use_compiled=False)
    feed = {"x": np.random.RandomState(0).randn(64, 256).astype(np.float32)}
    return exe, scope, main, loss, feed


def test_device_ms_is_read_after_the_run_without_a_synchronize(
        dev, monkeypatch):
    """A compiled step's executor.device_ms comes from CUDA events read
    once they have completed: the runs call no synchronize (fetches left
    on the device), and goodput.breakdown lands every pending timing, the
    device part within each run's wall."""
    from paddle_tpu_torch.core import goodput

    exe, scope, main, loss, feed = _card_mlp(dev)
    for _ in range(2):      # the key's first run and its capture
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    telemetry.reset()
    calls = []
    real_sync, real_ev_sync = torch.cuda.synchronize, torch.cuda.Event.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append("device") or
                        real_sync(*a, **k))
    monkeypatch.setattr(torch.cuda.Event, "synchronize",
                        lambda self: calls.append("event") or
                        real_ev_sync(self))
    for _ in range(8):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                return_numpy=False)
    assert calls == []
    hists = telemetry.snapshot()["hists"]
    assert hists["executor.run_ms"]["count"] == 8
    assert hists.get("executor.device_ms", {}).get("count", 0) <= 8
    goodput.breakdown()
    hists = telemetry.snapshot()["hists"]
    assert hists["executor.device_ms"]["count"] == 8
    assert hists["executor.host_dispatch_ms"]["count"] == 8
    assert hists["executor.device_ms"]["min"] > 0


def test_a_cost_capture_that_fails_on_the_card_raises(dev, monkeypatch):
    """On a CUDA device a cost capture that cannot count its step raises
    at the capture (no counted fallback); costmodel.unavailable stays 0.
    Level full fills the capture's allocator figures."""
    from paddle_tpu_torch.core import costmodel, flags
    from paddle_tpu_torch.core.executor import _CompiledStep

    flags.set_flags({"cost_capture": "full"})
    try:
        costmodel.reset()
        exe, scope, main, loss, feed = _card_mlp(dev)
        for _ in range(2):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        (rec,) = costmodel.programs()
        assert rec.source == "captured" and rec.flops > 0
        assert rec.peak_bytes >= rec.arg_bytes > 0 and rec.out_bytes == 4
        exe2, scope2, main2, loss2, feed2 = _card_mlp(dev)
        exe2.run(main2, feed=feed2, fetch_list=[loss2], scope=scope2)

        def broken(self):
            raise RuntimeError("a lowering with no meta kernel")

        monkeypatch.setattr(_CompiledStep, "meta_cost", broken)
        with pytest.raises(RuntimeError, match="no meta kernel"):
            exe2.run(main2, feed=feed2, fetch_list=[loss2], scope=scope2)
        assert telemetry.counter_get("costmodel.unavailable") == 0
    finally:
        flags.set_flags({"cost_capture": "auto"})
        costmodel.reset()


# -- the math, tensor, RNN, sequence and beam-search ops ----------------------

def _glue_cases():
    from paddle_tpu_torch.tools import glue_cases

    return glue_cases


def _glue_run(op, ins, attrs, device):
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.tools.glue_cases import as_tensor

    out = registry.normalize_outputs(registry.get(op).forward(
        {k: [None if v is None else as_tensor(v).to(device) for v in vs]
         for k, vs in ins.items()}, dict(attrs)))
    return {k: [v.cpu() for v in vs] for k, vs in out.items()}


def test_glue_ops_on_the_card_as_on_the_cpu(dev):
    """Every case of the glue table on the card and on the CPU: integer
    and bool outputs bit for bit, floats within their family's
    ``CARD_TOL``, NaN and the infinities where the CPU has them; a case
    the CPU refuses raises the same type on the card."""
    g = _glue_cases()
    bad = []
    for case in sorted(g.CASES):
        op = case.split("[")[0]
        ins, attrs = g.CASES[case](g.rng(case))
        tol = g.CARD_TOL[g.family(op)]
        try:
            want = _glue_run(op, ins, attrs, "cpu")
        except Exception as e:                      # noqa: BLE001
            with pytest.raises(type(e)):
                _glue_run(op, ins, attrs, dev)
            continue
        got = _glue_run(op, ins, attrs, dev)
        for slot, vals in want.items():
            for i, w in enumerate(vals):
                x = got[slot][i]
                if x.shape != w.shape or x.dtype != w.dtype:
                    bad.append((case, slot, "shape/dtype"))
                elif not w.is_floating_point():
                    if not torch.equal(x, w):
                        bad.append((case, slot, "bits"))
                elif not torch.allclose(x, w, rtol=tol, atol=tol,
                                        equal_nan=True):
                    bad.append((case, slot, float(
                        (x - w).abs().nan_to_num(0.0).max())))
    assert not bad, bad[:10]


def test_lstm_op_replays_in_a_cuda_graph(dev):
    """The lstm op reads no length on the host, so a captured graph
    replays it: the replay equals the eager run bit for bit, lengths and
    all."""
    g = _glue_cases()
    ins, _ = g.CASES["lstm[len=True,rev=True,h0=True,proj=False]"](
        g.rng("graph"))
    from paddle_tpu_torch.core import registry

    t = {k: [torch.from_numpy(np.asarray(v[0])).to(dev)]
         for k, v in ins.items()}
    fwd = registry.get("lstm").forward
    eager = fwd(t, {"is_reverse": True})["Out"].clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fwd(t, {"is_reverse": True})
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fwd(t, {"is_reverse": True})["Out"]
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def test_seq2seq_step_and_decoders_on_the_card_as_on_the_cpu(dev):
    """One small seq2seq program: 3 training steps (op by op, then
    compiled) on the card and the CPU from one state within 1e-4, then
    greedy and beam decoding from the trained states: the same ids, and
    beam at K = 1 without length penalty equals greedy on the card."""
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.models import seq2seq

    cfg = seq2seq.Seq2SeqConfig(src_vocab_size=64, tgt_vocab_size=48,
                                embed_dim=32, hidden_size=64)
    with unique_name.guard():
        main, startup, _, fetches = seq2seq.build_seq2seq_program(
            cfg, 9, 7, batch_size=8, lr=1e-2)
    cpu = Scope()
    Executor(device="cpu").run(startup, scope=cpu)
    card = Scope()
    for n, v in cpu.items():
        card.set(n, v.to(dev, copy=True) if isinstance(v, torch.Tensor)
                 else v)
    losses = {}
    for name, sc, device in (("cpu", cpu, "cpu"), ("card", card, dev)):
        exe = Executor(device=device)
        losses[name] = [float(np.asarray(exe.run(
            main, feed=seq2seq.synthetic_translation_batch(cfg, 8, 9, 7,
                                                           seed=s),
            fetch_list=[fetches["loss"].name], scope=sc,
            use_compiled=s > 0)[0]).reshape(-1)[0]) for s in range(3)]
    np.testing.assert_allclose(losses["card"], losses["cpu"], rtol=1e-4,
                               atol=1e-4)
    src = seq2seq.synthetic_translation_batch(cfg, 5, 9, 7, seed=9)
    for fn, kw in ((seq2seq.greedy_decode, {}),
                   (seq2seq.beam_search_decode, {"beam_size": 3})):
        got = fn(cfg, card, src["src_ids"], src["src_mask"], max_len=7,
                 **kw)
        want = fn(cfg, cpu, src["src_ids"], src["src_mask"], max_len=7,
                  **kw)
        np.testing.assert_array_equal(got, want)
    greedy = seq2seq.greedy_decode(cfg, card, src["src_ids"],
                                   src["src_mask"], max_len=7)
    k1 = seq2seq.beam_search_decode(cfg, card, src["src_ids"],
                                    src["src_mask"], beam_size=1, max_len=7,
                                    length_penalty=0.0)
    np.testing.assert_array_equal(k1, greedy)


# -- the CRF ops, control flow and gradient merge ------------------------------

def test_crf_forward_backward_and_viterbi_on_the_card_as_on_the_cpu(dev):
    """linear_chain_crf's cost, Alpha and gradients (through the generic
    vjp) within 1e-5 of the CPU's, and crf_decoding's paths bit for bit,
    at the SRL model's 59 tags over 64 steps with ragged lengths (0 and
    64 among them) and on the glue table's tie case."""
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.tools.glue_cases import as_tensor, crf_ins

    r = np.random.RandomState(5)
    lengths = [64, 0, 1, 37, 64, 12, 50, 8]
    cases = [crf_ins(r, lengths, 64, t=59),
             crf_ins(r, [4, 2, 4], 4, ties=True)]
    for ins in cases:
        on = {d: {k: [as_tensor(v).to(d) for v in vs]
                  for k, vs in ins.items()} for d in ("cpu", dev)}
        outs = {d: registry.get("linear_chain_crf").forward(on[d], {})
                for d in on}
        for slot in ("LogLikelihood", "Alpha"):
            torch.testing.assert_close(outs[dev][slot].cpu(),
                                       outs["cpu"][slot], rtol=1e-5,
                                       atol=1e-5)
        g = {}
        for d in on:
            pins = {f"In__{k}": v for k, v in on[d].items()}
            pins["OG__LogLikelihood"] = [torch.ones_like(
                outs[d]["LogLikelihood"])]
            g[d] = registry.get("__vjp_grad__").forward(
                pins, {"fwd_type": "linear_chain_crf", "fwd_attrs": {}})
        for slot in ("IG__Emission", "IG__Transition"):
            torch.testing.assert_close(g[dev][slot][0].cpu(),
                                       g["cpu"][slot][0], rtol=1e-5,
                                       atol=1e-5)
        dec = {d: registry.get("crf_decoding").forward(
            {k: v for k, v in on[d].items() if k != "Label"},
            {})["ViterbiPath"] for d in on}
        assert torch.equal(dec[dev].cpu(), dec["cpu"])


def test_dynamic_rnn_compiled_step_is_captured_and_equals_op_by_op(dev):
    """The DynamicRNN tanh cell (tools/control_flow_cases.py) trained 3
    SGD steps op by op and compiled from one state: losses, outputs and
    parameters bit for bit, and the compiled step a captured graph."""
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.tools import control_flow_cases as cfc

    main, startup, fetch = cfc.build(
        cfc.port(), lambda P: cfc.dynamic_rnn(P, S=16, D=8, H=16))
    cpu = Scope()
    Executor(device="cpu").run(startup, scope=cpu)
    r = np.random.RandomState(1)
    feed = {"x": r.randn(32, 16, 8).astype(np.float32),
            "len": r.randint(0, 17, (32,)).astype(np.int64),
            "label": r.randn(32, 16).astype(np.float32)}
    legs = {}
    for mode in (False, True):
        sc = Scope()
        for n, v in cpu.items():
            sc.set(n, v.to(dev, copy=True) if isinstance(v, torch.Tensor)
                   else v)
        exe = Executor(device=dev)
        outs = [exe.run(main, feed=feed, fetch_list=fetch, scope=sc,
                        use_compiled=mode) for _ in range(3)]
        legs[mode] = (outs, {n: v.cpu() for n, v in sc.items()
                             if isinstance(v, torch.Tensor)})
        if mode:
            step, = [c for by in exe._compiled[main].values()
                     for c in by.values() if hasattr(c, "graph")]
            assert step.host_op is None and step.graph.graph is not None
    for a, b in zip(legs[False][0], legs[True][0]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for n, v in legs[False][1].items():
        assert torch.equal(v, legs[True][1][n]), n


def test_gradient_merge_fires_on_the_card_as_a_whole_batch_step(dev):
    """A classifier through fleet's gradient merge (k 4, avg) on the
    card, compiled (the step runs uncaptured: conditional_block decides
    on the host): the three non-firing steps leave every parameter and
    moment bit for bit, the fourth lands within 1e-5 of one Adam step on
    the four micro-batches together."""
    from paddle_tpu_torch import layers, optimizer
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.ir import Program, program_guard
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.distributed import fleet

    def build(merge):
        main, startup = Program(), Program()
        with unique_name.guard(), program_guard(main, startup):
            x = layers.data("x", [16])
            label = layers.data("label", [1], dtype="int64")
            logits = layers.fc(layers.fc(x, 32, act="tanh"), 5)
            loss = layers.mean(layers.softmax_with_cross_entropy(logits,
                                                                 label))
            opt = optimizer.AdamOptimizer(0.05)
            if merge:
                s = fleet.DistributedStrategy()
                s.gradient_merge = True
                s.gradient_merge_configs = {"k_steps": 4, "avg": True}
                opt = fleet.distributed_optimizer(opt, s)
            opt.minimize(loss)
        return main, startup, loss

    merged, startup, loss = build(True)
    plain, _, ploss = build(False)
    cpu = Scope()
    Executor(device="cpu").run(startup, scope=cpu)

    def on_card():
        sc = Scope()
        for n, v in cpu.items():
            sc.set(n, v.to(dev, copy=True) if isinstance(v, torch.Tensor)
                   else v)
        return sc

    r = np.random.RandomState(2)
    micro = [{"x": r.randn(8, 16).astype(np.float32),
              "label": r.randint(0, 5, (8, 1)).astype(np.int64)}
             for _ in range(4)]
    exe, sc = Executor(device=dev), on_card()
    params = [p.name for p in plain.all_parameters()]
    trained = [n for n, v in cpu.items() if isinstance(v, torch.Tensor)
               and "@GradAcc" not in n and not n.startswith("gm_step")]
    for i, feed in enumerate(micro):
        before = {n: sc.find_var(n).cpu() for n in trained}
        exe.run(merged, feed=feed, fetch_list=[loss], scope=sc)
        if i < 3:
            for n in trained:
                assert torch.equal(sc.find_var(n).cpu(), before[n]), n
    ref = on_card()
    Executor(device=dev).run(
        plain, feed={k: np.concatenate([m[k] for m in micro])
                     for k in micro[0]},
        fetch_list=[ploss], scope=ref, use_compiled=False)
    for n in params:
        torch.testing.assert_close(sc.find_var(n).cpu(),
                                   ref.find_var(n).cpu(), rtol=1e-5,
                                   atol=1e-5)
    step, = [c for by in exe._compiled[merged].values() for c in by.values()
             if hasattr(c, "graph")]
    assert step.host_op == "conditional_block" and step.graph.graph is None


# -- the imperative mode (dygraph) on the card --------------------------------

def _eager_mha(device, state=None, grad=True, b=2, s=128, d=256, heads=4):
    """MultiHeadAttention run eagerly on ``device`` under a key-padding
    bias [B,1,1,S] (the flash kernels' key-bias route): its state, output,
    input and parameter gradients, and the launch counts of the run."""
    from paddle_tpu_torch import dygraph, nn

    r = np.random.RandomState(1)
    x = r.randn(b, s, d).astype(np.float32)
    lens = np.array([s, s // 2 + 3])[:b]
    bias = np.where(np.arange(s)[None] < lens[:, None], 0.0,
                    -1e4).astype(np.float32).reshape(b, 1, 1, s)
    cot = r.randn(b, s, d).astype(np.float32)
    with dygraph.guard(device):
        np.random.seed(0)
        mha = nn.MultiHeadAttention(d, heads)
        if state is not None:
            mha.set_state_dict(state)
        start = {k: v.numpy() for k, v in mha.state_dict().items()}
        xv = dygraph.VarBase(x, stop_gradient=not grad)
        kernels.reset_launch_counts()
        if grad:
            out = mha(xv, attn_mask=dygraph.VarBase(bias))
            (out * dygraph.VarBase(cot)).sum().backward()
        else:
            with dygraph.no_grad():
                out = mha(xv, attn_mask=dygraph.VarBase(bias))
        torch.cuda.synchronize()
        counts, layouts = kernels.launch_counts(), kernels.layout_counts()
        grads = {n: p.gradient() for n, p in mha.named_parameters()}
        return start, out.numpy(), xv.gradient(), grads, counts, layouts


def test_eager_mha_runs_the_bnsd_flash_kernels_under_autograd(dev):
    """Eager MultiHeadAttention at S=128 under autograd: one bnsd flash
    forward and one bnsd backward launch (FlashAttentionFunction), its
    output and every gradient within 2e-5 of the same Layer on the CPU
    (the plain versions, weights copied)."""
    cpu = _eager_mha("cpu")
    card = _eager_mha(dev, cpu[0])
    assert card[4]["flash_attention_fwd"] == 1
    assert card[4]["flash_attention_bwd"] == 1
    assert card[5]["flash_attention_fwd"] == {"packed": 0, "bnsd": 1}
    assert card[5]["flash_attention_bwd"] == {"packed": 0, "bnsd": 1}
    np.testing.assert_allclose(card[1], cpu[1], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(card[2], cpu[2], rtol=2e-5, atol=2e-5)
    for k, w in cpu[3].items():
        np.testing.assert_allclose(card[3][k], w, rtol=2e-5, atol=2e-5,
                                   err_msg=k)


def test_eager_mha_without_gradients_runs_the_forward_kernel_alone(dev):
    cpu = _eager_mha("cpu", grad=False)
    card = _eager_mha(dev, cpu[0], grad=False)
    assert card[4]["flash_attention_fwd"] == 1
    assert card[4]["flash_attention_bwd"] == 0
    np.testing.assert_allclose(card[1], cpu[1], rtol=2e-5, atol=2e-5)


def _eager_adamw(device, state=None, steps=4):
    from paddle_tpu_torch import dygraph, nn, optimizer

    r = np.random.RandomState(2)
    xs = [r.randn(8, 32).astype(np.float32) for _ in range(steps)]
    with dygraph.guard(device):
        np.random.seed(0)
        net = nn.Sequential(nn.Linear(32, 64), nn.GELU(), nn.Linear(64, 4))
        if state is not None:
            net.set_state_dict(state)
        start = {k: v.numpy() for k, v in net.state_dict().items()}
        sched = optimizer.lr.LinearWarmup(1e-2, 2, 0.0, 1e-2)
        opt = optimizer.AdamW(learning_rate=sched,
                              parameters=net.parameters())
        per_step, losses = [], []
        for x in xs:
            loss = (net(dygraph.VarBase(x)) ** 2.0).mean()
            loss.backward()
            before = kernels.launch_counts()["fused_adamw"]
            opt.step()
            torch.cuda.synchronize()
            per_step.append(kernels.launch_counts()["fused_adamw"] - before)
            opt.clear_grad()
            sched.step()
            losses.append(float(loss))
        return start, losses, per_step, {
            k: v.numpy() for k, v in net.state_dict().items()}


def test_eager_adamw_steps_launch_one_kernel_per_parameter(dev):
    """``step()`` runs the cached micro-program of adamw ops (op by op,
    then captured and replayed): one AdamW launch per parameter tensor
    every step, the rate following the scheduler, the losses and the
    parameters within 1e-5 of the same steps on the CPU."""
    cpu = _eager_adamw("cpu")
    card = _eager_adamw(dev, cpu[0])
    assert card[2] == [4, 4, 4, 4]
    np.testing.assert_allclose(card[1], cpu[1], rtol=1e-5, atol=1e-6)
    for k, w in cpu[3].items():
        np.testing.assert_allclose(card[3][k], w, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_eager_auto_cast_runs_bf16_matmuls_on_the_card(dev):
    from paddle_tpu_torch import amp, dygraph, nn

    x = np.random.RandomState(3).randn(16, 32).astype(np.float32)
    outs = []
    for device in ("cpu", dev):
        with dygraph.guard(device):
            np.random.seed(0)
            lin = nn.Linear(32, 8, bias_attr=False)
            if outs:
                lin.set_state_dict(outs[0][2])
            xv = dygraph.VarBase(x, stop_gradient=False)
            with amp.auto_cast():
                y = lin(xv)
            y.astype("float32").sum().backward()
            outs.append((y.astype("float32").numpy(), xv.gradient(),
                         {k: v.numpy() for k, v in
                          lin.state_dict().items()}, y._tensor.dtype))
    assert outs[1][3] == torch.bfloat16 == outs[0][3]
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=1e-2, atol=1e-2)


# -- @to_static on the card: run_program's CUDA graphs --------------------------

def _static_mlp(device, state=None):
    from paddle_tpu_torch import dygraph, nn

    class MLP(dygraph.Layer):
        def __init__(self):
            super().__init__()
            self.l1 = nn.Linear(32, 64)
            self.l2 = nn.Linear(64, 8)

        @dygraph.to_static
        def forward(self, x):
            return self.l2(nn.functional.gelu(self.l1(x)))

    np.random.seed(0)
    net = MLP()
    if state is not None:
        net.set_state_dict(state)
    return net


def _replay_and_uncaptured(net, make_inputs, loss_of, calls=2):
    """The same calls through the graph replay and through the block run
    op by op on the card (each from the same parameters, gradients
    cleared): per call the fetches and every parameter gradient."""
    from paddle_tpu_torch.ops.control_flow_ops import run_program_graphs

    runs = []
    for graphs in (True, False):
        got = []
        with run_program_graphs(graphs):
            for i in range(calls):
                out = net(*make_inputs(i))
                loss_of(out).backward()
                got.append((out.numpy(), {n: p.gradient() for n, p in
                                          net.named_parameters()}))
                net.clear_gradients()
        runs.append(got)
    return runs


def _assert_runs_equal(runs, tol):
    for (o1, g1), (o2, g2) in zip(*runs):
        np.testing.assert_allclose(o1, o2, rtol=tol, atol=tol)
        for k in g1:
            np.testing.assert_allclose(g1[k], g2[k], rtol=tol, atol=tol,
                                       err_msg=k)


def test_to_static_mlp_replay_equals_the_uncaptured_block(dev):
    """A @to_static MLP on the card: the forward and backward graph
    replays give the fetches and parameter gradients of the same block
    run op by op on the card, bit for bit, call after call (new inputs
    copied into the graph's feed buffers)."""
    from paddle_tpu_torch import dygraph

    xs = np.random.RandomState(5).randn(3, 16, 32).astype(np.float32)
    with dygraph.guard(dev):
        net = _static_mlp(dev)
        runs = _replay_and_uncaptured(
            net, lambda i: [dygraph.VarBase(xs[i])],
            lambda out: (out * out).mean(), calls=3)
        _assert_runs_equal(runs, 0)


def test_to_static_bert_replay_equals_the_uncaptured_block(dev):
    """A 2-layer bert_classifier (d_model 128, 2 heads of 64, s128,
    key-padding bias, dropout 0.1) under @to_static: logits and every
    parameter gradient of the graph replays equal the block run op by op
    on the card (the same dropout masks: the replay's seed table holds
    the seeds the op by op run folds at step 0)."""
    from paddle_tpu_torch import dygraph, nn
    from paddle_tpu_torch.tools.dygraph_bert import (bert_classifier,
                                                      synthetic_rows)

    rows = synthetic_rows(8, 128, vocab=500, seed=6)
    with dygraph.guard(dev):
        np.random.seed(1)
        net = bert_classifier(nn, vocab=500, max_pos=128, d_model=128,
                              heads=2, ffn=256, layers=2)
        net.forward = dygraph.to_static(net.forward)
        loss_fn = nn.CrossEntropyLoss()
        lbl = dygraph.VarBase(rows[3][:4])
        runs = _replay_and_uncaptured(
            net, lambda i: [dygraph.VarBase(a[4 * (i % 2):4 * (i % 2) + 4])
                            for a in rows[:3]],
            lambda out: loss_fn(out, lbl))
        _assert_runs_equal(runs, 0)


def test_run_program_counts_an_uncaptured_block_with_an_unbounded_loop(dev):
    """A block holding a while_loop without grad_max_iters (it reads its
    predicate on the host) runs op by op on the card, each run counted in
    executor.uncaptured_steps and the op named."""
    from paddle_tpu_torch import dygraph, layers, program_guard
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.ir import Program
    from paddle_tpu_torch.ops.control_flow_ops import _program_state

    main = Program()
    with unique_name.guard(), program_guard(main, Program()):
        x0 = layers.static_data("x0", [2])
        (xf,) = layers.while_loop(lambda x: layers.reduce_sum(x) < 100.0,
                                  lambda x: [x * 2.0], [x0])
        out = layers.reduce_sum(xf)
    attrs = {"program": main, "feed_names": ["x0"], "param_names": [],
             "fetch_names": [out.name]}
    before = telemetry.counter_get("executor.uncaptured_steps") or 0
    with dygraph.guard(dev):
        got = [float(dygraph.trace_op(
            "run_program", {"X": [dygraph.VarBase(np.full(2, v, np.float32))],
                            "Params": []}, attrs)["Out"][0])
            for v in (1.0, 3.0)]
    after = telemetry.counter_get("executor.uncaptured_steps") or 0
    assert got == [128.0, 192.0]
    assert after - before == 2
    assert _program_state(main)["uncapturable"] == "while_loop"
    assert not _program_state(main)["graphs"]


def test_to_static_launch_counts_count_replays_only(dev):
    """A @to_static MultiHeadAttention at S=128 under a key-padding bias:
    once traced and captured, each call adds one bnsd flash forward and
    its backward one bnsd backward launch (the graphs' own counts, added
    per replay); the warm-up and the captures add none."""
    from paddle_tpu_torch import dygraph, nn
    from paddle_tpu_torch.ops.control_flow_ops import _program_state

    b, s, d = 2, 128, 256
    x = np.random.RandomState(7).randn(b, s, d).astype(np.float32)
    bias = np.zeros((b, 1, 1, s), np.float32)
    bias[1, ..., s // 2:] = -1e4
    with dygraph.guard(dev):
        np.random.seed(0)
        mha = nn.MultiHeadAttention(d, 4)
        f = dygraph.to_static(lambda q, m: mha(q, attn_mask=m))
        xv = dygraph.VarBase(x, stop_gradient=False)
        mv = dygraph.VarBase(bias)
        kernels.reset_launch_counts()
        f(xv, mv).sum().backward()
        torch.cuda.synchronize()
        first = kernels.launch_counts()
        graphs, = _program_state(f.main_program)["graphs"].values()
        kernels.reset_launch_counts()
        for _ in range(3):
            f(xv, mv).sum().backward()
        torch.cuda.synchronize()
        later = kernels.launch_counts()
    # the first call: the trace's eager forward and one replay of each
    assert (first["flash_attention_fwd"], first["flash_attention_bwd"]) == \
        (2, 1)
    assert graphs.fwd_delta.get("flash_attention_fwd") == 1
    assert graphs.bwd_delta.get("flash_attention_bwd") == 1
    assert (later["flash_attention_fwd"], later["flash_attention_bwd"]) == \
        (3, 3)


# -- the linalg_ops / extra_ops slice (tools/linalg_extra_cases.py) ----------

def _lec_leg(dev, builder, feed, cpu=True):
    """A leg's program op by op on the card (and on the CPU), then as a
    compiled step on a fresh executor: (card outputs, CPU outputs,
    compiled outputs of the captured run, captured, uncaptured runs)."""
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.tools import control_flow_cases as cfc

    prog, _, fetch = cfc.build(cfc.port(), builder)
    names = [v.name for v in fetch]
    dfeed = {k: torch.from_numpy(np.asarray(v)).to(dev)
             for k, v in feed.items()}
    card = Executor(device=dev).run(prog, feed=dfeed, fetch_list=names,
                                    scope=Scope(), use_compiled=False)
    host = Executor(device="cpu").run(prog, feed=feed, fetch_list=names,
                                      scope=Scope(), use_compiled=False) \
        if cpu else None
    exe, scope = Executor(device=dev), Scope()
    u0 = telemetry.counter_get("executor.uncaptured_steps")
    for _ in range(2):
        comp = exe.run(prog, feed=dfeed, fetch_list=names, scope=scope,
                       use_compiled=True)
    built = [c for by in exe._compiled[prog].values() for c in by.values()
             if hasattr(c, "graph")]
    captured = bool(built) and built[0].graph.graph is not None
    exe.close()
    return (card, host, comp, captured,
            telemetry.counter_get("executor.uncaptured_steps") - u0)


def _same(a, b):
    return all(np.array_equal(x, y, equal_nan=np.issubdtype(
        np.asarray(y).dtype, np.floating)) for x, y in zip(a, b))


def test_linalg_extra_mlm_loss_captured_against_softmax_ce(dev):
    """logsumexp + nll_loss over [1024, 30522] logits (BERT-base's
    vocabulary, 8 of the card leg's 64 rows of 128): the captured step
    equals op by op bit for bit; loss and gradient against
    softmax_with_cross_entropy's within 1e-5."""
    from paddle_tpu_torch.tools import linalg_extra_cases as lec

    feed = lec.mlm_feed(1024, 30522)
    card, _, comp, captured, unc = _lec_leg(
        dev, lambda P: lec.mlm_nll(P, 1024, 30522), feed, cpu=False)
    ce, _, _, _, _ = _lec_leg(
        dev, lambda P: lec.mlm_softmax_ce(P, 1024, 30522), feed, cpu=False)
    assert captured and unc == 0 and _same(comp, card)
    assert abs(float(card[0]) - float(ce[0])) <= 1e-5 * abs(float(ce[0]))
    assert np.abs(card[1] - ce[1]).max() <= 1e-5 * np.abs(ce[1]).max()


def test_linalg_extra_scatter_nd_is_fixed_order_at_the_ernie_table(dev):
    """scatter_nd of 2048 ids with repeats and out-of-range ones into
    [18000, 1024]: three card runs bit for bit, within fp32 rounding of
    a float64 sum; shard_index the CPU's bit for bit; captured."""
    from paddle_tpu_torch.tools import linalg_extra_cases as lec

    feed = lec.embedding_feed(2048, 18000, 1024)
    card, host, comp, captured, unc = _lec_leg(
        dev, lambda P: lec.embedding_scatter(P, 2048, 18000, 1024, 4), feed)
    again, _, _, _, _ = _lec_leg(
        dev, lambda P: lec.embedding_scatter(P, 2048, 18000, 1024, 4), feed,
        cpu=False)
    assert captured and unc == 0 and _same(comp, card) and _same(again, card)
    assert _same(card[1:], host[1:])
    ref = lec.scatter_nd_float64(feed["ids"], feed["rows"], 18000)
    mag = lec.scatter_nd_float64(feed["ids"], np.abs(feed["rows"]), 18000)
    assert (np.abs(card[0] - ref) <= mag * 2.0 ** -20).all()


def test_linalg_extra_order_stats_and_linalg_against_the_cpu(dev):
    """kthvalue, median and mode over [1024, 768] activations with ties
    bit for bit the CPU's; cholesky of [32, 64, 64] with a member not
    positive definite: NaN fill inside the captured step, within 1e-4 of
    the CPU's; inverse of the same within 1e-4, its compiled step
    uncaptured (inv_ex cannot be captured) and counted."""
    from paddle_tpu_torch.tools import linalg_extra_cases as lec

    card, host, comp, captured, unc = _lec_leg(
        dev, lambda P: lec.order_stats(P, 1024, 768),
        lec.order_stats_feed(1024, 768))
    assert captured and unc == 0 and _same(comp, card) and _same(card, host)
    feed = lec.linalg_feed(32, 64, 1)
    for op in ("cholesky", "inverse"):
        card, host, comp, captured, unc = _lec_leg(
            dev, lambda P: lec.linalg(P, 32, 64, op), feed)
        assert _same(comp, card)
        assert (captured, unc) == ((True, 0) if op == "cholesky"
                                   else (False, 1)), op
        fin = ~np.isnan(host[0])
        assert np.abs(card[0][fin] - host[0][fin]).max() <= \
            1e-4 * np.abs(host[0][fin]).max()
    card, _, _, _, _ = _lec_leg(
        dev, lambda P: lec.linalg(P, 32, 64, "cholesky"), feed, cpu=False)
    low = np.tril(np.ones((64, 64), bool))
    assert np.isnan(card[0][1][low]).all() and (card[0][1][~low] == 0).all()


def test_linalg_extra_streamed_auc_stats_equal_the_cpu(dev):
    """cos_sim + auc over 4 batches of [4096, 256] towers, compiled on
    the card: the stat vars the CPU's bit for bit, the AUC within
    1e-6."""
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.tools import control_flow_cases as cfc
    from paddle_tpu_torch.tools import linalg_extra_cases as lec

    prog, startup, fetch = cfc.build(cfc.port(),
                                     lambda P: lec.ctr_auc(P, 4096, 256))
    names = [v.name for v in fetch]
    feeds = lec.ctr_feeds(4096, 256, 4)
    outs = {}
    for device in ("cpu", dev):
        exe, scope = Executor(device=device), Scope()
        exe.run(startup, scope=scope)
        outs[str(device)] = [exe.run(prog, feed=f, fetch_list=names,
                                     scope=scope) for f in feeds][-1]
        exe.close()
    cpu, card = outs["cpu"], outs[str(dev)]
    assert _same(card[1:], cpu[1:])
    assert abs(float(card[0]) - float(cpu[0])) <= 1e-6
