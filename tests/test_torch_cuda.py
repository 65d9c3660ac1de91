"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at edge shapes the serving and training paths do not reach (ragged
tiles, Sq != Sk, every head_dim instance, contexts past 48 KB of shared
memory, bf16 and fp32, dropout on and off), and the flash kernels in both
layouts: [B,H,S,D] against its plain version at S = 128 to 2048, bit for
bit equal to the packed layout on the same values, and refusing strides
they cannot read instead of copying. The flash kernels' bf16 instances run
on the tensor cores: every head_dim, ragged and cross-attention shapes,
causal, bias and dropout, their keep masks read back bit for bit, and
their 8-element stride rule. Marked ``cuda``: they skip where
torch.cuda is unavailable.

This file imports neither jax nor paddle_tpu, so on a machine with the
card and no JAX it runs without the repo's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import kernels
from paddle_tpu_torch.core import rng
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
        k_: {"fp32_cuda_cores": 0, "bf16_wgmma": 2}
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
    before = fad.launches
    got = fad.fused_adamw_(p, grad, m, v, lr, 0.9, 0.999, 1e-8, 0.01, b1p,
                           b2p)
    torch.cuda.synchronize()
    assert fad.launches == before + 1 and got[0] is p
    # fp32: the compiler contracts a * b + c into one fma, the plain
    # version rounds twice; bf16 params: one bf16 ulp where they differ
    ptol = dict(rtol=1e-6, atol=1e-6) if pdt == torch.float32 \
        else dict(rtol=8e-3, atol=1e-6)
    torch.testing.assert_close(got[0].float(), want[0].float(), **ptol)
    torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("hd,page,mp,pos", [
    (64, 16, 128, [0, 1, 15, 16, 2047, 700]), (32, 8, 4, [31, 0, 9]),
    (128, 16, 256, [4095, 2000])])
def test_paged_kernel_matches_plain(dev, hd, page, mp, pos):
    n = 4
    b = len(pos)
    num_pages = 1 + sum(p // page + 1 for p in pos)
    g = torch.Generator(device=dev).manual_seed(hd + mp)
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
    out = pa.paged_decode_attention(q, pk, pv, table, posd, n, hd, 0.1)
    ref = pa.plain_paged_attention(q, pk, pv, table, posd, n, hd, 0.1)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    assert float(out.abs().max()) < 100.0


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
