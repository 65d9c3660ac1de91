"""Flash attention over the packed [B,S,n*hd] layout: forward, and the
backward from the saved (out, lse).

The forward replaces two TPU kernels of
``paddle_tpu/ops/pallas/flash_attention.py`` that compute the same
function (out, lse): ``_packed_fwd_kernel`` (:948, launched at :1067),
which the prefill takes at prompt buckets up to 512 and the BERT/ERNIE
encoder takes in training, and the 2-pass ``_fwd_kernel`` (:311,
launched at :614 via ``_fwd_pallas``), which buckets 1024 and 2048 take
after a transpose to [B,H,S,D]. The TPU needed two only because of its
VMEM budget. The Hopper kernel, ``csrc/flash_attention_fwd.cu``, reads
q/k/v in the packed layout in place, runs one block per (batch, head,
64-row q tile) over k/v tiles with fp32 online-softmax stats, and writes
out [B,S,n*hd] and lse [B,n,S]. Inputs are fp32 or bf16, the math fp32.

The backward replaces ``_packed_bwd_kernel`` (:984, launched at :1115
via ``_bwd_pallas_packed``). ``csrc/flash_attention_bwd.cu`` recomputes
p = exp(s - lse) tile by tile and never writes an S x S matrix.

Attention-probs dropout (rate > 0) multiplies p by keep / (1 - rate)
before p v; the row sum and lse stay unmasked. keep is the reference's
stateless hash of (seed, b * n + h, q, k) (``core/rng.attn_keep``), so
the backward recomputes the forward's mask and never stores it.

On a CPU or meta tensor the wrappers run the plain versions below; on a
CUDA tensor they launch the kernels or raise.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import rng
from . import _build

launches = 0       # forward kernel launches since the last reset
bwd_launches = 0   # backward kernel launches since the last reset

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)   # template instances in the .cu source


DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # template instances


def _heads(t, n_heads):
    b, s, htot = t.shape
    return t.reshape(b, s, n_heads, htot // n_heads).transpose(1, 2)


def _scores(q, k, n_heads, scale, causal, bias):
    """fp32 scores [B,n,Sq,Sk] with the key bias added and causally
    hidden keys at -inf."""
    b, sq, _ = q.shape
    sk = k.shape[1]
    s = torch.matmul(_heads(q, n_heads).float(),
                     _heads(k, n_heads).float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float().reshape(b, 1, 1, sk)
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        cols = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
    return s


def _keep_scale(q, k, n_heads, rate, seed):
    """fp32 [B,n,Sq,Sk] multiplier keep / (1 - rate), or None."""
    if not rate:
        return None
    keep = rng.attn_keep(seed, rate, q.shape[0], n_heads, q.shape[1],
                         k.shape[1], q.device)
    return keep.to(torch.float32) * (1.0 / (1.0 - rate))


def plain_packed_flash_fwd(q, k, v, n_heads, scale, causal, bias=None,
                           rate=0.0, seed=0):
    """The same function in plain PyTorch. q [B,Sq,n*hd], k/v
    [B,Sk,n*hd], bias [B,Sk] or None. Causal masking is bottom-right
    aligned (query row r sees keys <= r + Sk - Sq). Masked keys get
    weight exactly 0; a row with no visible key has out 0 and lse
    NEG_INF + log(1e-30). With rate > 0 the probabilities are multiplied
    by the dropout keep/(1-rate) mask after the row sum is taken. For
    bf16 inputs the products accumulate in fp32 and p is rounded to bf16
    before p v, as in the reference kernel."""
    b, sq, htot = q.shape
    s = _scores(q, k, n_heads, scale, causal, bias)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    mult = _keep_scale(q, k, n_heads, rate, seed)
    if mult is not None:
        p = p * mult
    acc = torch.matmul(p.to(v.dtype).float(), _heads(v, n_heads).float())
    out = (acc / torch.where(l == 0, 1.0, l)).to(q.dtype)
    lse = (m + torch.log(l.clamp_min(1e-30))).squeeze(-1)
    return out.transpose(1, 2).reshape(b, sq, htot), lse


def plain_packed_flash_bwd(q, k, v, out, lse, dout, n_heads, scale, causal,
                           bias=None, rate=0.0, seed=0):
    """(dq, dk, dv, dbias) of the forward above from its saved out and
    lse, step by step what the kernel computes: delta = sum(do * o),
    p = exp(s - lse), dv = (p * mask)^T do, dp = (do v^T) * mask,
    ds = p * (dp - delta), dbias = sum of ds over heads and query rows,
    dq = ds * scale k, dk = (ds * scale)^T q. fp32 accumulation; for
    bf16 inputs p * mask and ds * scale are rounded to bf16 before their
    products, as in the reference kernel. dq/dk/dv come in q's dtype,
    dbias [B,Sk] in fp32 (None without a bias)."""
    b, sq, htot = q.shape
    qh, kh, vh = (_heads(t, n_heads).float() for t in (q, k, v))
    doh, oh = _heads(dout, n_heads).float(), _heads(out, n_heads).float()
    delta = (doh * oh).sum(dim=-1, keepdim=True)
    s = _scores(q, k, n_heads, scale, causal, bias)
    p = torch.exp(s - lse.unsqueeze(-1))
    mult = _keep_scale(q, k, n_heads, rate, seed)
    pd = p if mult is None else p * mult
    dv = torch.matmul(pd.to(q.dtype).float().transpose(-1, -2), doh)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    if mult is not None:
        dp = dp * mult
    ds_nos = p * (dp - delta)
    dbias = ds_nos.sum(dim=(1, 2)) if bias is not None else None
    ds = (ds_nos * scale).to(q.dtype).float()
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)

    def packed(t, s_len):
        return t.transpose(1, 2).reshape(b, s_len, htot).to(q.dtype)

    return packed(dq, sq), packed(dk, k.shape[1]), packed(dv, k.shape[1]), \
        dbias


def _lib(name="flash_attention_fwd"):
    lib = _build.load(name)
    if not getattr(lib, "_typed", False):
        vp, ci, cf, cu = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_uint)
        if name == "flash_attention_fwd":
            lib.pt_flash_attention_fwd.argtypes = [
                vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, cf, ci, ci, cu,
                cu, cf, vp]
            lib.pt_flash_attention_fwd.restype = ci
        else:
            lib.pt_flash_attention_bwd.argtypes = [
                vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci,
                ci, ci, cf, ci, ci, cu, cu, cf, vp]
            lib.pt_flash_attention_bwd.restype = ci
        lib._typed = True
    return lib


def _check(what, dev, dtype, tensors):
    for name, t, shape, dt in tensors:
        if t is None:
            continue
        dt = dt or dtype
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what} kernel: {name} must be a contiguous, "
                             f"16-byte aligned {dt} {shape} tensor on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _geometry(what, q, k, n):
    b, sq, htot = q.shape
    hd = htot // n
    if hd not in HEAD_DIMS or hd * n != htot:
        raise ValueError(f"{what} kernel: head_dim {hd} not in {HEAD_DIMS} "
                         f"(width {htot}, {n} heads)")
    if q.dtype not in DTYPES:
        raise ValueError(f"{what} kernel: dtype {q.dtype} not in "
                         f"{tuple(DTYPES)}")
    return b, sq, k.shape[1], htot, hd


def _dropout_args(rate, seed):
    rate = float(rate or 0.0)
    if rate <= 0.0:
        return 0, 0, 1.0
    return int(seed) & rng.M32, rng.keep_threshold(rate), 1.0 / (1.0 - rate)


def _launch(q, k, v, n, scale, causal, bias, rate=0.0, seed=0):
    global launches
    b, sq, sk, htot, hd = _geometry("flash forward", q, k, n)
    dev = q.device
    _check("flash forward", dev, q.dtype,
           (("q", q, (b, sq, htot), None), ("k", k, (b, sk, htot), None),
            ("v", v, (b, sk, htot), None),
            ("bias", bias, (b, sk), torch.float32)))
    out = torch.empty_like(q)
    lse = torch.empty((b, n, sq), dtype=torch.float32, device=dev)
    seed32, thresh, inv_keep = _dropout_args(rate, seed)
    rc = _lib().pt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        lse.data_ptr(), b, sq, sk, n, hd, float(scale), int(causal),
        DTYPES[q.dtype], seed32, thresh, inv_keep,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "flash forward")
    launches += 1
    return out, lse


def _launch_bwd(q, k, v, out, lse, dout, n, scale, causal, bias, rate, seed):
    global bwd_launches
    b, sq, sk, htot, hd = _geometry("flash backward", q, k, n)
    dev = q.device
    _check("flash backward", dev, q.dtype,
           (("q", q, (b, sq, htot), None), ("k", k, (b, sk, htot), None),
            ("v", v, (b, sk, htot), None), ("out", out, (b, sq, htot), None),
            ("dout", dout, (b, sq, htot), None),
            ("lse", lse, (b, n, sq), torch.float32),
            ("bias", bias, (b, sk), torch.float32)))
    # dq accumulates across key tiles by fp32 atomics into a zeroed
    # buffer and is cast to the input dtype afterwards; dk and dv are
    # written once by the block that owns their key tile; delta is the
    # kernel's scratch
    dq = torch.zeros((b, sq, htot), dtype=torch.float32, device=dev)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, n, sq), dtype=torch.float32, device=dev)
    dbias = torch.zeros((b, sk), dtype=torch.float32, device=dev) \
        if bias is not None else None
    seed32, thresh, inv_keep = _dropout_args(rate, seed)
    rc = _lib("flash_attention_bwd").pt_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(),
        bias.data_ptr() if bias is not None else None, delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dbias.data_ptr() if dbias is not None else None, b, sq, sk, n, hd,
        float(scale), int(causal), DTYPES[q.dtype], seed32, thresh, inv_keep,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "flash backward")
    bwd_launches += 1
    return dq.to(q.dtype), dk, dv, dbias


def _key_bias(bias):
    return None if bias is None else bias.float().contiguous()


def packed_flash_fwd(q, k, v, n_heads, scale, causal, bias=None, rate=0.0,
                     seed=0):
    """(out [B,Sq,n*hd], lse [B,n,Sq]) of softmax(q k^T * scale + bias) v
    over packed fp32 or bf16 inputs; bias is a [B,Sk] key bias or None;
    rate/seed switch on attention-probs dropout."""
    if q.device.type in ("cpu", "meta"):
        return plain_packed_flash_fwd(q, k, v, n_heads, scale, causal, bias,
                                      rate, seed)
    if q.device.type == "cuda":
        return _launch(q, k, v, int(n_heads), scale, causal, _key_bias(bias),
                       rate, seed)
    raise ValueError(f"flash forward: unsupported device {q.device}")


def packed_flash_bwd(q, k, v, out, lse, dout, n_heads, scale, causal,
                     bias=None, rate=0.0, seed=0):
    """(dq, dk, dv, dbias) of ``packed_flash_fwd`` from its saved out and
    lse and the cotangent dout of out."""
    if q.device.type in ("cpu", "meta"):
        return plain_packed_flash_bwd(q, k, v, out, lse, dout, n_heads,
                                      scale, causal, bias, rate, seed)
    if q.device.type == "cuda":
        return _launch_bwd(q, k, v, out, lse, dout, int(n_heads), scale,
                           causal, _key_bias(bias), rate, seed)
    raise ValueError(f"flash backward: unsupported device {q.device}")
