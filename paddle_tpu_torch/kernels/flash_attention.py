"""Flash attention in two layouts: forward, and the backward from the
saved (out, lse).

``layout="packed"`` takes q/k/v as the projections give them, [B,S,n*hd];
``layout="bnsd"`` takes [B,n,S,hd]. out and the gradients come back in
the inputs' layout, lse always [B,n,Sq].

The forward replaces the four TPU forward kernels of
``paddle_tpu/ops/pallas/flash_attention.py``, which compute one function
(out, lse) and differ only in how the TPU's VMEM budget cuts the work:
``_packed_fwd_kernel`` (:948, launched at :1067; the prefill up to 512
and the BERT/ERNIE encoder in training), the 2-pass ``_fwd_kernel``
(:311, launched at :614 via ``_fwd_pallas``; S >= 1024),
``_fused_fwd_kernel`` (:377, launched at :442) and
``_fused_fwd_kernel_g`` (:822, launched at :481), single-block over
[B*H,S,D] with one or g heads a grid cell. The backward replaces the
five backward kernels: ``_packed_bwd_kernel`` (:984, launched at
:1115), ``_fused_bwd_kernel`` (:748, :1237), ``_fused_bwd_kernel_g``
(:860, :540), and the 2-pass ``_dkv_kernel`` (:634, :1319) and
``_dq_kernel`` (:701, :1353). ``csrc/flash_attention_fwd.cu`` and
``csrc/flash_attention_bwd.cu`` read every operand in place through
explicit (batch, row, head) strides and take any length; the backward
runs the 2-pass split at every length (one pass owns dk/dv/dbias of a
key tile, one owns dq of a q tile, each recomputing p = exp(s - lse)
tile by tile), with no atomics, so its results depend neither on the
run nor on the layout.

Each dtype has its own instance, counted apart in
``launches_by_dtype``:

- bf16 runs on the tensor cores (``wgmma.mma_async`` m64nNk16, bf16
  operands, fp32 accumulators): 64-row tiles streamed through two
  cp.async stages into swizzled shared memory (``csrc/flash_tc.cuh``),
  two consumer warpgroups a forward block and one a backward block, the
  online softmax on the accumulator fragments. p, p * mask and ds *
  scale, which the reference rounds to bf16 before their products
  (``flash_attention.py`` :359, :406, :678, :689, :740, :787, :796),
  enter those products from registers as bf16 hi + lo pairs: hi alone
  leaves outputs up to two bf16 ulps from the fp32 function, hi + lo
  keeps them within one. The exps (as exp2, log2 e folded into the
  scale) and the dropout hash on the CUDA cores, not the products, set
  its pace. It needs every bf16 stride a multiple of 8 elements and
  every address 16-byte aligned (16-byte copies); anything else raises.
- fp32 runs on the CUDA cores in fp32 (a tensor-core fp32 product would
  be TF32, too coarse for the serving path's 1e-4 gate against the CPU):
  one block per (batch, head, 64-row tile), 4 x 4 register patches,
  strides a multiple of 4 elements.

Attention-probs dropout (rate > 0) multiplies p by keep / (1 - rate)
before p v; the row sum and lse stay unmasked. keep is the reference's
stateless hash of (seed, b * n + h, q, k) (``core/rng.attn_keep``), the
same lattice in either layout, so the backward recomputes the forward's
mask and never stores it.

On a CPU or meta tensor the wrappers run the plain versions below; on a
CUDA tensor they launch the kernels or raise. The kernels read the
tensors they are given through their strides: nothing is copied to make
it contiguous, and a tensor the kernels cannot read (head_dim not
contiguous, a stride or address off the alignment) raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import rng
from . import _build

launches = 0       # forward kernel launches since the last reset
bwd_launches = 0   # backward kernel launches since the last reset
LAYOUTS = ("packed", "bnsd")
# the same launches split by the layout they read
launches_by_layout = dict.fromkeys(LAYOUTS, 0)
bwd_launches_by_layout = dict.fromkeys(LAYOUTS, 0)
# dtype -> (the dtype code of the C entry points, the instance it runs)
DTYPES = {torch.float32: (0, "fp32_cuda_cores"),
          torch.bfloat16: (1, "bf16_wgmma")}
INSTANCES = tuple(name for _, name in DTYPES.values())
# the same launches split by the instance they ran
launches_by_dtype = dict.fromkeys(INSTANCES, 0)
bwd_launches_by_dtype = dict.fromkeys(INSTANCES, 0)
# the alignment every stride of a dtype keeps, in elements: 16 bytes for
# the bf16 instance's copies, one float4 for the fp32 one
STRIDE_ALIGN = {torch.float32: 4, torch.bfloat16: 8}

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)   # template instances in the .cu sources


def reset_layout_counts():
    """Zero the launch splits by layout and by dtype instance."""
    for counts, keys in ((launches_by_layout, LAYOUTS),
                         (bwd_launches_by_layout, LAYOUTS),
                         (launches_by_dtype, INSTANCES),
                         (bwd_launches_by_dtype, INSTANCES)):
        counts.update(dict.fromkeys(keys, 0))


def _heads(t, n_heads, layout):
    """[B,n,S,hd] view of a tensor in ``layout``."""
    if layout == "bnsd":
        return t
    b, s, htot = t.shape
    return t.reshape(b, s, n_heads, htot // n_heads).transpose(1, 2)


def _unheads(t4, layout):
    """A [B,n,S,hd] tensor back in ``layout``."""
    if layout == "bnsd":
        return t4
    b, n, s, hd = t4.shape
    return t4.transpose(1, 2).reshape(b, s, n * hd)


def _geometry(what, q, k, n_heads, layout):
    """(B, n, Sq, Sk, hd) of q/k in ``layout``."""
    if layout not in LAYOUTS:
        raise ValueError(f"{what}: layout {layout!r} not in {LAYOUTS}")
    if q.dim() != (4 if layout == "bnsd" else 3):
        raise ValueError(f"{what}: a {layout} q has "
                         f"{4 if layout == 'bnsd' else 3} dims, got "
                         f"{tuple(q.shape)}")
    if layout == "bnsd":
        b, n, sq, hd = q.shape
        if n_heads is not None and int(n_heads) != n:
            raise ValueError(f"{what}: {n_heads} heads for a bnsd q with "
                             f"{n}")
        return b, n, sq, k.shape[2], hd
    b, sq, htot = q.shape
    n = int(n_heads)
    if htot % n:
        raise ValueError(f"{what}: width {htot} is not {n} heads")
    return b, n, sq, k.shape[1], htot // n


def _scores(qh, kh, scale, causal, bias):
    """fp32 scores [B,n,Sq,Sk] of [B,n,S,hd] heads with the key bias added
    and causally hidden keys at -inf."""
    b, _, sq, _ = qh.shape
    sk = kh.shape[2]
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float().reshape(b, 1, 1, sk)
    if causal:
        rows = torch.arange(sq, device=qh.device)[:, None] + (sk - sq)
        cols = torch.arange(sk, device=qh.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
    return s


def _keep_scale(b, n, sq, sk, rate, seed, device):
    """fp32 [B,n,Sq,Sk] multiplier keep / (1 - rate), or None."""
    if not rate:
        return None
    keep = rng.attn_keep(seed, rate, b, n, sq, sk, device)
    return keep.to(torch.float32) * (1.0 / (1.0 - rate))


def plain_flash_fwd(q, k, v, n_heads, scale, causal, bias=None, rate=0.0,
                    seed=0, layout="packed"):
    """The same function in plain PyTorch. q [B,Sq,n*hd] and k/v
    [B,Sk,n*hd] (packed), or q [B,n,Sq,hd] and k/v [B,n,Sk,hd] (bnsd,
    n_heads may be None); bias [B,Sk] or None. Causal masking is
    bottom-right aligned (query row r sees keys <= r + Sk - Sq). Masked
    keys get weight exactly 0; a row with no visible key has out 0 and lse
    NEG_INF + log(1e-30). With rate > 0 the probabilities are multiplied
    by the dropout keep/(1-rate) mask after the row sum is taken. For
    bf16 inputs the products accumulate in fp32 and p is rounded to bf16
    before p v, as in the reference kernel. Returns (out in q's layout,
    lse [B,n,Sq])."""
    b, n, sq, sk, _ = _geometry("plain flash forward", q, k, n_heads, layout)
    qh, kh, vh = (_heads(t, n, layout) for t in (q, k, v))
    s = _scores(qh, kh, scale, causal, bias)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    mult = _keep_scale(b, n, sq, sk, rate, seed, q.device)
    if mult is not None:
        p = p * mult
    acc = torch.matmul(p.to(v.dtype).float(), vh.float())
    out = (acc / torch.where(l == 0, 1.0, l)).to(q.dtype)
    lse = (m + torch.log(l.clamp_min(1e-30))).squeeze(-1)
    return _unheads(out, layout), lse


def plain_flash_bwd(q, k, v, out, lse, dout, n_heads, scale, causal,
                    bias=None, rate=0.0, seed=0, layout="packed"):
    """(dq, dk, dv, dbias) of the forward above from its saved out and
    lse, step by step what the kernels compute: delta = sum(do * o),
    p = exp(s - lse), dv = (p * mask)^T do, dp = (do v^T) * mask,
    ds = p * (dp - delta), dbias = sum of ds over heads and query rows,
    dq = ds * scale k, dk = (ds * scale)^T q. fp32 accumulation; for
    bf16 inputs p * mask and ds * scale are rounded to bf16 before their
    products, as in the reference kernel. dq/dk/dv come in q's dtype and
    layout, dbias [B,Sk] in fp32 (None without a bias)."""
    b, n, sq, sk, _ = _geometry("plain flash backward", q, k, n_heads,
                                layout)
    qh, kh, vh = (_heads(t, n, layout).float() for t in (q, k, v))
    doh, oh = (_heads(t, n, layout).float() for t in (dout, out))
    delta = (doh * oh).sum(dim=-1, keepdim=True)
    s = _scores(qh, kh, scale, causal, bias)
    p = torch.exp(s - lse.unsqueeze(-1))
    mult = _keep_scale(b, n, sq, sk, rate, seed, q.device)
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
    return (_unheads(dq.to(q.dtype), layout), _unheads(dk.to(q.dtype), layout),
            _unheads(dv.to(q.dtype), layout), dbias)


def plain_packed_flash_fwd(q, k, v, n_heads, scale, causal, bias=None,
                           rate=0.0, seed=0):
    """``plain_flash_fwd`` over the packed layout."""
    return plain_flash_fwd(q, k, v, n_heads, scale, causal, bias, rate, seed)


def plain_packed_flash_bwd(q, k, v, out, lse, dout, n_heads, scale, causal,
                           bias=None, rate=0.0, seed=0):
    """``plain_flash_bwd`` over the packed layout."""
    return plain_flash_bwd(q, k, v, out, lse, dout, n_heads, scale, causal,
                           bias, rate, seed)


def _lib(name="flash_attention_fwd"):
    lib = _build.load(name)
    if not getattr(lib, "_typed", False):
        vp, ci, cf, cu = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_uint)
        if name == "flash_attention_fwd":
            lib.pt_flash_attention_fwd.argtypes = [
                vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, cf, ci, ci,
                cu, cu, cf, vp]
            lib.pt_flash_attention_fwd.restype = ci
        else:
            lib.pt_flash_attention_bwd.argtypes = [
                vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci,
                ci, ci, ci, ci, cf, ci, ci, cu, cu, cf, vp]
            lib.pt_flash_attention_bwd.restype = ci
        lib._typed = True
    return lib


def _check(what, dev, dtype, tensors):
    """Device, dtype and shape of each operand; the fp32 ones (lse, bias)
    are read as contiguous arrays."""
    for name, t, shape, dt in tensors:
        if t is None:
            continue
        if t.device != dev or t.dtype != (dt or dtype) \
                or tuple(t.shape) != shape \
                or (dt is not None and not t.is_contiguous()):
            raise ValueError(f"{what} kernel: {name} must be a "
                             f"{dt or dtype} {shape} tensor on {dev}"
                             f"{', contiguous' if dt else ''}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _kernel_geometry(what, q, k, n_heads, layout):
    """_geometry, the q and k/v shapes, and the kernels' own limits."""
    b, n, sq, sk, hd = _geometry(what, q, k, n_heads, layout)
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what} kernel: head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES:
        raise ValueError(f"{what} kernel: dtype {q.dtype} not in "
                         f"{tuple(DTYPES)}")
    qshape = tuple(q.shape)
    kshape = (b, n, sk, hd) if layout == "bnsd" else (b, sk, n * hd)
    return b, n, sq, sk, hd, qshape, kshape


def _dropout_args(rate, seed):
    rate = float(rate or 0.0)
    if rate <= 0.0:
        return 0, 0, 1.0
    return int(seed) & rng.M32, rng.keep_threshold(rate), 1.0 / (1.0 - rate)


def _stride_array(what, hd, layout, named):
    """The (batch, row, head) element strides of each named tensor, as the
    kernels read them, in one C array; raises where they cannot: head_dim
    not contiguous, the address not 16-byte aligned, or a stride off the
    dtype's alignment (``STRIDE_ALIGN``: 8 elements, 16 bytes, for the
    bf16 instance's cp.async copies; 4 for the fp32 one's float4 loads)."""
    arr = []
    for name, t in named:
        st = t.stride()
        align = STRIDE_ALIGN.get(t.dtype, 4)
        if layout == "bnsd":
            sizes, lst, unit = (t.shape[0], t.shape[2], t.shape[1]), \
                (st[0], st[2], st[1]), st[3]
        else:
            sizes, lst, unit = (t.shape[0], t.shape[1], t.shape[2] // hd), \
                (st[0], st[1], hd * st[2]), st[2]
        if unit != 1 or t.data_ptr() % 16 or any(
                x % align for x, size in zip(lst, sizes) if size > 1):
            raise ValueError(
                f"{what} kernel: {name} must have head_dim contiguous and "
                f"every stride a multiple of {align} elements at a 16-byte "
                f"aligned address, got strides {st} at "
                f"{t.data_ptr() % 16} bytes past 16")
        arr.extend(lst)
    return (ctypes.c_longlong * len(arr))(*arr)


def _launch(q, k, v, n_heads, scale, causal, bias, rate, seed, layout):
    global launches
    what = "flash forward"
    b, n, sq, sk, hd, qshape, kshape = _kernel_geometry(what, q, k, n_heads,
                                                        layout)
    dev = q.device
    _check(what, dev, q.dtype,
           (("q", q, qshape, None), ("k", k, kshape, None),
            ("v", v, kshape, None), ("bias", bias, (b, sk), torch.float32)))
    out = torch.empty(qshape, dtype=q.dtype, device=dev)
    lse = torch.empty((b, n, sq), dtype=torch.float32, device=dev)
    strides = _stride_array(what, hd, layout, (("q", q), ("k", k), ("v", v),
                                               ("out", out)))
    seed32, thresh, inv_keep = _dropout_args(rate, seed)
    rc = _lib().pt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        out.data_ptr(), lse.data_ptr(), strides, b, sq, sk, n, hd,
        float(scale), int(causal), DTYPES[q.dtype][0], seed32, thresh,
        inv_keep, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, what)
    launches += 1
    launches_by_layout[layout] += 1
    launches_by_dtype[DTYPES[q.dtype][1]] += 1
    return out, lse


def _launch_bwd(q, k, v, out, lse, dout, n_heads, scale, causal, bias, rate,
                seed, layout):
    global bwd_launches
    what = "flash backward"
    b, n, sq, sk, hd, qshape, kshape = _kernel_geometry(what, q, k, n_heads,
                                                        layout)
    dev = q.device
    _check(what, dev, q.dtype,
           (("q", q, qshape, None), ("k", k, kshape, None),
            ("v", v, kshape, None), ("out", out, qshape, None),
            ("dout", dout, qshape, None),
            ("lse", lse, (b, n, sq), torch.float32),
            ("bias", bias, (b, sk), torch.float32)))
    # every output is written in full by the block that owns it; delta
    # and the per-head dbias are the kernels' scratch
    dq = torch.empty(qshape, dtype=q.dtype, device=dev)
    dk = torch.empty(kshape, dtype=q.dtype, device=dev)
    dv = torch.empty(kshape, dtype=q.dtype, device=dev)
    delta = torch.empty((b, n, sq), dtype=torch.float32, device=dev)
    dbias_h = dbias = None
    if bias is not None:
        dbias_h = torch.empty((b, n, sk), dtype=torch.float32, device=dev)
        dbias = torch.empty((b, sk), dtype=torch.float32, device=dev)
    strides = _stride_array(what, hd, layout, (
        ("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout),
        ("dq", dq), ("dk", dk), ("dv", dv)))
    seed32, thresh, inv_keep = _dropout_args(rate, seed)
    rc = _lib("flash_attention_bwd").pt_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dbias_h.data_ptr() if dbias_h is not None else None,
        dbias.data_ptr() if dbias is not None else None, strides, b, sq, sk,
        n, hd, float(scale), int(causal), DTYPES[q.dtype][0], seed32, thresh,
        inv_keep, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, what)
    bwd_launches += 1
    bwd_launches_by_layout[layout] += 1
    bwd_launches_by_dtype[DTYPES[q.dtype][1]] += 1
    return dq, dk, dv, dbias


def _key_bias(bias):
    return None if bias is None else bias.float().contiguous()


def flash_fwd(q, k, v, n_heads, scale, causal, bias=None, rate=0.0, seed=0,
              layout="packed"):
    """(out in q's layout, lse [B,n,Sq]) of softmax(q k^T * scale + bias) v
    over fp32 or bf16 inputs in ``layout`` ("packed" [B,S,n*hd] with
    n_heads, or "bnsd" [B,n,S,hd]); bias is a [B,Sk] key bias or None;
    rate/seed switch on attention-probs dropout."""
    if q.device.type in ("cpu", "meta"):
        return plain_flash_fwd(q, k, v, n_heads, scale, causal, bias, rate,
                               seed, layout)
    if q.device.type == "cuda":
        return _launch(q, k, v, n_heads, scale, causal, _key_bias(bias),
                       rate, seed, layout)
    raise ValueError(f"flash forward: unsupported device {q.device}")


def flash_bwd(q, k, v, out, lse, dout, n_heads, scale, causal, bias=None,
              rate=0.0, seed=0, layout="packed"):
    """(dq, dk, dv, dbias) of ``flash_fwd`` from its saved out and lse and
    the cotangent dout of out, in the inputs' layout; dbias [B,Sk]."""
    if q.device.type in ("cpu", "meta"):
        return plain_flash_bwd(q, k, v, out, lse, dout, n_heads, scale,
                               causal, bias, rate, seed, layout)
    if q.device.type == "cuda":
        return _launch_bwd(q, k, v, out, lse, dout, n_heads, scale, causal,
                           _key_bias(bias), rate, seed, layout)
    raise ValueError(f"flash backward: unsupported device {q.device}")


def packed_flash_fwd(q, k, v, n_heads, scale, causal, bias=None, rate=0.0,
                     seed=0):
    """``flash_fwd`` over the packed layout."""
    return flash_fwd(q, k, v, n_heads, scale, causal, bias, rate, seed)


def packed_flash_bwd(q, k, v, out, lse, dout, n_heads, scale, causal,
                     bias=None, rate=0.0, seed=0):
    """``flash_bwd`` over the packed layout."""
    return flash_bwd(q, k, v, out, lse, dout, n_heads, scale, causal, bias,
                     rate, seed)
