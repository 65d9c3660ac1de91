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
- fp32 runs on the tensor cores in split TF32 (``csrc/flash_tf32.cuh``):
  each fp32 operand is two TF32 terms, hi (the low 13 mantissa bits
  cleared) and lo = x - hi, and each product is lo*hi + hi*lo + hi*hi
  (``wgmma.mma_async`` m64nNk8 .tf32, fp32 accumulators), about 2^-21 of
  each product from fp32, where one TF32 pass (2^-11) would miss the
  serving path's 1e-4 gate against the CPU and the training gates. One
  warpgroup a block over 64 rows; the streamed tiles are split by the
  block's threads after they land, and the operands whose reduction runs
  over sequence positions (v in p v, q and do in the dkv pass, k in the
  dq pass) are also written transposed, since .tf32 operands are K-major
  only. Strides a multiple of 4 elements (16-byte copies).

Attention-probs dropout (rate > 0) multiplies p by keep / (1 - rate)
before p v; the row sum and lse stay unmasked. keep is the reference's
stateless hash of (seed, b * n + h, q, k) (``core/rng.attn_keep``), the
same lattice in either layout, so the backward recomputes the forward's
mask and never stores it. ``seed`` is a Python int or a 0-d int64/int32
tensor on the inputs' device; the kernels read it through a pointer, so
a CUDA graph that captured a launch draws the mask of whatever seed the
tensor holds when it replays.

A bias that is not a key bias ([B,H,Sq,Sk], [B,1,Sq,Sk] or any other
shape that broadcasts to [B,n,Sq,Sk]) takes the reference's
``reference_general`` route (``flash_attention.py:1479-1495``, :1642):
``general_fwd`` / ``general_bwd``, plain attention in PyTorch with the
full bias, an fp32 softmax and the same position-keyed probs dropout.
That is the reference's own choice of route by the bias's shape, not a
fallback from the kernels: no kernel takes such a bias, and a key bias
on a CUDA tensor still launches the kernel or raises. The route counts
its calls in ``general_calls``, a plain integer beside the launch
counters.

Under autograd, ``flash_attention`` (``FlashAttentionFunction``) runs the
forward and, in the backward pass, the backward kernel: the route of a
``flash_attention`` op recomputed inside a ``block_call`` segment. On a
CPU or meta tensor the wrappers run the plain versions below; on a CUDA
tensor they launch the kernels or raise. The kernels read the
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
general_calls = 0  # calls of the reference_general route (no kernel)
LAYOUTS = ("packed", "bnsd")
# the same launches split by the layout they read
launches_by_layout = dict.fromkeys(LAYOUTS, 0)
bwd_launches_by_layout = dict.fromkeys(LAYOUTS, 0)
# dtype -> (the dtype code of the C entry points, the instance it runs)
DTYPES = {torch.float32: (0, "fp32_tf32x3"),
          torch.bfloat16: (1, "bf16_wgmma")}
INSTANCES = tuple(name for _, name in DTYPES.values())
# the same launches split by the instance they ran
launches_by_dtype = dict.fromkeys(INSTANCES, 0)
bwd_launches_by_dtype = dict.fromkeys(INSTANCES, 0)
# the alignment every stride of a dtype keeps, in elements: 16 bytes for
# either instance's cp.async copies
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
    and causally hidden keys at NEG_INF, the reference's finite mask
    value: a masked key of a row that sees any key gets weight exactly 0,
    and a row that sees none a uniform softmax over all Sk keys."""
    b, _, sq, _ = qh.shape
    sk = kh.shape[2]
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float().reshape(b, 1, 1, sk)
    if causal:
        rows = torch.arange(sq, device=qh.device)[:, None] + (sk - sq)
        cols = torch.arange(sk, device=qh.device)[None, :]
        s = s.masked_fill(cols > rows, NEG_INF)
    return s


def _empty_rows(sq, sk, causal, device):
    """[Sq, 1] bool: the rows that see no key (causal with Sq > Sk,
    bottom-right aligned: row r < Sq - Sk), or None where there are none."""
    if not causal or sq <= sk:
        return None
    return (torch.arange(sq, device=device) < sq - sk)[:, None]


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
    keys get weight exactly 0. A row with no visible key (r < Sq - Sk)
    gets, as in the reference, whose mask value is the finite NEG_INF, the
    uniform softmax over all Sk keys: out the mean of the (masked) v, lse
    NEG_INF + log(Sk), which is NEG_INF in fp32. With rate > 0 the
    probabilities are multiplied by the dropout keep/(1-rate) mask after
    the row sum is taken. For bf16 inputs the products accumulate in fp32
    and p is rounded to bf16 before p v, as in the reference kernel.
    Returns (out in q's layout, lse [B,n,Sq])."""
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
    dq = ds * scale k, dk = (ds * scale)^T q. A row that sees no key (the
    forward's uniform rows) has p = 1 / Sk and ds = 0: dq 0 there, nothing
    to dk, (1 / Sk) mask do to dv, as the reference's vjp gives. fp32
    accumulation; for bf16 inputs p * mask and ds * scale are rounded to
    bf16 before their products, as in the reference kernel. dq/dk/dv
    come in q's dtype and layout, dbias [B,Sk] in fp32 (None without a
    bias)."""
    b, n, sq, sk, _ = _geometry("plain flash backward", q, k, n_heads,
                                layout)
    qh, kh, vh = (_heads(t, n, layout).float() for t in (q, k, v))
    doh, oh = (_heads(t, n, layout).float() for t in (dout, out))
    delta = (doh * oh).sum(dim=-1, keepdim=True)
    s = _scores(qh, kh, scale, causal, bias)
    p = torch.exp(s - lse.unsqueeze(-1))
    # a row that sees no key had weight 1 / Sk on every key, and its
    # scores no gradient (the vjp of the reference's where): ds 0 there
    empty = _empty_rows(sq, sk, causal, q.device)
    if empty is not None:
        p = torch.where(empty, 1.0 / sk, p)
    mult = _keep_scale(b, n, sq, sk, rate, seed, q.device)
    pd = p if mult is None else p * mult
    dv = torch.matmul(pd.to(q.dtype).float().transpose(-1, -2), doh)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    if mult is not None:
        dp = dp * mult
    ds_nos = p * (dp - delta)
    if empty is not None:
        ds_nos = torch.where(empty, 0.0, ds_nos)
    dbias = ds_nos.sum(dim=(1, 2)) if bias is not None else None
    ds = (ds_nos * scale).to(q.dtype).float()
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    return (_unheads(dq.to(q.dtype), layout), _unheads(dk.to(q.dtype), layout),
            _unheads(dv.to(q.dtype), layout), dbias)


def _general(q, k, v, n_heads, scale, causal, bias, rate, seed, layout):
    """(out, lse) of plain attention with a full bias, the reference's
    ``reference_attention`` on its general route: fp32 scores q k^T *
    scale + bias (bias broadcast to [B,n,Sq,Sk]), causal keys above the
    bottom-right-aligned diagonal at NEG_INF, an fp32 softmax, the probs
    times the dropout keep/(1 - rate) mask, p v in fp32, cast to q's
    dtype. lse is the true log-sum-exp of the biased scores [B,n,Sq],
    fp32: the reference returns zeros on this route
    (``flash_attention.py:1661``); the port keeps the true value, as its
    kernels do (ROADMAP's list of the reference's faults). Runs under
    the caller's grad mode."""
    b, n, sq, sk, _ = _geometry("general attention", q, k, n_heads, layout)
    qh, kh, vh = (_heads(t, n, layout) for t in (q, k, v))
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    s = s + bias.float()
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        cols = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    mult = _keep_scale(b, n, sq, sk, rate, seed, q.device)
    if mult is not None:
        p = p * mult
    out = torch.matmul(p, vh.float()).to(q.dtype)
    return _unheads(out, layout), lse


def general_fwd(q, k, v, n_heads, scale, causal, bias, rate=0.0, seed=0,
                layout="packed"):
    """The reference_general route's forward, on any device: (out in q's
    layout, lse [B,n,Sq]). Under autograd (a recomputed segment) its
    gradient is autograd's. Counts one call."""
    global general_calls
    general_calls += 1
    return _general(q, k, v, n_heads, scale, causal, bias, rate, seed,
                    layout)


def general_bwd(q, k, v, dout, n_heads, scale, causal, bias, rate=0.0,
                seed=0, layout="packed"):
    """(dq, dk, dv, dbias) of ``general_fwd``: the forward recomputed
    under autograd (the reference's vjp on this route) and differentiated
    with the cotangent dout of out. dq/dk/dv come in the inputs' dtype
    and layout, dbias in the bias's own shape and dtype (summed over the
    dims it was broadcast along). Counts one call."""
    global general_calls
    general_calls += 1
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v, bias)]
    with torch.enable_grad():
        out, _ = _general(*leaves[:3], n_heads, scale, causal, leaves[3],
                          rate, seed, layout)
        return tuple(torch.autograd.grad(
            out, leaves, dout.to(out.dtype).reshape(out.shape)))


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
                vp, cu, cf, vp]
            lib.pt_flash_attention_fwd.restype = ci
        else:
            lib.pt_flash_attention_bwd.argtypes = [
                vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci,
                ci, ci, ci, ci, cf, ci, ci, vp, cu, cf, vp]
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


def _dropout_args(rate, seed, dev):
    """(the seed on the device or None, keep threshold, 1 / (1 - rate)).
    The kernels read the seed through a pointer: a 0-d int64 or int32
    tensor on ``dev`` (the executor's seed table) is passed as it is, a
    Python int is written into a new device scalar by a fill kernel (no
    copy from the host)."""
    rate = float(rate or 0.0)
    if rate <= 0.0:
        return None, 0, 1.0
    if isinstance(seed, torch.Tensor):
        if seed.device != dev or seed.numel() != 1 \
                or seed.dtype not in (torch.int64, torch.int32):
            raise ValueError(f"flash kernels: a tensor seed must be one "
                             f"int64 or int32 element on {dev}, got "
                             f"{seed.dtype} {tuple(seed.shape)} on "
                             f"{seed.device}")
    else:
        seed = torch.full((), int(seed) & rng.M32, dtype=torch.int64,
                          device=dev)
    return seed, rng.keep_threshold(rate), 1.0 / (1.0 - rate)


def _stride_array(what, hd, layout, named):
    """The (batch, row, head) element strides of each named tensor, as the
    kernels read them, in one C array; raises where they cannot: head_dim
    not contiguous, the address not 16-byte aligned, or a stride off the
    dtype's alignment (``STRIDE_ALIGN``: 16 bytes, 8 bf16 or 4 fp32
    elements, for the instances' cp.async copies)."""
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
    seed_t, thresh, inv_keep = _dropout_args(rate, seed, dev)
    rc = _lib().pt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        out.data_ptr(), lse.data_ptr(), strides, b, sq, sk, n, hd,
        float(scale), int(causal), DTYPES[q.dtype][0],
        None if seed_t is None else seed_t.data_ptr(), thresh, inv_keep,
        torch.cuda.current_stream(dev).cuda_stream)
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
    seed_t, thresh, inv_keep = _dropout_args(rate, seed, dev)
    rc = _lib("flash_attention_bwd").pt_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dbias_h.data_ptr() if dbias_h is not None else None,
        dbias.data_ptr() if dbias is not None else None, strides, b, sq, sk,
        n, hd, float(scale), int(causal), DTYPES[q.dtype][0],
        None if seed_t is None else seed_t.data_ptr(), thresh, inv_keep,
        torch.cuda.current_stream(dev).cuda_stream)
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


class FlashAttentionFunction(torch.autograd.Function):
    """``flash_fwd`` under autograd: the port's counterpart of the
    reference's ``jax.custom_vjp`` over the packed kernel
    (``flash_attention.py:1128-1155``). The forward runs ``flash_fwd``
    and saves q, k, v, the key bias, out and lse; the backward runs
    ``flash_bwd`` from them, the same kernel the ``flash_attention_grad``
    op launches, with the seed the forward drew with (a Python int, or the
    0-d device tensor of a compiled step's seed table, saved as it is, so
    a replay reads the slot's value of that step). lse is an auxiliary
    output: its cotangent is dropped. The key bias gets no gradient (the
    op's Bias is not differentiable). On a CPU or meta tensor both
    directions take the plain versions, as ``flash_fwd``/``flash_bwd``
    do."""

    @staticmethod
    def forward(ctx, q, k, v, bias, n_heads, scale, causal, rate, seed,
                layout):
        out, lse = flash_fwd(q, k, v, n_heads, scale, causal, bias, rate,
                             seed, layout)
        seed_t = seed if isinstance(seed, torch.Tensor) else None
        ctx.save_for_backward(q, k, v, bias, out, lse, seed_t)
        ctx.args = (n_heads, scale, causal, rate, layout)
        ctx.seed = seed if seed_t is None else None
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, bias, out, lse, seed_t = ctx.saved_tensors
        n_heads, scale, causal, rate, layout = ctx.args
        dq, dk, dv, _ = flash_bwd(
            q, k, v, out, lse, dout.to(out.dtype).contiguous(), n_heads,
            scale, causal, bias, rate,
            ctx.seed if seed_t is None else seed_t, layout)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention(q, k, v, n_heads, scale, causal, bias=None, rate=0.0,
                    seed=0, layout="packed"):
    """(out, lse) of ``flash_fwd`` that autograd differentiates through
    the backward kernel (``FlashAttentionFunction``)."""
    return FlashAttentionFunction.apply(q, k, v, bias, n_heads, scale,
                                        causal, rate, seed, layout)


def packed_flash_fwd(q, k, v, n_heads, scale, causal, bias=None, rate=0.0,
                     seed=0):
    """``flash_fwd`` over the packed layout."""
    return flash_fwd(q, k, v, n_heads, scale, causal, bias, rate, seed)


def packed_flash_bwd(q, k, v, out, lse, dout, n_heads, scale, causal,
                     bias=None, rate=0.0, seed=0):
    """``flash_bwd`` over the packed layout."""
    return flash_bwd(q, k, v, out, lse, dout, n_heads, scale, causal, bias,
                     rate, seed)
