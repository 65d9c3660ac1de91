"""Paged cached-KV decode attention.

Replaces ``paddle_tpu/ops/pallas/paged_attention.py`` ``_pa_kernel``
(:74, launched at :160) with ``csrc/paged_attention.cu``. The kernel reads
only the pages that hold positions 0..pos of each row — the TPU kernel
DMAs all MP pages; positions past pos would get weight exactly 0 there,
so not reading them gives the same function. Each row's context is cut
into fixed chunks of ``CHUNK_TOKENS`` tokens, one block per (chunk, head,
row), each with its keys and values in flight together and an online
softmax inside the chunk; the chunks of a (row, head) are combined in
chunk order inside the same launch, by the block that takes the last
ticket of a small workspace. The chunk size is a constant of the kernel,
so a row's plan (``chunk_plan``) and every sum in it depend on the row's
own position alone. ``chunked_paged_attention`` emulates that plan and
its in-order combine in plain PyTorch, for the tests.

The combine's workspace (``_workspace``) holds the chunks' partials and
one ticket a (row, head), which every launch leaves 0: the stream's own
for an eager launch, so launches on two streams never share one, and one
of its own for a launch captured into a CUDA graph, its tickets zeroed
inside the graph before the launch, so a graph may replay on any stream,
beside eager launches or other graphs. Only a launch cut short by a
device fault could leave a ticket non-zero, and such a fault ends the
CUDA context for every later call anyway.

On a CPU or meta tensor the wrapper runs ``plain_paged_attention``; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0   # kernel launches since the last reset (not plain calls)

HEAD_DIMS = (32, 64, 128)   # template instances in csrc/paged_attention.cu
CHUNK_TOKENS = 128          # csrc/paged_attention.cu CHUNK

# (device index, stream) -> (partials, tickets) of eager launches on that
# stream
_WORKSPACE = {}


def plain_paged_attention(q, pool_k, pool_v, table, pos, n, hd, scale):
    """The same function in plain PyTorch: dense page gather + softmax
    attention with positions > pos masked out before the softmax (the
    reference's stock lowering, ``stock_paged_attention``)."""
    b = q.shape[0]
    page = pool_k.shape[1]
    mp = table.shape[1]
    idx = table.long()
    kh = pool_k[idx].reshape(b, mp * page, n, hd)
    vh = pool_v[idx].reshape(b, mp * page, n, hd)
    scores = torch.einsum("bnh,bsnh->bns", q.reshape(b, n, hd), kh) * scale
    keep = (torch.arange(mp * page, device=q.device)[None, None, :]
            <= pos.reshape(-1).long()[:, None, None])
    scores = scores.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bns,bsnh->bnh", probs, vh).reshape(b, n * hd)


def chunk_plan(pos: int, ctx: int, chunk: int = CHUNK_TOKENS):
    """The kernel's plan for one row at position ``pos`` of a context of
    ``ctx`` = MP * P tokens: [(first, end)] token ranges, one a block,
    combined in this order. Positions 0..pos (clamped to the context, at
    least one token); a function of the row's own pos alone."""
    length = min(max(int(pos) + 1, 1), ctx)
    return [(c, min(c + chunk, length)) for c in range(0, length, chunk)]


def chunked_paged_attention(q, pool_k, pool_v, table, pos, n, hd, scale,
                            chunk: int = CHUNK_TOKENS):
    """The kernel's algorithm in plain PyTorch, for the tests: each chunk
    of ``chunk_plan`` gives its max m, its sum l and its unnormalised
    o[hd]; the chunks are combined in chunk order,
    out = sum_c o_c e^(m_c - M) / sum_c l_c e^(m_c - M), M = max_c m_c.
    Rows are computed one by one, as the kernel's blocks never mix them."""
    b = q.shape[0]
    page = pool_k.shape[1]
    ctx = table.shape[1] * page
    out = torch.empty(b, n * hd, dtype=q.dtype)
    for i in range(b):
        qh = q[i].reshape(n, hd)
        parts = []
        for first, end in chunk_plan(int(pos[i]), ctx, chunk):
            tok = torch.arange(first, end)
            pid = table[i].long()[tok // page]
            k = pool_k[pid, tok % page].reshape(-1, n, hd)
            v = pool_v[pid, tok % page].reshape(-1, n, hd)
            s = torch.einsum("nh,snh->ns", qh, k) * scale
            m = s.max(dim=-1).values
            e = torch.exp(s - m[:, None])
            parts.append((m, e.sum(dim=-1), torch.einsum("ns,snh->nh", e, v)))
        big_m = torch.stack([m for m, _, _ in parts]).max(dim=0).values
        big_l = torch.zeros(n, dtype=q.dtype)
        big_o = torch.zeros(n, hd, dtype=q.dtype)
        for m, l, o in parts:
            w = torch.exp(m - big_m)
            big_l = big_l + l * w
            big_o = big_o + o * w[:, None]
        out[i] = (big_o / big_l[:, None]).reshape(-1)
    return out


def _lib():
    lib = _build.load("paged_attention")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.pt_paged_attention.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp,
                                           ci, ci, ci, ci, ci, ci,
                                           ctypes.c_float, vp]
        lib.pt_paged_attention.restype = ci
        lib._typed = True
    return lib


def _workspace(dev, stream, b, n, hd, mp, page):
    """(partials, tickets) of the kernel's combine on ``stream``: at least
    b * n * ceil(mp * page / CHUNK_TOKENS) * (hd + 2) floats and b * n
    int32 tickets, all 0. The stream's own, grown where a call needs
    more; while the stream captures a CUDA graph, a new pair allocated and
    its tickets zeroed inside the capture: the graph owns it and zeroes
    the tickets before the launch on every replay, so it never shares a
    workspace with eager launches or with another graph, whatever stream
    it replays on."""
    need = b * n * -(-mp * page // CHUNK_TOKENS) * (hd + 2)
    if torch.cuda.is_current_stream_capturing():
        return (torch.empty(need, dtype=torch.float32, device=dev),
                torch.zeros(b * n, dtype=torch.int32, device=dev))
    key = (dev.index, stream)
    ws = _WORKSPACE.get(key)
    if ws is None or ws[0].numel() < need or ws[1].numel() < b * n:
        old = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        ws = (torch.empty(max(need, old[0]), dtype=torch.float32,
                          device=dev),
              torch.zeros(max(b * n, old[1]), dtype=torch.int32, device=dev))
        _WORKSPACE[key] = ws
    return ws


def _refuse(q, pool_k, pool_v, table, pos, n, hd):
    """Raise the message for the first argument the kernel cannot read."""
    b = q.shape[0]
    num_pages, page, kvdim = pool_k.shape
    mp = table.shape[1] if table.dim() == 2 else -1
    dev = q.device
    if hd not in HEAD_DIMS or kvdim != n * hd:
        raise ValueError(f"paged attention kernel: head_dim {hd} not in "
                         f"{HEAD_DIMS} or kvdim {kvdim} != {n}*{hd}")
    for name, t, dt, shape in (
            ("q", q, torch.float32, (b, n * hd)),
            ("pool_k", pool_k, torch.float32, (num_pages, page, kvdim)),
            ("pool_v", pool_v, torch.float32, (num_pages, page, kvdim)),
            ("page_table", table, torch.int32, (b, mp)),
            ("positions", pos, torch.int32, (b,))):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous() \
                or (dt == torch.float32 and t.data_ptr() % 16):
            raise ValueError(f"paged attention kernel: {name} must be a "
                             f"contiguous {dt} {shape} tensor on {dev} "
                             f"(fp32 ones 16-byte aligned), got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    raise ValueError("paged attention kernel: arguments it cannot read")


def _launch(q, pool_k, pool_v, table, pos, n, hd, scale):
    global launches
    f32, i32 = torch.float32, torch.int32
    dev = q.device
    b = q.shape[0]
    _, page, kvdim = pool_k.shape
    # one pass of cheap tests; _refuse names the argument at fault
    if not (hd in HEAD_DIMS and kvdim == n * hd and q.dim() == 2
            and q.shape[1] == kvdim and table.dim() == 2
            and table.shape[0] == b and pos.shape == (b,)
            and q.dtype == f32 and pool_k.dtype == f32
            and pool_v.dtype == f32 and table.dtype == i32
            and pos.dtype == i32 and pool_v.shape == pool_k.shape
            and pool_k.device == dev and pool_v.device == dev
            and table.device == dev and pos.device == dev
            and q.is_contiguous() and pool_k.is_contiguous()
            and pool_v.is_contiguous() and table.is_contiguous()
            and pos.is_contiguous()
            and not (q.data_ptr() | pool_k.data_ptr()
                     | pool_v.data_ptr()) % 16):
        _refuse(q, pool_k, pool_v, table, pos, n, hd)
    mp = table.shape[1]
    stream = torch.cuda.current_stream(dev).cuda_stream
    part, tickets = _workspace(dev, stream, b, n, hd, mp, page)
    out = torch.empty((b, kvdim), dtype=f32, device=dev)
    rc = _lib().pt_paged_attention(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        table.data_ptr(), pos.data_ptr(), out.data_ptr(), part.data_ptr(),
        tickets.data_ptr(), b, n, hd, page, mp, kvdim, float(scale), stream)
    _build.check(rc, "paged attention")
    launches += 1
    return out


def paged_decode_attention(q, pool_k, pool_v, table, positions, num_heads,
                           head_dim, scale):
    """Attend each row's query over its own paged KV context.

    q [B, n*hd] fp32; pool_k/pool_v [N, P, kvdim] already holding the
    step's K/V; table [B, MP] int32 page ids; positions [B] int32
    (context = 0..pos). Returns [B, n*hd]."""
    n, hd = int(num_heads), int(head_dim)
    pos = positions.reshape(-1)
    if q.device.type in ("cpu", "meta"):
        return plain_paged_attention(q, pool_k, pool_v, table, pos, n, hd,
                                     scale)
    if q.device.type == "cuda":
        return _launch(q.contiguous(), pool_k, pool_v, table.contiguous(),
                       pos.contiguous(), n, hd, scale)
    raise ValueError(f"paged attention: unsupported device {q.device}")
