"""Sequence ops on padded, static shapes (port of
``paddle_tpu/ops/sequence_ops.py``: all 16 op types, sequence_mask :28
through sequence_topk_avg_pooling :326).

As in the reference, a LoD sequence travels as values plus an explicit
offsets (``Lod``) or lengths tensor, and every output has a static
shape. Segment ids come from a ``searchsorted`` over the offsets; the
segment reductions are ``scatter_reduce`` / ``index_add`` into one row
more than there are segments, the extra row taking what jax's segment
ops drop (a row past the last offset). An index that jnp's integer
indexing would clamp is clamped here. No value is read on the host."""

from __future__ import annotations

import torch

from ..core.registry import register_op
from ..core.types import to_torch_dtype, x64_off


def _lod(ins, slot="Lod"):
    return ins[slot][0].reshape(-1).to(torch.int32)


def _segment_ids(lod, t):
    """The segment of each of ``t`` flat rows: how many offsets after the
    first are at or below it (B for a row past the last offset)."""
    pos = torch.arange(t, dtype=lod.dtype, device=lod.device)
    return torch.searchsorted(lod[1:].contiguous(), pos, right=True)


def _rows_like(idx, x):
    """A [T] row index broadcast to x's shape, for a scatter along 0."""
    return idx.reshape((-1,) + (1,) * (x.dim() - 1)).expand(x.shape)


def _lowest(dtype):
    return float("-inf") if dtype.is_floating_point \
        else torch.iinfo(dtype).min


def _segment_max(x, seg, b):
    """jax.ops.segment_max over ``b`` segments: an empty one is the
    dtype's lowest value, rows of segment b and beyond are dropped."""
    init = torch.full((b + 1,) + tuple(x.shape[1:]), _lowest(x.dtype),
                      dtype=x.dtype, device=x.device)
    return init.scatter_reduce(0, _rows_like(seg.clamp(max=b), x), x,
                               "amax")[:b]


def _segment_sum(x, seg, b):
    out = x.new_zeros((b + 1,) + tuple(x.shape[1:]))
    return out.index_add(0, seg.clamp(max=b), x)[:b]


@register_op("sequence_mask", non_diff_inputs=("X",))
def sequence_mask(ins, attrs):
    """lengths [B] -> [B, maxlen] mask in ``out_dtype`` (int64 is held as
    int32); maxlen must be a static attr."""
    lengths = ins["X"][0].reshape(-1)
    maxlen = int(attrs.get("maxlen", -1))
    if maxlen <= 0:
        raise ValueError("sequence_mask needs a static maxlen attr")
    dtype = x64_off(to_torch_dtype(attrs.get("out_dtype", "int64")))
    steps = torch.arange(maxlen, device=lengths.device)
    return {"Y": (steps[None, :] < lengths[:, None]).to(dtype)}


@register_op("sequence_pad", non_diff_inputs=("Lod", "PadValue"))
def sequence_pad(ins, attrs):
    """(flat values [T, ...], offsets [B+1]) -> padded [B, maxlen, ...]
    and Length [B] int32; padded_length is static."""
    x = ins["X"][0]
    lod = _lod(ins)
    maxlen = int(attrs.get("padded_length", -1))
    if maxlen <= 0:
        raise ValueError("sequence_pad needs a static padded_length")
    pad_val = ins["PadValue"][0].reshape(()).to(x.dtype) \
        if ins.get("PadValue") and ins["PadValue"][0] is not None else 0.0
    b = lod.shape[0] - 1
    starts = lod[:-1]
    lengths = lod[1:] - starts
    t_idx = torch.arange(maxlen, dtype=lod.dtype, device=lod.device)
    gather = starts[:, None] + torch.minimum(
        t_idx[None, :], torch.clamp(lengths[:, None] - 1, min=0))
    gather = gather.reshape(-1).long().clamp(0, max(x.shape[0] - 1, 0))
    padded = x.index_select(0, gather).reshape((b, maxlen)
                                               + tuple(x.shape[1:]))
    mask = t_idx[None, :] < lengths[:, None]
    mask = mask.reshape(tuple(mask.shape) + (1,) * (x.dim() - 1))
    return {"Out": torch.where(mask, padded, pad_val), "Length": lengths}


@register_op("sequence_unpad", non_diff_inputs=("Length",))
def sequence_unpad(ins, attrs):
    """Padded [B, S, ...] -> flat [B*S, ...]; the consumer reads Length."""
    x = ins["X"][0]
    return {"Out": x.reshape((x.shape[0] * x.shape[1],)
                             + tuple(x.shape[2:]))}


@register_op("sequence_pool", non_diff_inputs=("Lod",))
def sequence_pool(ins, attrs):
    """Pool each sequence of (flat values, offsets): SUM, MEAN/AVERAGE,
    SQRT (sum over sqrt of the length), MAX (an empty or non-finite
    result is 0), LAST, FIRST. Out [B, ...]; MaxIndex zeros [B] int32."""
    x = ins["X"][0]
    lod = _lod(ins)
    ptype = attrs.get("pooltype", "SUM").upper()
    b = lod.shape[0] - 1
    last_row = max(x.shape[0] - 1, 0)
    if ptype == "LAST":
        out = x.index_select(0, torch.clamp(lod[1:] - 1, 0, last_row).long())
    elif ptype == "FIRST":
        out = x.index_select(0, lod[:-1].clamp(0, last_row).long())
    elif ptype == "MAX":
        out = _segment_max(x, _segment_ids(lod, x.shape[0]), b)
        out = torch.where(torch.isfinite(out), out, 0.0).to(x.dtype)
    else:
        summed = _segment_sum(x, _segment_ids(lod, x.shape[0]), b)
        lengths = (lod[1:] - lod[:-1]).to(torch.float32).clamp(min=1.0)
        lengths = lengths.reshape((b,) + (1,) * (x.dim() - 1))
        if ptype in ("MEAN", "AVERAGE"):
            out = (summed / lengths).to(x.dtype)
        elif ptype == "SQRT":
            out = (summed / torch.sqrt(lengths)).to(x.dtype)
        else:
            out = summed.to(x.dtype)
    return {"Out": out, "MaxIndex": torch.zeros(b, dtype=torch.int32,
                                                device=x.device)}


@register_op("sequence_softmax", non_diff_inputs=("Lod",))
def sequence_softmax(ins, attrs):
    """Softmax within each sequence of flat values [T]. A row past the
    last offset takes the last sequence's max and sum, as the
    reference's clamped gather gives it."""
    x0 = ins["X"][0]
    x = x0.reshape(-1)
    lod = _lod(ins)
    b = lod.shape[0] - 1
    seg = _segment_ids(lod, x.shape[0])
    at = seg.clamp(max=b - 1).long()
    z = torch.exp(x - _segment_max(x, seg, b)[at])
    return {"Out": (z / _segment_sum(z, seg, b)[at]).reshape(x0.shape)}


@register_op("sequence_reverse", non_diff_inputs=("Lod",))
def sequence_reverse(ins, attrs):
    """Rows reversed within each sequence; a row outside every sequence
    stays."""
    x = ins["X"][0]
    lod = _lod(ins)
    t = x.shape[0]
    b = lod.shape[0] - 1
    seg = _segment_ids(lod, t).clamp(max=b - 1).long()
    starts, ends = lod[:-1][seg], lod[1:][seg]
    pos = torch.arange(t, dtype=lod.dtype, device=lod.device)
    rev = torch.where((pos >= starts) & (pos < ends),
                      starts + (ends - 1 - pos), pos)
    return {"Y": x.index_select(0, rev.long())}


@register_op("sequence_expand", non_diff_inputs=("Y", "Lod", "RefLod"))
def sequence_expand(ins, attrs):
    """Row i of X repeated as often as the i-th span of RefLod; the
    total is the static ``out_rows``."""
    x = ins["X"][0]
    total = int(attrs.get("out_rows", -1))
    if total <= 0:
        raise ValueError("sequence_expand needs a static out_rows attr")
    seg = _segment_ids(_lod(ins, "RefLod"), total)
    return {"Out": x.index_select(0, seg.clamp(
        max=max(x.shape[0] - 1, 0)).long())}


@register_op("sequence_concat", non_diff_inputs=("Lod",))
def sequence_concat(ins, attrs):
    """Inputs [B, S_i, ...] joined along time; OutLod the per-row sum of
    the Lod lengths [N, B] (or every S_i) as int32."""
    xs = ins["X"]
    out = torch.cat(xs, dim=1)
    if ins.get("Lod") and ins["Lod"][0] is not None:
        lod = ins["Lod"][0].sum(dim=0).to(torch.int32)
    else:
        lod = torch.full((xs[0].shape[0],), sum(x.shape[1] for x in xs),
                         dtype=torch.int32, device=out.device)
    return {"Out": out, "OutLod": lod}


@register_op("sequence_slice", non_diff_inputs=("Offset", "Length"))
def sequence_slice(ins, attrs):
    """A window of each row [B, S, ...] from its Offset, ``max_length``
    (or S) wide; positions past the row's Length are 0."""
    x = ins["X"][0]
    off = ins["Offset"][0].reshape(-1).to(torch.int32)
    ln = ins["Length"][0].reshape(-1).to(torch.int32)
    b, s = x.shape[0], x.shape[1]
    width = int(attrs.get("max_length", 0)) or s
    steps = torch.arange(width, dtype=torch.int32, device=x.device)
    pos = (off[:, None] + steps[None, :]).clamp(0, s - 1).long()
    rows = torch.arange(b, device=x.device)[:, None]
    out = x[rows, pos]
    valid = steps[None, :] < ln[:, None]
    valid = valid.reshape(tuple(valid.shape) + (1,) * (out.dim() - 2))
    return {"Out": torch.where(valid, out, 0), "OutLength": ln}


@register_op("sequence_reshape", non_diff_inputs=("Lod",))
def sequence_reshape(ins, attrs):
    """[B, S, D] -> [B, S*D/new_dim, new_dim]."""
    x = ins["X"][0]
    new_dim = int(attrs["new_dim"])
    b, s, d = x.shape
    return {"Out": x.reshape(b, s * d // new_dim, new_dim)}


@register_op("sequence_enumerate", non_diff_inputs=("X",))
def sequence_enumerate(ins, attrs):
    """[B, S] ids -> [B, S, win_size] windows from each step;
    positions past the end are pad_value."""
    x = ins["X"][0]
    win = int(attrs["win_size"])
    pad = int(attrs.get("pad_value", 0))
    s = x.shape[1]
    idx = torch.arange(s, device=x.device)[:, None] \
        + torch.arange(win, device=x.device)[None, :]
    gathered = x[:, idx.clamp(max=s - 1)]
    return {"Out": torch.where((idx < s)[None], gathered, pad)}


@register_op("sequence_scatter", non_diff_inputs=("Ids",))
def sequence_scatter(ins, attrs):
    """X [B, S]: X[b, Ids[b, k]] += Updates[b, k], summed in order; a
    negative id wraps once, one still out of range is dropped."""
    x = ins["X"][0]
    b, s = x.shape[0], x.shape[1]
    ids = ins["Ids"][0].long()
    ids = torch.where(ids < 0, ids + s, ids)
    rows = torch.arange(b, device=x.device)[:, None]
    flat = torch.where((ids >= 0) & (ids < s), rows * s + ids, b * s)
    rest = tuple(x.shape[2:])
    padded = torch.cat([x.reshape((b * s,) + rest),
                        x.new_zeros((1,) + rest)])
    upd = ins["Updates"][0].to(x.dtype).reshape((-1,) + rest)
    return {"Out": padded.index_add(0, flat.reshape(-1), upd)[:b * s]
            .reshape(x.shape)}


@register_op("sequence_erase", non_diff_inputs=("X",))
def sequence_erase(ins, attrs):
    """[B, S] ids with the listed tokens taken out: the kept ids move
    left in order, the tail is 0; OutLength the kept count (int32)."""
    x = ins["X"][0]
    b, s = x.shape
    keep = torch.ones_like(x, dtype=torch.bool)
    for tok in attrs.get("tokens", []):
        keep = keep & (x != int(tok))
    tgt = torch.cumsum(keep.to(torch.int32), dim=1) - 1
    tgt = torch.where(keep, tgt, s - 1).long()
    rows = torch.arange(b, device=x.device)[:, None]
    vals = torch.where(keep, x, torch.zeros_like(x))
    out = torch.zeros(b * s, dtype=x.dtype, device=x.device).index_add(
        0, (rows * s + tgt).reshape(-1), vals.reshape(-1)).reshape(b, s)
    return {"Out": out, "OutLength": keep.sum(dim=1, dtype=torch.int32)}


@register_op("sequence_conv")
def sequence_conv(ins, attrs):
    """A context window of ``contextLength`` rows from ``contextStart``
    (rows outside the sequence are 0), stacked and projected by Filter
    [win*D, M]. Only contextStride 1, as in the reference."""
    x, w = ins["X"][0], ins["Filter"][0]
    if int(attrs.get("contextStride", 1)) != 1:     # as the reference
        raise AssertionError("sequence_conv: only contextStride=1")
    start = int(attrs.get("contextStart", 0))
    win = int(attrs.get("contextLength", w.shape[0] // x.shape[-1]))
    s = x.shape[1]
    steps = torch.arange(s, device=x.device)
    cols = []
    for k in range(win):
        idx = steps + start + k
        valid = ((idx >= 0) & (idx < s))[None, :, None]
        cols.append(torch.where(valid, x[:, idx.clamp(0, s - 1)], 0))
    return {"Out": torch.matmul(torch.cat(cols, dim=-1), w)}


@register_op("sequence_expand_as", non_diff_inputs=("Y", "YLength"))
def sequence_expand_as(ins, attrs):
    """Each row of X [B, D] repeated over its span: YLength [B] (with
    the static ``max_len`` or Y's time axis as the width) or all of Y's
    time axis. Positions past the span are 0; OutLength int32."""
    x = ins["X"][0]
    y = ins.get("Y", [None])[0]
    ln = ins.get("YLength", [None])[0]
    if ln is not None:
        ln = ln.reshape(-1).to(torch.int32)
        s = int(attrs.get("max_len", 0)) or (
            y.shape[1] if y is not None else 0)
        if not s:
            raise ValueError("sequence_expand_as: pass max_len= (or a Y "
                             "input): the padded width must be static")
    else:
        s = y.shape[1]
        ln = torch.full((x.shape[0],), s, dtype=torch.int32,
                        device=x.device)
    out = x[:, None].expand((x.shape[0], s) + tuple(x.shape[1:]))
    mask = torch.arange(s, device=x.device)[None, :] < ln[:, None]
    mask = mask.reshape(tuple(mask.shape) + (1,) * (out.dim() - 2))
    return {"Out": torch.where(mask, out, 0).to(x.dtype), "OutLength": ln}


@register_op("sequence_topk_avg_pooling", non_diff_inputs=("ROW", "COLUMN"))
def sequence_topk_avg_pooling(ins, attrs):
    """Top-k average pooling over the rows of a match matrix X [B, C, R,
    W]: for each valid row and channel, the sum of its k largest valid
    columns over k for every k of ``topks`` (fewer valid columns than k
    keep the partial sum over k); pos the top max_k column indices, -1
    past the valid ones. The columns are ranked by a stable ascending
    sort of their negation, as the reference's ``argsort(-x)``: among
    equal values the lower column first. Out [B, R, C*len(topks)], pos
    [B, R, C*max_k] int32."""
    x0 = ins["X"][0]
    x = x0.to(torch.float32)
    b, c, r, w = x.shape
    row_ln = ins["ROW"][0].reshape(-1).to(torch.int32)
    col_ln = ins["COLUMN"][0].reshape(-1).to(torch.int32)
    topks = [int(k) for k in attrs.get("topks", [1])]
    max_k = max(topks)
    col_valid = torch.arange(w, device=x.device)[None, None, None, :] \
        < col_ln[:, None, None, None]
    masked = torch.where(col_valid, x, -3.4e38)
    order = torch.sort(-masked, dim=-1, stable=True)[1][..., :max_k]
    vals = torch.gather(masked, -1, order)
    kth_valid = torch.arange(max_k, device=x.device)[None, None, None, :] \
        < col_ln[:, None, None, None]
    prefix = torch.cumsum(torch.where(kth_valid, vals, 0.0), dim=-1)
    out = torch.stack([prefix[..., k - 1] / float(k) for k in topks], -1)
    row_valid = torch.arange(r, device=x.device)[None, None, :] \
        < row_ln[:, None, None]
    out = torch.where(row_valid[..., None], out, 0.0)
    out = out.transpose(1, 2).reshape(b, r, c * len(topks))
    pos = torch.where(kth_valid, order, -1)
    pos = pos.transpose(1, 2).reshape(b, r, c * max_k)
    pos = torch.where(row_valid[:, 0, :, None], pos, -1)
    return {"Out": out.to(x0.dtype), "pos": pos.to(torch.int32)}
