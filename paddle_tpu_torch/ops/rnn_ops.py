"""LSTM and GRU over padded batches (port of ``paddle_tpu/ops/rnn_ops.py``:
lstm :18, gru :80).

The reference's ``lax.scan`` over the time axis becomes a Python loop
over the steps on tensors: one [B, 4H] (or [B, 3H]) product with the
recurrent weight a step, the input projection taken for every step at
once before the loop. Lengths stay on the device: a step past a row's
length keeps that row's state through a ``torch.where``, so no value is
read on the host and a compiled step can capture the op. The gradient
is the generic ``__vjp_grad__``, which runs this forward again under
autograd."""

from __future__ import annotations

import torch

from ..core.registry import register_op


def _opt(ins, slot):
    vals = ins.get(slot)
    return vals[0] if vals and vals[0] is not None else None


def _projected(ins, reverse):
    """The input projected to the gates, time major [S, B, G] (reversed
    in time with ``is_reverse``), plus the bias. Without WeightX the input
    is already the projected gates (the ``dynamic_lstm`` contract)."""
    x = ins["Input"][0]
    xs = x.transpose(0, 1)
    if reverse:
        xs = xs.flip(0)
    wx, bias = _opt(ins, "WeightX"), _opt(ins, "Bias")
    proj = xs if wx is None else torch.matmul(xs, wx)
    return proj if bias is None else proj + bias


def _alive(ins, s, t, reverse):
    """[B, 1] bool: whether step ``t`` lies inside each row's length (the
    step counted from the end with ``is_reverse``), or None without
    SequenceLength."""
    seq_len = _opt(ins, "SequenceLength")
    if seq_len is None:
        return None
    tt = s - 1 - t if reverse else t
    return (seq_len.reshape(-1) > tt)[:, None]


def _out(hs, reverse):
    """The per-step states [S] x [B, H] as Out [B, S, H], back in input
    order."""
    out = torch.stack(hs, dim=1)
    return out.flip(1) if reverse else out


@register_op("lstm", non_diff_inputs=("SequenceLength",))
def lstm(ins, attrs):
    """Input [B,S,D], WeightX [D,4H] (optional), WeightH [H,4H], Bias
    [4H], optional H0/C0 [B,H] and SequenceLength [B]. Out [B,S,H],
    LastH, LastC [B,H]. Gates in the order i, f, c (candidate), o. A
    padded step keeps the state, so Out there is the frozen h."""
    x, wh = ins["Input"][0], ins["WeightH"][0]
    b, s = x.shape[0], x.shape[1]
    hsz = wh.shape[0]
    reverse = bool(attrs.get("is_reverse", False))
    h = _opt(ins, "H0")
    c = _opt(ins, "C0")
    h = x.new_zeros((b, hsz)) if h is None else h
    c = x.new_zeros((b, hsz)) if c is None else c
    proj = _projected(ins, reverse)
    hs = []
    for t in range(s):
        gates = proj[t] + torch.matmul(h, wh)
        i, f, g, o = gates.split(hsz, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        alive = _alive(ins, s, t, reverse)
        if alive is not None:
            h_new = torch.where(alive, h_new, h)
            c_new = torch.where(alive, c_new, c)
        h, c = h_new, c_new
        hs.append(h)
    return {"Out": _out(hs, reverse), "LastH": h, "LastC": c}


@register_op("gru", non_diff_inputs=("SequenceLength",))
def gru(ins, attrs):
    """Input [B,S,D], WeightX [D,3H] (optional), WeightH [H,3H], Bias
    [3H], optional H0 [B,H] and SequenceLength [B]. Gates u (update), r
    (reset), c (candidate): h = u h + (1 - u) cand, the reset gate
    applied to h before its product with the candidate's weight."""
    x, wh = ins["Input"][0], ins["WeightH"][0]
    b, s = x.shape[0], x.shape[1]
    hsz = wh.shape[0]
    reverse = bool(attrs.get("is_reverse", False))
    h = _opt(ins, "H0")
    h = x.new_zeros((b, hsz)) if h is None else h
    proj = _projected(ins, reverse)
    wh_ur, wh_c = wh[:, :2 * hsz], wh[:, 2 * hsz:]
    hs = []
    for t in range(s):
        xp = proj[t]
        ur = torch.sigmoid(xp[:, :2 * hsz] + torch.matmul(h, wh_ur))
        u, r = ur.split(hsz, dim=-1)
        cand = torch.tanh(xp[:, 2 * hsz:] + torch.matmul(r * h, wh_c))
        h_new = u * h + (1.0 - u) * cand
        alive = _alive(ins, s, t, reverse)
        if alive is not None:
            h_new = torch.where(alive, h_new, h)
        h = h_new
        hs.append(h)
    return {"Out": _out(hs, reverse), "LastH": h}
