"""The fused RNN ops (port of ``paddle_tpu/ops/fused_rnn_ops.py``:
fusion_lstm :42, fusion_gru :109, attention_lstm :167,
fusion_seqconv_eltadd_relu :251, fusion_seqexpand_concat_fc :267).

Each op takes the input projection of every step in one product before
its recurrence, as the reference does, then loops over the time axis on
tensors: one product with the recurrent weight a step. Lengths stay on
the device (a step past a row's length keeps the carry through a
``torch.where`` and emits zeros), so no value is read on the host and a
compiled step can capture every op here.

Each op keeps the reference's own gate layout, so no cell function is
shared: ``fusion_lstm`` is c~, i, f, o with configurable activations
(``jit/refer/refer.h:172``), ``fusion_gru`` is u, r, c~ with
h = u c~ + (1 - u) h (``origin_mode`` flips it), ``attention_lstm`` is
f, i, o, c~ with the hidden rows first in LSTMWeight
(``attention_lstm_op.cc:405``). The ``lstm`` op of ``rnn_ops.py`` is
i, f, c~, o with fixed sigmoid and tanh."""

from __future__ import annotations

import torch

from ..core.registry import register_op
from .sequence_ops import sequence_conv

_ACTS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
         "identity": lambda x: x}


def _act(name):
    return _ACTS[name or "identity"]


def _opt(ins, slot):
    vals = ins.get(slot)
    return vals[0] if vals and vals[0] is not None else None


def _seq_len(ins):
    ln = _opt(ins, "SequenceLength")
    return None if ln is None else ln.reshape(-1)


def _projected(ins, reverse):
    """XX [B, S, G] (the input projected to the gates, plus the bias) and
    its steps time major [S, B, G], reversed in time with ``is_reverse``."""
    xx = torch.matmul(ins["X"][0], ins["WeightX"][0])
    bias = _opt(ins, "Bias")
    if bias is not None:
        xx = xx + bias.reshape(-1)
    xs = xx.transpose(0, 1)
    return xx, xs.flip(0) if reverse else xs


def _alive(seq_len, s, t, reverse):
    if seq_len is None:
        return None
    tt = s - 1 - t if reverse else t
    return (seq_len > tt)[:, None]


def _stacked(steps, reverse):
    out = torch.stack(steps, dim=1)
    return out.flip(1) if reverse else out


@register_op("fusion_lstm", non_diff_inputs=("SequenceLength",))
def fusion_lstm(ins, attrs):
    """X [B, S, M], WeightX [M, 4H], WeightH [H, 4H], Bias [4H], optional
    H0 / C0 [B, H] and SequenceLength [B]. XX [B, S, 4H] (the fused
    pre-projection), Hidden and Cell [B, S, H]. Gates c~, i, f, o under
    ``gate_activation`` / ``cell_activation`` / ``candidate_activation``;
    ``use_peepholes`` raises, as in the reference."""
    if bool(attrs.get("use_peepholes", False)):
        raise NotImplementedError("fusion_lstm: use_peepholes=True")
    x, wh = ins["X"][0], ins["WeightH"][0]
    b, s = x.shape[0], x.shape[1]
    hsz = wh.shape[0]
    act_gate = _act(attrs.get("gate_activation", "sigmoid"))
    act_cell = _act(attrs.get("cell_activation", "tanh"))
    act_cand = _act(attrs.get("candidate_activation", "tanh"))
    h, c = _opt(ins, "H0"), _opt(ins, "C0")
    h = x.new_zeros((b, hsz)) if h is None else h
    c = x.new_zeros((b, hsz)) if c is None else c
    seq_len = _seq_len(ins)
    reverse = bool(attrs.get("is_reverse", False))
    xx, xs = _projected(ins, reverse)
    hs, cs = [], []
    for t in range(s):
        gates = xs[t] + torch.matmul(h, wh)
        cand, i, f, o = gates.split(hsz, dim=-1)
        c_new = act_cand(cand) * act_gate(i) + act_gate(f) * c
        h_new = act_gate(o) * act_cell(c_new)
        alive = _alive(seq_len, s, t, reverse)
        if alive is None:
            h, c = h_new, c_new
            hs.append(h)
            cs.append(c)
            continue
        h = torch.where(alive, h_new, h)
        c = torch.where(alive, c_new, c)
        hs.append(torch.where(alive, h, 0.0))
        cs.append(torch.where(alive, c, 0.0))
    return {"XX": xx, "Hidden": _stacked(hs, reverse),
            "Cell": _stacked(cs, reverse)}


@register_op("fusion_gru", non_diff_inputs=("SequenceLength",))
def fusion_gru(ins, attrs):
    """X [B, S, M], WeightX [M, 3H], WeightH [H, 3H] ({W_u, W_r; W_c}),
    Bias [3H], optional H0 [B, H] and SequenceLength [B]. XX [B, S, 3H],
    Hidden [B, S, H]. h = u c~ + (1 - u) h, or with ``origin_mode``
    u h + (1 - u) c~; the reset gate scales h before its product with
    the candidate's weight."""
    x, wh = ins["X"][0], ins["WeightH"][0]
    b, s = x.shape[0], x.shape[1]
    hsz = wh.shape[0]
    act_gate = _act(attrs.get("gate_activation", "sigmoid"))
    act_cand = _act(attrs.get("activation", "tanh"))
    origin = bool(attrs.get("origin_mode", False))
    h = _opt(ins, "H0")
    h = x.new_zeros((b, hsz)) if h is None else h
    seq_len = _seq_len(ins)
    reverse = bool(attrs.get("is_reverse", False))
    xx, xs = _projected(ins, reverse)
    wh_ur, wh_c = wh[:, :2 * hsz], wh[:, 2 * hsz:]
    hs = []
    for t in range(s):
        xp = xs[t]
        ur = act_gate(xp[:, :2 * hsz] + torch.matmul(h, wh_ur))
        u, r = ur.split(hsz, dim=-1)
        cand = act_cand(xp[:, 2 * hsz:] + torch.matmul(r * h, wh_c))
        h_new = u * h + (1.0 - u) * cand if origin \
            else u * cand + (1.0 - u) * h
        alive = _alive(seq_len, s, t, reverse)
        if alive is None:
            h = h_new
            hs.append(h)
            continue
        h = torch.where(alive, h_new, h)
        hs.append(torch.where(alive, h, 0.0))
    return {"XX": xx, "Hidden": _stacked(hs, reverse)}


@register_op("attention_lstm", non_diff_inputs=("SequenceLength",))
def attention_lstm(ins, attrs):
    """An LSTM whose input at each step is an attention pool over the
    whole sequence, keyed on the previous cell state. X [B, S, M], C0
    [B, D], optional H0 [B, D], AttentionWeight [M + D, 1], optional
    AttentionBias, AttentionScalar and AttentionScalarBias [1],
    LSTMWeight [D + M, 4D] (the hidden rows first), LSTMBias [4D],
    optional SequenceLength [B]. Gates f, i, o, c~. Hidden and Cell
    [B, S, D], zeros past each length. An all-masked row pools nothing
    (its weights are 0, not NaN)."""
    x = ins["X"][0]
    b, s, m = x.shape
    c = ins["C0"][0]
    d = c.shape[-1]
    h = _opt(ins, "H0")
    h = x.new_zeros((b, d)) if h is None else h
    atten_w = ins["AttentionWeight"][0].reshape(m + d, 1)
    atten_b = _opt(ins, "AttentionBias")
    scalar = _opt(ins, "AttentionScalar")
    scalar_b = _opt(ins, "AttentionScalarBias")
    lstm_w = ins["LSTMWeight"][0]
    lstm_b = ins["LSTMBias"][0].reshape(-1)
    act_gate = _act(attrs.get("gate_activation", "sigmoid"))
    act_cell = _act(attrs.get("cell_activation", "tanh"))
    act_cand = _act(attrs.get("candidate_activation", "tanh"))
    seq_len = _seq_len(ins)
    if seq_len is None:
        seq_len = torch.full((b,), s, dtype=torch.int64, device=x.device)
    pos_ok = torch.arange(s, device=x.device)[None, :] < seq_len[:, None]

    # the x part of the attention fc, shared by every step
    atted_x = torch.matmul(x, atten_w[:m])[..., 0]          # [B, S]
    if atten_b is not None:
        atted_x = atted_x + atten_b.reshape(())
    w_h, w_x = lstm_w[:d], lstm_w[d:]
    w_c = atten_w[m:].reshape(d)
    hs, cs = [], []
    for t in range(s):
        fc = torch.relu(atted_x + torch.matmul(c, w_c)[:, None])
        if scalar is not None:
            fc = fc * scalar.reshape(())
            if scalar_b is not None:
                fc = fc + scalar_b.reshape(())
            fc = torch.relu(fc)
        fc = torch.where(pos_ok, fc, -1e30)
        wgt = torch.exp(fc - fc.amax(dim=1, keepdim=True))
        wgt = torch.where(pos_ok, wgt, 0.0)
        wgt = wgt / wgt.sum(dim=1, keepdim=True).clamp(min=1e-30)
        lstm_x = torch.einsum("bs,bsm->bm", wgt.to(x.dtype), x)
        gates = torch.matmul(lstm_x, w_x) + torch.matmul(h, w_h) + lstm_b
        f = act_gate(gates[:, :d])
        i = act_gate(gates[:, d:2 * d])
        o = act_gate(gates[:, 2 * d:3 * d])
        c_new = f * c + i * act_cand(gates[:, 3 * d:])
        h_new = o * act_cell(c_new)
        alive = (seq_len > t)[:, None]
        h = torch.where(alive, h_new, h)
        c = torch.where(alive, c_new, c)
        hs.append(torch.where(alive, h, 0.0))
        cs.append(torch.where(alive, c, 0.0))
    return {"Hidden": torch.stack(hs, dim=1), "Cell": torch.stack(cs, dim=1)}


@register_op("fusion_seqconv_eltadd_relu")
def fusion_seqconv_eltadd_relu(ins, attrs):
    """relu(sequence_conv(X, Filter) + Bias): the port's ``sequence_conv``
    window with the bias add and the relu behind it."""
    out = sequence_conv({"X": ins["X"], "Filter": ins["Filter"]},
                        attrs)["Out"]
    return {"Out": torch.relu(out + ins["Bias"][0].reshape(-1))}


@register_op("fusion_seqexpand_concat_fc")
def fusion_seqexpand_concat_fc(ins, attrs):
    """fc(concat(X0, X1.., axis -1)) under ``fc_activation``: X0 [B, S, D0]
    is the sequence, every other Xi [B, Di] one row a sequence broadcast
    over the time axis; FCWeight [sum Di, H], optional FCBias [H]."""
    xs = ins["X"]
    x0 = xs[0]
    b, s = x0.shape[0], x0.shape[1]
    parts = [x0] + [xi[:, None, :].expand(b, s, xi.shape[-1]).to(x0.dtype)
                    for xi in xs[1:]]
    out = torch.matmul(torch.cat(parts, dim=-1), ins["FCWeight"][0])
    bias = _opt(ins, "FCBias")
    if bias is not None:
        out = out + bias.reshape(-1)
    return {"Out": _act(attrs.get("fc_activation", "identity"))(out)}
