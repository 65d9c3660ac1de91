"""Lowerings the reference keeps in ``paddle_tpu/ops/extra_ops2.py``:
gru_unit :132, lstm_unit :154 and warpctc :172 (the recurrent cells and
the CTC loss of the 2.0 ``nn`` layers)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register_op


@register_op("gru_unit")
def gru_unit(ins, attrs):
    """One GRU step: Input [B, 3D] holds x's projected update, reset and
    candidate parts, Weight [D, 3D] the hidden projections (u/r in the
    first 2D columns)."""
    xp, h_prev, w = ins["Input"][0], ins["HiddenPrev"][0], ins["Weight"][0]
    bias = (ins.get("Bias") or [None])[0]
    d = h_prev.shape[1]
    g = xp + bias if bias is not None else xp
    gate = torch.sigmoid(g[:, :2 * d] + h_prev @ w[:, :2 * d])
    u, r = gate[:, :d], gate[:, d:]
    c = torch.tanh(g[:, 2 * d:] + (r * h_prev) @ w[:, 2 * d:])
    h = u * h_prev + (1.0 - u) * c
    return {"Hidden": h, "Gate": torch.cat([gate, c], dim=1),
            "ResetHiddenPrev": r * h_prev}


@register_op("lstm_unit")
def lstm_unit(ins, attrs):
    """One LSTM step from pre-activation gates X [B, 4D] in the order
    i, f, c, o."""
    x, c_prev = ins["X"][0], ins["C_prev"][0]
    fb = float(attrs.get("forget_bias", 0.0))
    d = c_prev.shape[1]
    i, f, cc, o = x[:, :d], x[:, d:2 * d], x[:, 2 * d:3 * d], x[:, 3 * d:]
    c = torch.sigmoid(f + fb) * c_prev + torch.sigmoid(i) * torch.tanh(cc)
    return {"C": c, "H": torch.sigmoid(o) * torch.tanh(c)}


@register_op("warpctc", non_diff_inputs=("Label", "LogitsLength",
                                         "LabelLength"))
def warpctc(ins, attrs):
    """CTC loss of batch-first logits [B, T, C] (softmax applied here) and
    labels [B, L]; the lengths default to T and L. Loss [B, 1] is each
    sequence's negative log-likelihood, as ``optax.ctc_loss`` gives it in
    the reference; a label sequence no alignment reaches gives inf here,
    where the reference's log-space floor gives about 1e5."""
    logits, labels = ins["Logits"][0], ins["Label"][0]
    blank = int(attrs.get("blank", 0))
    b, t, _ = logits.shape
    lt = (ins.get("LogitsLength") or [None])[0]
    ll = (ins.get("LabelLength") or [None])[0]
    in_len = torch.full((b,), t, dtype=torch.long, device=logits.device) \
        if lt is None else lt.reshape(-1).long()
    lab_len = torch.full((b,), labels.shape[1], dtype=torch.long,
                         device=logits.device) \
        if ll is None else ll.reshape(-1).long()
    logp = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    loss = F.ctc_loss(logp, labels.long(), in_len, lab_len, blank=blank,
                      reduction="none", zero_infinity=False)
    return {"Loss": loss.reshape(-1, 1).to(logits.dtype),
            "WarpCTCGrad": torch.zeros_like(logits)}
