"""Sequence-labelling ops (port of ``paddle_tpu/ops/crf_ops.py``:
linear_chain_crf :35, crf_decoding :96, ctc_align :167, edit_distance
:203).

Sequences are padded: Emission [B, S, T] with a Length [B] tensor. The
reference's ``lax.scan`` recurrences become Python loops over the time
axis on tensors, each step one batched [B, T, T] reduction; lengths stay
on the device (a step past a row's length keeps that row's state through
a ``torch.where``), so no value is read on the host and a compiled step
can capture every op here. ``Alpha`` is in log space, as in the
reference (not the C++ operator's L1-normalised linear space). The
gradient of ``linear_chain_crf`` is the generic ``__vjp_grad__``, which
differentiates this forward.

Transition is [T + 2, T]: row 0 the start weights, row 1 the stop
weights, rows 2.. the tag-to-tag weights (``linear_chain_crf_op.h:184``).
"""

from __future__ import annotations

import torch

from ..core.registry import register_op


def _lengths(ln, b, s, device):
    """The [B] lengths as int64 (all S without a Length tensor)."""
    if ln is None:
        return torch.full((b,), s, dtype=torch.int64, device=device)
    return ln.reshape(-1).long()


def _valid(length, s):
    return torch.arange(s, device=length.device)[None, :] < length[:, None]


@register_op("linear_chain_crf", non_diff_inputs=("Label", "Length"))
def linear_chain_crf(ins, attrs):
    """Negative log-likelihood of a linear-chain CRF: LogLikelihood [B, 1]
    = log Z - the gold path's score (0 for an empty row, which gets no
    gradient). Emission [B, S, T] and Transition [T + 2, T] in fp32,
    Label [B, S], Length [B] (optional). Alpha [B, S, T] holds the
    log-space forward variables; EmissionExps and TransitionExps are
    kept for the reference's output contract."""
    e = ins["Emission"][0].float()
    w = ins["Transition"][0].float()
    label = ins["Label"][0].long()
    b, s, _ = e.shape
    length = _lengths(ins.get("Length", [None])[0], b, s, e.device)
    start_w, stop_w, trans = w[0], w[1], w[2:]
    valid = _valid(length, s)

    alpha = start_w[None, :] + e[:, 0]
    alphas = [alpha]
    for t in range(1, s):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) \
            + e[:, t]
        alpha = torch.where(valid[:, t, None], nxt, alpha)
        alphas.append(alpha)
    log_z = torch.logsumexp(alpha + stop_w[None, :], dim=1)

    em_lab = torch.gather(e, 2, label[:, :, None])[..., 0]
    score = start_w[label[:, 0]] + torch.where(valid, em_lab, 0.0).sum(1)
    tr_lab = trans[label[:, :-1], label[:, 1:]]
    score = score + torch.where(valid[:, 1:], tr_lab, 0.0).sum(1)
    last = (length - 1).clamp(min=0)
    last_lab = torch.gather(label, 1, last[:, None])[:, 0]
    score = score + stop_w[last_lab]

    ll = torch.where(length > 0, log_z - score, 0.0)
    return {"LogLikelihood": ll[:, None],
            "Alpha": torch.stack(alphas, dim=1),
            "EmissionExps": torch.exp(e - e.amax(-1, keepdim=True)),
            "TransitionExps": torch.exp(w)}


@register_op("crf_decoding", non_diff_inputs=("Emission", "Transition",
                                              "Label", "Length"))
def crf_decoding(ins, attrs):
    """Viterbi decoding with back-pointers: ViterbiPath [B, S] (int64, held
    as int32 as the reference holds it with 64-bit types off), the
    best tag path (ties to the lower tag, as ``jnp.argmax``), 0 past each
    length. With Label, the 0/1 mask of where the path equals it."""
    e = ins["Emission"][0].float()
    w = ins["Transition"][0].float()
    b, s, _ = e.shape
    length = _lengths(ins.get("Length", [None])[0], b, s, e.device)
    start_w, stop_w, trans = w[0], w[1], w[2:]
    valid = _valid(length, s)

    alpha = start_w[None, :] + e[:, 0]
    back = []
    for t in range(1, s):
        cand = alpha[:, :, None] + trans[None]          # [B, T, T]
        back.append(torch.argmax(cand, dim=1))
        alpha = torch.where(valid[:, t, None], cand.amax(dim=1) + e[:, t],
                            alpha)
    tag = torch.argmax(alpha + stop_w[None, :], dim=1)
    # walk the pointers from the last position back: the pointer out of
    # position t + 1 moves the chain only inside the row's path, so a
    # row's tag stays the last one from its length - 1 on
    path = [tag] * s
    for t in range(s - 2, -1, -1):
        prev = torch.gather(back[t], 1, tag[:, None])[:, 0]
        tag = torch.where(t + 1 <= length - 1, prev, tag)
        path[t] = tag
    path = torch.where(valid, torch.stack(path, dim=1), 0)

    label = ins.get("Label", [None])[0]
    if label is not None:
        ok = (path == label.long()) & valid
        return {"ViterbiPath": ok.int()}
    return {"ViterbiPath": path.int()}


@register_op("ctc_align", non_diff_inputs=("Input", "InputLength"))
def ctc_align(ins, attrs):
    """Merge repeated tokens, then drop ``blank``: Output [B, S] (int64,
    held as int32), left-packed, the tail ``padding_value``; OutputLength [B, 1] int32.
    Each kept token goes to its own column and every dropped one to a
    spare column past S, so the scatter has no two writes to one place."""
    x = ins["Input"][0].int()
    b, s = x.shape
    blank = int(attrs.get("blank", 0))
    length = _lengths(ins.get("InputLength", [None])[0], b, s, x.device)
    first = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=x.device),
                       x[:, 1:] != x[:, :-1]], dim=1)
    keep = first & (x != blank) & _valid(length, s)
    dst = torch.where(keep, keep.long().cumsum(1) - 1, s)
    out = torch.full((b, s + 1), int(attrs.get("padding_value", 0)),
                     dtype=torch.int32, device=x.device)
    out = out.scatter(1, dst, x)[:, :s]
    return {"Output": out,
            "OutputLength": keep.sum(1).int().reshape(b, 1)}


@register_op("edit_distance", non_diff_inputs=("Hyps", "Refs",
                                               "HypsLength", "RefsLength"))
def edit_distance(ins, attrs):
    """Levenshtein distance of each row: Hyps [B, S1] against Refs
    [B, S2] with optional lengths; Out [B, 1] float32 (divided by the
    reference length, at least 1, with ``normalized``), SequenceNum [1]
    int32. The DP walks the hypothesis positions; each new row is
    row'[j] = min(row'[j - 1] + 1, base[j]), a running minimum, taken at
    once as ``cummin`` of base[j] - j."""
    hyp = ins["Hyps"][0].int()
    ref = ins["Refs"][0].int()
    b, s1 = hyp.shape
    s2 = ref.shape[1]
    hl = _lengths(ins.get("HypsLength", [None])[0], b, s1, hyp.device)
    rl = _lengths(ins.get("RefsLength", [None])[0], b, s2, hyp.device)
    cols = torch.arange(s2 + 1, dtype=torch.float32, device=hyp.device)
    row = cols.expand(b, s2 + 1)
    for i in range(s1):
        sub = (ref != hyp[:, i:i + 1]).float()
        base = torch.minimum(row[:, 1:] + 1.0, row[:, :-1] + sub)
        first = torch.full((b, 1), float(i + 1), device=hyp.device)
        v = torch.cat([first, base], dim=1) - cols
        new = torch.cummin(v, dim=1).values + cols
        row = torch.where((hl > i)[:, None], new, row)
    dist = torch.gather(row, 1, rl[:, None])[:, 0]
    if bool(attrs.get("normalized", False)):
        dist = dist / rl.float().clamp(min=1.0)
    return {"Out": dist[:, None],
            "SequenceNum": torch.full((1,), b, dtype=torch.int32,
                                      device=hyp.device)}
