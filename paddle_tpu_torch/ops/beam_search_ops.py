"""Beam-search program ops (port of ``paddle_tpu/ops/beam_search_ops.py``:
beam_search :19, gather_tree :62, beam_search_decode :84).

The dense form of the reference: fixed [batch, beam] lanes a step, a
finished lane extending only with end_id at its frozen score. The top
beam_size candidates of a row are chosen as ``lax.top_k`` chooses them
(the larger first, the lower index among equals; ``math_ops.top_k``),
on the card as on the CPU."""

from __future__ import annotations

import torch

from ..core.registry import register_op
from .math_ops import top_k


def top_k_rows(x, k):
    """(values, int64 indices) of the k largest of each row of ``x``, in
    ``lax.top_k``'s order."""
    out = top_k({"X": [x]}, {"k": k})
    return out["Out"], out["Indices"].long()


@register_op("beam_search", non_diff_inputs=("pre_ids", "pre_scores",
                                             "scores", "ids"))
def beam_search(ins, attrs):
    """One step of beam expansion. pre_ids, pre_scores [B*W, 1]; scores
    [B*W, V]: accumulated log-probabilities with ``is_accumulated``, else
    probabilities, whose logs (floored at 1e-20) are added to
    pre_scores. selected_ids and selected_scores [B*W, 1], parent_idx
    [B*W] int32 (the flat index of the lane each selection extends)."""
    pre_ids = ins["pre_ids"][0].reshape(-1)
    pre_scores = ins["pre_scores"][0].reshape(-1)
    scores = ins["scores"][0]
    w = int(attrs["beam_size"])
    end_id = int(attrs["end_id"])
    bw, v = scores.shape
    b = bw // w
    if bool(attrs.get("is_accumulated", True)):
        total = scores
    else:
        total = pre_scores[:, None] + torch.log(torch.clamp(scores,
                                                            min=1e-20))
    finished = pre_ids == end_id
    frozen = torch.full_like(total, -1e9)
    frozen[:, end_id] = pre_scores
    total = torch.where(finished[:, None], frozen, total)
    top_scores, top_idx = top_k_rows(total.reshape(b, w * v), w)
    parent = top_idx // v
    token = top_idx % v
    rows = torch.arange(b, device=scores.device)[:, None]
    return {"selected_ids": token.reshape(-1, 1).to(pre_ids.dtype),
            "selected_scores": top_scores.reshape(-1, 1),
            "parent_idx": (rows * w + parent).reshape(-1).to(torch.int32)}


def _lanes(idx, w):
    """Lane indices as jnp's integer indexing takes them: a negative one
    wraps once, then all are clamped into [0, w)."""
    idx = idx.long()
    return torch.where(idx < 0, idx + w, idx).clamp(0, w - 1)


@register_op("gather_tree", non_diff_inputs=("Ids", "Parents"))
def gather_tree(ins, attrs):
    """Back-trace beams to full sequences: Ids, Parents [T, B, W] ->
    [T, B, W], from the last step to the first."""
    ids, parents = ins["Ids"][0], ins["Parents"][0]
    t, b, w = ids.shape
    parent = torch.arange(w, device=ids.device).expand(b, w)
    toks = [None] * t
    for step in reversed(range(t)):
        lane = _lanes(parent, w)
        toks[step] = torch.gather(ids[step], 1, lane)
        parent = torch.gather(parents[step], 1, lane)
    return {"Out": torch.stack(toks)}


@register_op("beam_search_decode", non_diff_inputs=("Ids", "Scores",
                                                    "ParentIdx"))
def beam_search_decode(ins, attrs):
    """The back-traced token grid of the stacked steps (Ids, ParentIdx
    [T, B, W]) and the final step's Scores [B, W] as they are."""
    out = gather_tree({"Ids": ins["Ids"], "Parents": ins["ParentIdx"]},
                      {})["Out"]
    return {"SentenceIds": out, "SentenceScores": ins["Scores"][0]}
