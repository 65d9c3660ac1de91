"""The programs of the linalg_ops / extra_ops slice that the CPU tests
build in both packages (at small widths) and chip_smoke's
``linalg_extra_card`` runs on the card (at the widths of the port's
models):

- ``mlm_nll``: a masked-LM loss by ``logsumexp`` + ``nll_loss`` over
  [N, V] logits and its gradient; ``mlm_softmax_ce``, the same loss by
  ``softmax_with_cross_entropy``, is its yardstick (BERT-base: N = b64 x
  s128 = 8192, V = 30522);
- ``ctr_auc``: ``layers.cos_sim`` of two [N, D] towers, then
  ``layers.auc`` over a streamed evaluation (N = 4096, D = 256, the
  reference's default 4095 thresholds);
- ``embedding_scatter``: ``scatter_nd`` of N id rows into an
  [R, W] table and ``shard_index`` of those ids for each shard (ERNIE-large's
  embedding, R = 18000, W = 1024);
- ``order_stats``: ``kthvalue``, ``median`` and ``mode`` along the last
  axis of [N, D] activations with ties (BERT-base's [8192, 768]);
- ``linalg``: ``cholesky`` or ``inverse`` of [B, M, M] matrices.

A builder takes a ``control_flow_cases.Pkg`` and returns its fetch vars;
``*_feed`` functions draw the feeds from a seed with numpy."""

from __future__ import annotations

import numpy as np


def _op(P, op_type, ins, outs, attrs):
    """One op appended through the package's LayerHelper; ``outs`` maps
    an output slot to its dtype. Returns {slot: var}."""
    helper = P.mod.layer_helper.LayerHelper(op_type)
    made = {s: [helper.create_variable_for_type_inference(dt)]
            for s, dt in outs.items()}
    helper.append_op(op_type, ins, made, attrs)
    return {s: v[0] for s, v in made.items()}


def mlm_nll(P, n, vocab):
    """mean(-(x - logsumexp(x))[label]) and its gradient by x."""
    L = P.L
    x = L.static_data("logits", [n, vocab], "float32")
    label = L.static_data("label", [n, 1], "int64")
    lse = _op(P, "logsumexp", {"X": [x]}, {"Out": "float32"},
              {"axis": [-1], "keepdim": True})["Out"]
    logp = L.elementwise_sub(x, lse)
    loss = _op(P, "nll_loss", {"X": [logp], "Label": [label]},
               {"Out": "float32", "Total_weight": "float32"},
               {"reduction": "mean", "ignore_index": -100})["Out"]
    g, = P.mod.gradients([loss], [x])
    return [loss, g]


def mlm_softmax_ce(P, n, vocab):
    """The same loss by softmax_with_cross_entropy, and its gradient."""
    L = P.L
    x = L.static_data("logits", [n, vocab], "float32")
    label = L.static_data("label", [n, 1], "int64")
    loss = L.mean(L.softmax_with_cross_entropy(x, label))
    g, = P.mod.gradients([loss], [x])
    return [loss, g]


def mlm_feed(n, vocab, seed=0):
    r = np.random.RandomState(seed)
    return {"logits": (r.randn(n, vocab) * 2).astype(np.float32),
            "label": r.randint(0, vocab, (n, 1)).astype(np.int64)}


def ctr_auc(P, n, d, num_thresholds=4095):
    """AUC of cos_sim(query, item) mapped to [0, 1], streamed: returns
    the AUC and the two stat vars."""
    L = P.L
    q = L.static_data("query", [n, d], "float32")
    t = L.static_data("item", [n, d], "float32")
    label = L.static_data("click", [n, 1], "int64")
    p = L.scale(L.cos_sim(q, t), scale=0.5, bias=0.5)
    pred = L.concat([L.scale(p, scale=-1.0, bias=1.0), p], axis=1)
    value, stats = L.auc(pred, label, num_thresholds=num_thresholds)
    return [value] + list(stats)


def ctr_feeds(n, d, batches, seed=0):
    """``batches`` feeds of two towers that agree more on clicked rows."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(batches):
        click = (r.rand(n, 1) < 0.3).astype(np.int64)
        q = r.randn(n, d).astype(np.float32)
        t = (r.randn(n, d) + click * 0.15 * q).astype(np.float32)
        out.append({"query": q, "item": t, "click": click})
    return out


def embedding_scatter(P, n, rows, width, nshards):
    """scatter_nd of the id rows into [rows, width] zeros, and
    shard_index of the ids for each of ``nshards`` shards."""
    L = P.L
    ids = L.static_data("ids", [n, 1], "int32")
    upd = L.static_data("rows", [n, width], "float32")
    out = [L.scatter_nd(ids, upd, shape=[rows, width])]
    for k in range(nshards):
        out.append(L.shard_index(ids, index_num=rows, nshards=nshards,
                                 shard_id=k, ignore_value=-1))
    return out


def embedding_feed(n, rows, width, seed=0):
    """Ids drawn from a small hot set (repeats), with some past the
    table and some negative (wrapped once, or still out and dropped)."""
    r = np.random.RandomState(seed)
    ids = r.randint(0, rows, n)
    hot = r.randint(0, rows, max(1, n // 64))
    rep = r.rand(n) < 0.5
    ids[rep] = hot[r.randint(0, hot.size, int(rep.sum()))]
    far = r.rand(n) < 0.02
    ids[far] = r.randint(rows, 2 * rows, int(far.sum()))
    neg = r.rand(n) < 0.02
    ids[neg] = -r.randint(1, 2 * rows, int(neg.sum()))
    return {"ids": ids.reshape(n, 1).astype(np.int32),
            "rows": r.randn(n, width).astype(np.float32)}


def scatter_nd_float64(ids, rows_, table_rows):
    """The scatter_nd reference in float64: a negative id wraps once, an
    id still out of range is dropped, repeats add."""
    ids = ids.reshape(-1).astype(np.int64)
    ids = np.where(ids < 0, ids + table_rows, ids)
    keep = (ids >= 0) & (ids < table_rows)
    out = np.zeros((table_rows, rows_.shape[1]), np.float64)
    np.add.at(out, ids[keep], rows_[keep].astype(np.float64))
    return out


def order_stats(P, n, d):
    """kthvalue (k = d // 2), median and mode along the last axis."""
    L = P.L
    x = L.static_data("act", [n, d], "float32")
    kth = _op(P, "kthvalue", {"X": [x]},
              {"Out": "float32", "Indices": "int64"},
              {"k": d // 2, "axis": -1, "keepdim": False})
    med = _op(P, "median", {"X": [x]}, {"Out": "float32"},
              {"axis": -1, "keepdim": False})
    mode = _op(P, "mode", {"X": [x]}, {"Out": "float32", "Indices": "int64"},
               {"axis": -1, "keepdim": False})
    return [kth["Out"], kth["Indices"], med["Out"], mode["Out"],
            mode["Indices"]]


def order_stats_feed(n, d, seed=0):
    """GELU-like activations rounded to 1/8: every row has ties."""
    r = np.random.RandomState(seed)
    x = r.randn(n, d).astype(np.float32)
    return {"act": np.round(x * 8.0) / 8.0}


def linalg(P, b, m, op="cholesky"):
    """``cholesky`` or ``inverse`` of [b, m, m] matrices (apart: a step
    holding ``inverse`` runs uncaptured on the card)."""
    L = P.L
    a = L.static_data("spd", [b, m, m], "float32")
    if op == "cholesky":
        return [_op(P, "cholesky", {"X": [a]}, {"Out": "float32"},
                    {"upper": False})["Out"]]
    return [_op(P, "inverse", {"Input": [a]}, {"Output": "float32"},
                {})["Output"]]


def linalg_feed(b, m, bad=1, seed=0):
    """``b`` symmetric positive definite matrices, member ``bad`` with a
    negative eigenvalue."""
    r = np.random.RandomState(seed)
    a = r.randn(b, m, m)
    s = a @ a.transpose(0, 2, 1) / m + np.eye(m)
    s[bad] -= 4.0 * np.eye(m)
    return {"spd": s.astype(np.float32)}
