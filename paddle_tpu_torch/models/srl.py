"""Semantic role labelling, the book's label_semantic_roles
(tests/book/test_label_semantic_roles.py), as the reference's
``tests/test_book_models2.py`` TestLabelSemanticRoles builds it: word,
predicate and mark embeddings -> fc (tanh) -> a forward and a reverse
LSTM -> an emission fc over the tags -> ``linear_chain_crf``, with
``crf_decoding`` reading the same transition parameter by its name.

``SRLConfig()`` holds the book's widths: the word dictionary of 44068
(conll05), the predicate dictionary of 3162, 2 marks, embeddings of 32
(marks 5), an fc and two LSTMs of 512 and 59 tags. Sentences are padded
to ``seq_len`` tokens with a length tensor."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import layers
from ..core.ir import Program, program_guard
from ..param_attr import ParamAttr


@dataclass
class SRLConfig:
    word_dict: int = 44068
    pred_dict: int = 3162
    mark_dict: int = 2
    word_dim: int = 32
    mark_dim: int = 5
    hidden: int = 512
    lstm: int = 512
    tags: int = 59


def srl_net(word, pred, mark, label, length, cfg: SRLConfig):
    """(the per-sentence CRF cost [B, 1], the emissions [B, S, tags])."""
    we = layers.embedding(word, [cfg.word_dict, cfg.word_dim],
                          param_attr=ParamAttr(name="srl_wemb"))
    pe = layers.embedding(pred, [cfg.pred_dict, cfg.word_dim],
                          param_attr=ParamAttr(name="srl_pemb"))
    me = layers.embedding(mark, [cfg.mark_dict, cfg.mark_dim],
                          param_attr=ParamAttr(name="srl_memb"))
    x = layers.concat([we, pe, me], axis=2)
    h = layers.fc(x, cfg.hidden, num_flatten_dims=2, act="tanh",
                  param_attr=ParamAttr(name="srl_fc0"))
    fwd, _, _ = layers.lstm_unit_layer(
        h, cfg.lstm, seq_length=length,
        param_attr=ParamAttr(name="srl_lf_wx"), name="srl_lf")
    bwd, _, _ = layers.lstm_unit_layer(
        h, cfg.lstm, is_reverse=True, seq_length=length,
        param_attr=ParamAttr(name="srl_lb_wx"), name="srl_lb")
    feat = layers.concat([fwd, bwd], axis=2)
    emission = layers.fc(feat, cfg.tags, num_flatten_dims=2,
                         param_attr=ParamAttr(name="srl_emit"))
    crf_cost = layers.linear_chain_crf(
        emission, label, param_attr=ParamAttr(name="srl_crf_trans"),
        length=length)
    return crf_cost, emission


def build_srl_program(cfg: SRLConfig = None, seq_len=64, batch_size=-1,
                      lr=0.01, with_optimizer=True):
    """(main, startup, feeds, fetches): word, pred, mark and label
    [B, S] and length [B], all int64; the mean CRF cost (``loss``) and
    the decoded path (``decode``), Adam at ``lr``."""
    cfg = cfg or SRLConfig()
    main, startup = Program(), Program()
    with program_guard(main, startup):
        feeds = {n: layers.static_data(n, [batch_size, seq_len], "int64")
                 for n in ("word", "pred", "mark", "label")}
        feeds["length"] = layers.static_data("length", [batch_size],
                                             "int64")
        crf_cost, emission = srl_net(feeds["word"], feeds["pred"],
                                     feeds["mark"], feeds["label"],
                                     feeds["length"], cfg)
        loss = layers.mean(crf_cost)
        decode = layers.crf_decoding(
            emission, ParamAttr(name="srl_crf_trans"), length=feeds["length"])
        if with_optimizer:
            from ..optimizer import AdamOptimizer

            AdamOptimizer(learning_rate=lr).minimize(loss)
    return main, startup, feeds, {"loss": loss, "decode": decode}


def synthetic_batch(cfg: SRLConfig, batch_size, seq_len=64, min_len=8,
                    seed=0):
    """Sentences of ``min_len`` to ``seq_len`` tokens (drawn from
    ``seed``), padded with 0. A learnable tagging: a token's tag is a
    function of its word and its mark."""
    rng = np.random.RandomState(seed)
    length = rng.randint(min(min_len, seq_len), seq_len + 1,
                         (batch_size,)).astype(np.int64)
    word = rng.randint(0, cfg.word_dict, (batch_size, seq_len))
    pred = np.repeat(rng.randint(0, cfg.pred_dict, (batch_size, 1)),
                     seq_len, axis=1)
    mark = rng.randint(0, cfg.mark_dict, (batch_size, seq_len))
    label = (word * 7 + mark * 3) % cfg.tags
    valid = np.arange(seq_len)[None, :] < length[:, None]
    return {"word": np.where(valid, word, 0).astype(np.int64),
            "pred": np.where(valid, pred, 0).astype(np.int64),
            "mark": np.where(valid, mark, 0).astype(np.int64),
            "label": np.where(valid, label, 0).astype(np.int64),
            "length": length}
