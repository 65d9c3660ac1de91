"""Sentiment classification, the book's understand_sentiment pair
(tests/book/notest_understand_sentiment.py): conv_net (a sequence conv
and a max-pool over time) and stacked_lstm_net (an fc + LSTM stack of
alternating direction, max-pooled over time) over embedded ids. The
port of ``paddle_tpu/models/sentiment.py``, built op for op as the
reference builds it (the two serialise to the same JSON).

LoD sequences are [B, S] ids and a length tensor; the sequence max-pool
is a masked ``reduce_max`` over the time axis, padded positions at
-1e9."""

from __future__ import annotations

import numpy as np

from .. import layers
from ..core.ir import Program, program_guard
from ..param_attr import ParamAttr


def _masked_max_over_time(x, length, seq_len):
    """[B, S, D] -> [B, D], the max over each row's valid positions."""
    mask = layers.sequence_mask(length, maxlen=seq_len, dtype="float32")
    mask = layers.reshape(mask, [0, seq_len, 1])
    neg = (1.0 - mask) * (-1e9)
    return layers.reduce_max(x * mask + neg, dim=1)


def stacked_lstm_net(ids, length, input_dim, seq_len, class_dim=2,
                     emb_dim=32, hid_dim=64, stacked_num=3):
    """emb -> fc -> lstm, then (stacked_num - 1) x [fc(previous fc and
    lstm) -> lstm of alternating direction]; the last fc and lstm
    max-pooled over time; a softmax head."""
    assert stacked_num % 2 == 1
    emb = layers.embedding(ids, [input_dim, emb_dim],
                           param_attr=ParamAttr(name="sent_emb"))
    fc1 = layers.fc(emb, hid_dim, num_flatten_dims=2,
                    param_attr=ParamAttr(name="sent_fc1_w"))
    lstm1, _, _ = layers.lstm_unit_layer(
        fc1, hid_dim, seq_length=length,
        param_attr=ParamAttr(name="sent_l1_wx"), name="sent_l1")
    fc_prev, lstm_prev = fc1, lstm1
    for i in range(2, stacked_num + 1):
        cat = layers.concat([fc_prev, lstm_prev], axis=2)
        fc = layers.fc(cat, hid_dim, num_flatten_dims=2,
                       param_attr=ParamAttr(name=f"sent_fc{i}_w"))
        lstm, _, _ = layers.lstm_unit_layer(
            fc, hid_dim, is_reverse=(i % 2) == 0, seq_length=length,
            param_attr=ParamAttr(name=f"sent_l{i}_wx"), name=f"sent_l{i}")
        fc_prev, lstm_prev = fc, lstm
    fc_last = _masked_max_over_time(fc_prev, length, seq_len)
    lstm_last = _masked_max_over_time(lstm_prev, length, seq_len)
    return layers.fc(layers.concat([fc_last, lstm_last], axis=1),
                     class_dim, act="softmax",
                     param_attr=ParamAttr(name="sent_out_w"))


def conv_net(ids, length, input_dim, seq_len, class_dim=2, emb_dim=32,
             hid_dim=32, win=3):
    """emb -> a 1-D sequence conv of window ``win`` (a conv2d over
    [B, 1, S, E] with a win x E kernel) -> masked max-pool -> softmax."""
    emb = layers.embedding(ids, [input_dim, emb_dim],
                           param_attr=ParamAttr(name="sentc_emb"))
    x = layers.reshape(emb, [0, 1, seq_len, emb_dim])
    conv = layers.conv2d(x, hid_dim, (win, emb_dim),
                         padding=(win // 2, 0), act="tanh",
                         param_attr=ParamAttr(name="sentc_conv_w"))
    # [B, H, S, 1] -> [B, S, H]
    conv = layers.transpose(layers.reshape(conv, [0, hid_dim, seq_len]),
                            [0, 2, 1])
    pooled = _masked_max_over_time(conv, length, seq_len)
    return layers.fc(pooled, class_dim, act="softmax",
                     param_attr=ParamAttr(name="sentc_out_w"))


def build_sentiment_program(net="stacked_lstm", vocab=500, seq_len=16,
                            batch_size=-1, class_dim=2, lr=0.02,
                            with_optimizer=True):
    """(main, startup, feeds, fetches): words [B, S] and length [B]
    int64, label [B, 1]; the mean cross entropy and the accuracy, Adam
    at ``lr``."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        ids = layers.static_data("words", [batch_size, seq_len], "int64")
        length = layers.static_data("length", [batch_size], "int64")
        label = layers.static_data("label", [batch_size, 1], "int64")
        build = stacked_lstm_net if net == "stacked_lstm" else conv_net
        prob = build(ids, length, vocab, seq_len, class_dim=class_dim)
        loss = layers.mean(layers.cross_entropy(prob, label))
        acc = layers.accuracy(prob, label)
        if with_optimizer:
            from ..optimizer import AdamOptimizer

            AdamOptimizer(lr).minimize(loss)
    return main, startup, {"words": ids, "length": length,
                           "label": label}, {"loss": loss, "acc": acc}


def synthetic_batch(batch_size, vocab=500, seq_len=16, class_dim=2,
                    seed=0):
    """A learnable task: the label says which half of the vocabulary
    the valid tokens come from."""
    rng = np.random.RandomState(seed)
    length = rng.randint(seq_len // 2, seq_len + 1,
                         (batch_size,)).astype(np.int64)
    labels = rng.randint(0, class_dim, (batch_size, 1)).astype(np.int64)
    ids = np.zeros((batch_size, seq_len), np.int64)
    half = vocab // 2
    for b in range(batch_size):
        lo, hi = (0, half) if labels[b, 0] == 0 else (half, vocab)
        ids[b, :length[b]] = rng.randint(lo, hi, (length[b],))
    return {"words": ids, "length": length, "label": labels}
