"""A 2.0-style ``nn`` network at BERT-base's widths and its seeded
synthetic data: the imperative mode's main path (chip_smoke's
``dygraph_bert_base`` and ``dygraph_parity``) and the CPU tests' eager
model.

``bert_classifier(nn)`` builds the network from the ``nn`` module it is
given (the port's, or another package's with the same API, as the tests
do): word and position ``Embedding``s, a post-LN ``TransformerEncoder``
of ``TransformerEncoderLayer``s (gelu, dropout) and a ``Linear`` head on
token 0. Its forward takes (ids, positions, key bias): the bias is the
additive key-padding mask [B, 1, 1, S] (0 on a token, -1e4 on padding),
the form that reaches the flash kernel as a key bias.

``synthetic_rows(n, seq, vocab, seed)`` gives (ids, positions, bias,
labels) as numpy arrays: token 0 is one of 16 ids and the label is its
parity, so a few steps lower the loss; each row's length is drawn in
[seq / 2, seq].
"""

from __future__ import annotations

import numpy as np

BERT_BASE = dict(vocab=30522, max_pos=512, d_model=768, heads=12,
                 ffn=3072, layers=12, dropout=0.1, classes=2)


def bert_classifier(nn, vocab=30522, max_pos=512, d_model=768, heads=12,
                    ffn=3072, layers=12, dropout=0.1, classes=2):
    """The network, built from ``nn`` (its Layer classes)."""

    class BertClassifier(nn.Layer):
        def __init__(self):
            super().__init__()
            self.word = nn.Embedding(vocab, d_model)
            self.pos = nn.Embedding(max_pos, d_model)
            self.encoder = nn.TransformerEncoder(
                lambda: nn.TransformerEncoderLayer(
                    d_model, heads, ffn, dropout=dropout,
                    activation="gelu"), layers)
            self.head = nn.Linear(d_model, classes)

        def forward(self, ids, pos, bias):
            x = self.word(ids) + self.pos(pos)
            x = self.encoder(x, src_mask=bias)
            return self.head(x[:, 0])

    return BertClassifier()


def synthetic_rows(n, seq, vocab=30522, seed=0):
    """(ids int64 [n, seq], positions int64 [n, seq], key bias float32
    [n, 1, 1, seq], labels int64 [n, 1])."""
    r = np.random.RandomState(seed)
    ids = r.randint(16, vocab, (n, seq)).astype(np.int64)
    ids[:, 0] = r.randint(0, 16, n)
    lengths = r.randint(seq // 2, seq + 1, n)
    keep = np.arange(seq)[None, :] < lengths[:, None]
    bias = np.where(keep, 0.0, -1e4).astype(np.float32)
    pos = np.tile(np.arange(seq, dtype=np.int64), (n, 1))
    labels = (ids[:, :1] % 2).astype(np.int64)
    return ids, pos, bias.reshape(n, 1, 1, seq), labels
