"""word2vec, the N-gram language model of the reference's book tests
(tests/book/test_word2vec.py): four context words, each looked up in one
shared embedding table, concatenated, a sigmoid hidden layer, a softmax
over the vocabulary. The port of ``paddle_tpu/models/word2vec.py``, built
op for op as the reference builds it (the two serialise to the same
JSON).

The lookups are ``is_sparse``: the table's gradient is a SelectedRows of
4 * batch rows (``ops/tensor_ops.py`` ``lookup_table_sparse_grad``, the
four summed by ``sum``'s concatenating branch), and the optimizer
updates only the rows the batch touched; no [dict_size, EMBED_SIZE]
gradient exists."""

from __future__ import annotations

import numpy as np

from .. import layers
from ..core.ir import Program, program_guard
from ..param_attr import ParamAttr

EMBED_SIZE = 32
HIDDEN_SIZE = 256
N = 5  # context window: 4 inputs predict the 5th
WORDS = ("firstw", "secondw", "thirdw", "fourthw")


def build_word2vec_program(dict_size: int, batch_size: int = -1,
                           lr: float = 1e-3, with_optimizer: bool = True):
    """(main, startup, feeds, fetches). Feeds: firstw..fourthw and nextw,
    [B,1] int64. Fetches: loss. ``with_optimizer`` appends SGD at ``lr``;
    without it the caller minimizes the loss with an optimizer of its
    own."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        words = [layers.static_data(n, [batch_size, 1], "int64")
                 for n in WORDS]
        nextw = layers.static_data("nextw", [batch_size, 1], "int64")
        embs = []
        for w in words:
            e = layers.embedding(w, [dict_size, EMBED_SIZE],
                                 param_attr=ParamAttr(name="shared_w"),
                                 is_sparse=True)
            embs.append(layers.reshape(e, [0, EMBED_SIZE]))
        concat = layers.concat(embs, axis=1)
        hidden = layers.fc(concat, HIDDEN_SIZE, act="sigmoid")
        logits = layers.fc(hidden, dict_size)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, nextw))
        if with_optimizer:
            from .. import optimizer as opt_mod

            opt_mod.SGDOptimizer(lr).minimize(loss)
    feeds = {v.name: v for v in words + [nextw]}
    return main, startup, feeds, dict(loss=loss)


def synthetic_batch(dict_size: int, batch_size: int, seed: int = 0):
    """The reference's batch: five [B,1] int64 columns of uniform ids."""
    rng = np.random.RandomState(seed)
    return {n: rng.randint(0, dict_size, (batch_size, 1)).astype(np.int64)
            for n in WORDS + ("nextw",)}
