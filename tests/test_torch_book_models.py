"""The recurrent book models and VGG16 in paddle_tpu_torch against
paddle_tpu on the CPU: seq2seq machine translation (trained, then
decoded greedily and by beam search), understand_sentiment's two nets,
and image_classification's VGG16.

Each model builds the reference's program JSON (main and startup) at
its full width. From one state, carried across by
``scope_from_numpy``, both packages train 3 steps on the same batches
and give the same losses: within 1e-5 for seq2seq, 1e-4 for sentiment
(products and recurrences accumulate in their own order, and Adam at lr
0.02 moves a weight by up to lr whatever its gradient's size), 1e-4 for
VGG16
(batch norm over 4 images amplifies sum order, so each of its steps
starts from the reference's state); the port runs op by op and
compiled, the reference compiled. Both start from the port's startup
state. After training a small copy task, the greedy and beam
decoders give the reference's ids bit for bit at the reference test's
size (``tests/test_models.py:182``), and beam search with K = 1 and no
length penalty equals greedy."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core import unique_name as jax_names
from paddle_tpu.models import seq2seq as jseq
from paddle_tpu.models import sentiment as jsent
from paddle_tpu.models import vision_extra as jvis

from paddle_tpu_torch.core import unique_name as pt_names
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.scope import Scope, scope_from_numpy
from paddle_tpu_torch.models import seq2seq as pseq
from paddle_tpu_torch.models import sentiment as psent
from paddle_tpu_torch.models import vision_extra as pvis

torch.set_num_threads(2)


def _json(prog):
    return json.loads(json.dumps(prog.to_dict()))


def _build(jfn, pfn):
    with jax_names.guard():
        j = jfn()
    with pt_names.guard():
        p = pfn()
    return j, p


FULL = {
    "seq2seq": lambda m: m.build_seq2seq_program(m.Seq2SeqConfig(), 32, 32,
                                                 batch_size=64),
    "sentiment_lstm": lambda m: m.build_sentiment_program(
        net="stacked_lstm", batch_size=128),
    "sentiment_conv": lambda m: m.build_sentiment_program(net="conv",
                                                          batch_size=128),
    "vgg16": lambda m: m.build_vgg_program(batch_size=128),
    "vgg16_test": lambda m: m.build_vgg_program(is_test=True),
}
MODULES = {"seq2seq": (jseq, pseq), "sentiment_lstm": (jsent, psent),
           "sentiment_conv": (jsent, psent), "vgg16": (jvis, pvis),
           "vgg16_test": (jvis, pvis)}


@pytest.mark.parametrize("name", sorted(FULL))
def test_program_json_equals_the_reference(name):
    jm_, pm_ = MODULES[name]
    (jm, js, jf, jfe), (pm, ps, pf, pfe) = _build(
        lambda: FULL[name](jm_), lambda: FULL[name](pm_))
    assert _json(pm) == _json(jm) and _json(ps) == _json(js)
    assert list(pf) == list(jf) and list(pfe) == list(jfe)


def test_synthetic_batches_equal_the_reference():
    cfg = jseq.Seq2SeqConfig()
    for a, b in ((jseq.synthetic_translation_batch(cfg, 4, 7, 5, seed=3),
                  pseq.synthetic_translation_batch(pseq.Seq2SeqConfig(), 4,
                                                   7, 5, seed=3)),
                 (jsent.synthetic_batch(5, seed=2),
                  psent.synthetic_batch(5, seed=2)),
                 (jvis.synthetic_batch(2, seed=1),
                  pvis.synthetic_batch(2, seed=1))):
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def _start(startup):
    """The port's startup state as numpy arrays (both packages start from
    it; the reference's random initializers draw other bits)."""
    scope = Scope()
    Executor(device="cpu").run(startup, scope=scope)
    return {n: v.numpy().copy() for n, v in scope.items()
            if isinstance(v, torch.Tensor)}


def _train_both(jbuild, pbuild, batches, tol, use_compiled, chained=True):
    """Both packages' losses over ``batches`` from one start state; with
    ``chained`` False each port step starts from the reference's state
    before that step (a trajectory that batch norm over a few rows
    spreads is held step by step)."""
    (jm, js, _, jfe), (pm, ps, _, pfe) = _build(jbuild, pbuild)
    state = _start(ps)
    jexe, jsc = pt.Executor(pt.CPUPlace()), pt.Scope()
    for n, v in state.items():
        jsc.set(n, jnp.asarray(v))
    psc = scope_from_numpy(state, "cpu")
    pexe = Executor(device="cpu")
    losses = []
    for i, feed in enumerate(batches):
        if not chained:
            psc = scope_from_numpy({n: np.array(v) for n, v in jsc.items()},
                                   "cpu")
        jv, = jexe.run(jm, feed=feed, fetch_list=[jfe["loss"]], scope=jsc)
        pv, = pexe.run(pm, feed=feed, fetch_list=[pfe["loss"].name],
                       scope=psc, use_compiled=use_compiled)
        np.testing.assert_allclose(np.asarray(pv).reshape(-1),
                                   np.asarray(jv).reshape(-1), rtol=tol,
                                   atol=tol, err_msg=f"step {i}")
        losses.append(float(np.asarray(pv).reshape(-1)[0]))
    return losses


SMALL_S2S = dict(src_vocab_size=40, tgt_vocab_size=36, embed_dim=16,
                 hidden_size=24)


@pytest.mark.parametrize("use_compiled", [False, True])
def test_seq2seq_trains_as_the_reference(use_compiled):
    jcfg, pcfg = jseq.Seq2SeqConfig(**SMALL_S2S), \
        pseq.Seq2SeqConfig(**SMALL_S2S)
    batches = [jseq.synthetic_translation_batch(jcfg, 6, 7, 5, seed=s)
               for s in range(3)]
    losses = _train_both(
        lambda: jseq.build_seq2seq_program(jcfg, 7, 5, lr=1e-2),
        lambda: pseq.build_seq2seq_program(pcfg, 7, 5, lr=1e-2),
        batches, 1e-5, use_compiled)
    assert all(np.isfinite(losses))


@pytest.mark.parametrize("net", ["stacked_lstm", "conv"])
def test_sentiment_trains_as_the_reference(net):
    batches = [jsent.synthetic_batch(16, seed=s) for s in range(3)]
    _train_both(lambda: jsent.build_sentiment_program(net=net,
                                                      batch_size=16),
                lambda: psent.build_sentiment_program(net=net,
                                                      batch_size=16),
                batches, 1e-4, net == "conv")


def test_vgg16_trains_as_the_reference():
    batches = [jvis.synthetic_batch(4, seed=s) for s in range(3)]
    _train_both(lambda: jvis.build_vgg_program(batch_size=4, lr=3e-4),
                lambda: pvis.build_vgg_program(batch_size=4, lr=3e-4),
                batches, 1e-4, True, chained=False)


@pytest.fixture(scope="module")
def trained_copy_task():
    """The reference's decode test, shortened: a copy task trained on the
    JAX side, its state carried to the port."""
    cfg = dict(src_vocab_size=24, tgt_vocab_size=24, embed_dim=16,
               hidden_size=32)
    s = 6
    with jax_names.guard():
        main, startup, _, fetches = jseq.build_seq2seq_program(
            jseq.Seq2SeqConfig(**cfg), src_len=s, tgt_len=s, lr=2e-2)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope, use_compiled=False)
    rng = np.random.RandomState(0)
    for _ in range(150):
        src = rng.randint(3, 24, (16, s)).astype(np.int64)
        feed = dict(src_ids=src, src_mask=np.ones((16, s), np.float32),
                    tgt_in=np.concatenate([np.ones((16, 1), np.int64),
                                           src[:, :-1]], 1),
                    tgt_out=src, tgt_mask=np.ones((16, s), np.float32))
        exe.run(main, feed=feed, fetch_list=[fetches["loss"]], scope=scope)
    src = rng.randint(3, 24, (4, s)).astype(np.int64)
    mask = np.ones((4, s), np.float32)
    mask[1, 4:] = 0.0                       # a shorter source row too
    pscope = scope_from_numpy({n: np.array(v) for n, v in scope.items()},
                              "cpu")
    return cfg, scope, pscope, src, mask, s


@pytest.mark.parametrize("beam", [1, 3, 4])
def test_decoding_gives_the_reference_ids(trained_copy_task, beam):
    cfg, jscope, pscope, src, mask, s = trained_copy_task
    jcfg, pcfg = jseq.Seq2SeqConfig(**cfg), pseq.Seq2SeqConfig(**cfg)
    g_ref = jseq.greedy_decode(jcfg, jscope, src, mask, max_len=s)
    g = pseq.greedy_decode(pcfg, pscope, src, mask, max_len=s)
    assert g.dtype == np.int32 and g.shape == (4, s)
    np.testing.assert_array_equal(g, g_ref)
    lp = 0.0 if beam == 1 else 0.6
    b_ref = jseq.beam_search_decode(jcfg, jscope, src, mask, beam_size=beam,
                                    max_len=s, length_penalty=lp)
    b = pseq.beam_search_decode(pcfg, pscope, src, mask, beam_size=beam,
                                max_len=s, length_penalty=lp)
    assert b.dtype == np.int32
    np.testing.assert_array_equal(b, b_ref)
    if beam == 1:
        np.testing.assert_array_equal(b, g)     # K = 1 beam == greedy
    # the decode reflects the trained copy task (chance is 1/24)
    assert float((g == src).mean()) > 0.15
