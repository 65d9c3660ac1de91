"""label_semantic_roles (``models/srl.py``) in paddle_tpu_torch against
its twin built with paddle_tpu's layers on the CPU, by the layer calls
of the reference's ``tests/test_book_models2.py`` TestLabelSemanticRoles.

* The program JSON (main and startup) equals the twin's at the book's
  widths (``SRLConfig()``: words 44068 x 32, predicates 3162 x 32, marks
  2 x 5, fc and LSTMs of 512, 59 tags, 64 tokens) and at a narrow width.
* At the narrow width (the reference test's: 400 words, 50 predicates,
  hidden 64, LSTMs of 32, 9 tags, 12 tokens), from one state, 4 Adam
  steps at lr 0.01 over two batches in turn give the reference's losses
  within 1e-5 (op by op; the compiled step equals op by op bit for bit),
  and each batch's loss falls;
  then the trained decoder gives the reference's Viterbi paths bit for
  bit, 0 past each length.
* The reference test's own claim on the port: 50 steps on two fixed
  batches bring the loss under 0.6 of the first.
* The reference's startup state, carried by name (``scope_from_numpy``),
  covers every persistable the port's program reads, and one step from
  it gives the reference's loss.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core import unique_name as jax_names

from paddle_tpu_torch.core import unique_name as pt_names
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.scope import Scope, scope_from_numpy
from paddle_tpu_torch.models import srl

torch.set_num_threads(2)

NARROW = srl.SRLConfig(word_dict=400, pred_dict=50, mark_dict=2,
                       word_dim=32, mark_dim=8, hidden=64, lstm=32, tags=9)
S = 12


def jax_srl(cfg, seq_len=64, batch_size=-1, lr=0.01):
    """The twin: the reference test's layer calls at ``cfg``'s widths."""
    from paddle_tpu import layers
    from paddle_tpu.param_attr import ParamAttr

    main, startup = pt.Program(), pt.Program()
    with jax_names.guard(), pt.program_guard(main, startup):
        word = layers.static_data("word", [batch_size, seq_len], "int64")
        pred = layers.static_data("pred", [batch_size, seq_len], "int64")
        mark = layers.static_data("mark", [batch_size, seq_len], "int64")
        label = layers.static_data("label", [batch_size, seq_len], "int64")
        length = layers.static_data("length", [batch_size], "int64")
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
        loss = layers.mean(crf_cost)
        decode = layers.crf_decoding(
            emission, ParamAttr(name="srl_crf_trans"), length=length)
        pt.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss, decode


def _port(cfg, seq_len, batch_size=-1, lr=0.01):
    with pt_names.guard():
        main, startup, _, fetches = srl.build_srl_program(
            cfg, seq_len=seq_len, batch_size=batch_size, lr=lr)
    return main, startup, fetches["loss"], fetches["decode"]


def _json(prog):
    return json.loads(json.dumps(prog.to_dict()))


@pytest.mark.parametrize("width", ["book", "narrow"])
def test_program_json_equals_the_twin(width):
    cfg, s = (srl.SRLConfig(), 64) if width == "book" else (NARROW, S)
    jm, js, _, _ = jax_srl(cfg, s)
    pm, ps, _, _ = _port(cfg, s)
    assert _json(pm) == _json(jm) and _json(ps) == _json(js)
    types = [op.type for op in pm.global_block().ops]
    assert types.count("lstm") == 2 and "linear_chain_crf" in types \
        and "crf_decoding" in types
    trans = [v for v in pm.global_block().vars.values()
             if v.name == "srl_crf_trans"]
    assert len(trans) == 1 and list(trans[0].shape) == [cfg.tags + 2,
                                                        cfg.tags]


def _state(startup):
    sc = Scope()
    Executor(device="cpu").run(startup, scope=sc)
    return {n: v.numpy().copy() for n, v in sc.items()
            if isinstance(v, torch.Tensor)}


def test_training_and_decoding_equal_the_reference():
    jm, js, jloss, jdec = jax_srl(NARROW, S)
    pm, ps, ploss, pdec = _port(NARROW, S)
    state = _state(ps)
    batches = [srl.synthetic_batch(NARROW, 16, S, min_len=4, seed=s)
               for s in (0, 1, 0, 1)]
    jexe, jsc = pt.Executor(pt.CPUPlace()), pt.Scope()
    for n, v in state.items():
        jsc.set(n, jnp.asarray(v))
    want = [float(np.asarray(jexe.run(jm, feed=b, fetch_list=[jloss],
                                      scope=jsc)[0])) for b in batches]
    legs = {}
    for mode in (False, True):
        exe, sc = Executor(device="cpu"), scope_from_numpy(state, "cpu")
        legs[mode] = ([float(exe.run(pm, feed=b, fetch_list=[ploss],
                                     scope=sc, use_compiled=mode)[0])
                       for b in batches], sc, exe)
    np.testing.assert_allclose(legs[False][0], want, rtol=1e-5, atol=1e-5)
    assert legs[True][0] == legs[False][0]
    assert want[2] < want[0] and want[3] < want[1]
    probe = srl.synthetic_batch(NARROW, 16, S, min_len=1, seed=9)
    jpath, = jexe.run(jm, feed=probe, fetch_list=[jdec], scope=jsc)
    _, sc, exe = legs[False]
    ppath, = exe.run(pm, feed=probe, fetch_list=[pdec], scope=sc,
                     use_compiled=False)
    np.testing.assert_array_equal(ppath, np.asarray(jpath))
    valid = np.arange(S)[None, :] < probe["length"][:, None]
    assert not ppath[~valid].any() and ppath.max() < NARROW.tags


def test_reference_book_case_trains_on_the_port():
    """TestLabelSemanticRoles.test_trains_and_decodes's claim: on two
    fixed batches, 50 steps bring the loss under 0.6 of the first."""
    pm, ps, ploss, pdec = _port(NARROW, S)
    exe, sc = Executor(device="cpu"), Scope()
    exe.run(ps, scope=sc)
    fixed = [srl.synthetic_batch(NARROW, 16, S, min_len=4, seed=s)
             for s in range(2)]
    losses = [float(exe.run(pm, feed=fixed[s % 2], fetch_list=[ploss],
                            scope=sc)[0]) for s in range(50)]
    assert all(np.isfinite(losses))
    assert losses[-1] < 0.6 * losses[0], (losses[0], losses[-1])
    path, = exe.run(pm, feed=fixed[0], fetch_list=[pdec], scope=sc)
    assert path.shape == (16, S) and path.min() >= 0 \
        and path.max() < NARROW.tags


def test_the_reference_startup_state_carries_into_the_port():
    """The reference's own startup state, numpy by scope name through
    ``scope_from_numpy``, covers every name the port's program reads
    (the CRF transition, the LSTMs' weights, Adam's moments): one step
    from it gives the reference's loss within 1e-5."""
    jm, js, jloss, _ = jax_srl(NARROW, S)
    pm, _, ploss, _ = _port(NARROW, S)
    jexe, jsc = pt.Executor(pt.CPUPlace()), pt.Scope()
    jexe.run(js, scope=jsc, use_compiled=False)
    state = {n: np.asarray(v) for n, v in jsc.items()
             if hasattr(v, "shape")}
    needed = {v.name for v in pm.global_block().vars.values()
              if v.persistable}
    assert needed <= set(state), sorted(needed - set(state))
    batch = srl.synthetic_batch(NARROW, 8, S, min_len=2, seed=5)
    got = Executor(device="cpu").run(pm, feed=batch, fetch_list=[ploss],
                                     scope=scope_from_numpy(state, "cpu"))
    want = jexe.run(jm, feed=batch, fetch_list=[jloss], scope=jsc)
    np.testing.assert_allclose(float(got[0]), float(np.asarray(want[0])),
                               rtol=1e-5, atol=1e-5)
