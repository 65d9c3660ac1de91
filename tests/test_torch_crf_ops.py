"""The CRF family of paddle_tpu_torch (``ops/crf_ops.py``:
linear_chain_crf, crf_decoding, ctc_align, edit_distance) and its layers
held against paddle_tpu on the CPU.

* The reference's own cases (``tests/test_crf_ops.py``): the CRF's
  negative log-likelihood and its Viterbi path against the brute-force
  oracle over every tag path (``_crf_brute``, imported), the label-mode
  correctness mask, the CTC-align and edit-distance fixtures with their
  Levenshtein oracle, and the tiny NER tagger that must train.
* Every CRF case of ``tools/glue_cases.py`` (ragged lengths with a 0 and
  an S, S = 1, Viterbi ties from equal emissions and tied transitions,
  bf16 emissions, no Length input, ``normalized`` with a reference length
  of 0) against the reference's lowering: floats within 1e-5, the paths,
  alignments and distances bit for bit.
* ``linear_chain_crf``'s gradients through the port's ``__vjp_grad__``
  against ``jax.vjp`` of the reference's lowering, within 2e-5 (an empty
  row gets none).
* The layers build the reference's program, ``crf_decoding`` finding the
  transition parameter that ``linear_chain_crf`` created.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.ops  # noqa: F401
from paddle_tpu.core import registry as jax_registry
from paddle_tpu.core import unique_name as jax_names
import tests.test_crf_ops as ref_crf
from tests.test_torch_math_tensor_ops import compare, ref_ops

import paddle_tpu_torch as ptt
from paddle_tpu_torch import layers as players
from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.core import unique_name as pt_names
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.param_attr import ParamAttr
from paddle_tpu_torch.tools.glue_cases import (BF16, CASES, as_tensor,
                                               crf_ins, family)
from paddle_tpu_torch.tools.glue_cases import rng as _rng

torch.set_num_threads(2)

TOL, GRAD_TOL = 1e-5, 2e-5


def _jax_in(v):
    if isinstance(v, BF16):
        return jnp.asarray(v.values, jnp.bfloat16)
    return jnp.asarray(v)


def run_ref(op, ins, attrs):
    return jax_registry.normalize_outputs(jax_registry.get(op).forward(
        {k: [None if v is None else _jax_in(v) for v in vs]
         for k, vs in ins.items()}, dict(attrs)))


def run_port(op, ins, attrs):
    return pt_registry.normalize_outputs(pt_registry.get(op).forward(
        {k: [None if v is None else as_tensor(v) for v in vs]
         for k, vs in ins.items()}, dict(attrs)))


def test_every_crf_op_type_is_registered():
    assert sorted(ref_ops("crf_ops")) == ["crf_decoding", "ctc_align",
                                          "edit_distance",
                                          "linear_chain_crf"]
    for op in ref_ops("crf_ops"):
        assert pt_registry.lookup(op) is not None


CRF_CASES = {c: f for c, f in CASES.items()
             if family(c.split("[")[0]) == "crf"}


@pytest.mark.parametrize("case", sorted(CRF_CASES))
def test_crf_op_matches_the_reference(case):
    op = case.split("[")[0]
    ins, attrs = CRF_CASES[case](_rng(case))
    want, got = run_ref(op, ins, attrs), run_port(op, ins, attrs)
    assert set(got) == set(want)
    for slot, vals in want.items():
        for i, w in enumerate(vals):
            compare(f"{case}:{slot}[{i}]", got[slot][i], w, TOL)


@pytest.mark.parametrize("lengths", [[4, 3, 2], [4, 0, 1]])
def test_crf_against_the_brute_force_oracle(lengths):
    """test_crf_ops.py TestLinearChainCRF / TestCRFDecoding: every tag
    path enumerated in float64."""
    r = np.random.RandomState(7)
    b, s, t = 3, 4, 3
    e = r.randn(b, s, t).astype(np.float32)
    w = (r.randn(t + 2, t) * 0.5).astype(np.float32)
    label = r.randint(0, t, (b, s)).astype(np.int64)
    length = np.array(lengths, np.int64)
    nll, best = ref_crf._crf_brute(e.astype(np.float64), w.astype(np.float64),
                           label, np.maximum(length, 1))
    nll[length == 0] = 0.0
    ins = {"Emission": [e], "Transition": [w], "Label": [label],
           "Length": [length]}
    got = run_port("linear_chain_crf", ins, {})["LogLikelihood"][0]
    np.testing.assert_allclose(got.numpy()[:, 0], nll, atol=1e-4)
    del ins["Label"]
    path = run_port("crf_decoding", ins, {})["ViterbiPath"][0].numpy()
    for i, ln in enumerate(lengths):
        np.testing.assert_array_equal(path[i, :ln], best[i, :ln])
        assert not path[i, ln:].any()
    ins["Label"] = [path]
    mask = run_port("crf_decoding", ins, {})["ViterbiPath"][0].numpy()
    np.testing.assert_array_equal(
        mask, (np.arange(s)[None, :] < length[:, None]).astype(np.int32))


def test_ctc_align_and_edit_distance_reference_fixtures():
    for cls in (ref_crf.TestCTCAlign, ref_crf.TestEditDistance):
        t = cls()
        t.setup()
        got = run_port(t.op_type, {k: [v] for k, v in t.inputs.items()},
                       t.attrs)
        for slot, want in t.outputs.items():
            g = got[slot][0].numpy()
            np.testing.assert_allclose(g, want.astype(g.dtype), rtol=1e-6,
                                       err_msg=f"{t.op_type}:{slot}")
    t = ref_crf.TestEditDistance()
    t.setup()
    got = run_port("edit_distance", {k: [v] for k, v in t.inputs.items()},
                   {"normalized": True})["Out"][0].numpy()
    rl = t.inputs["RefsLength"]
    np.testing.assert_allclose(got, t.outputs["Out"] / np.maximum(
        rl[:, None], 1), rtol=1e-6)


def test_edit_distance_against_the_levenshtein_oracle():
    r = np.random.RandomState(3)
    hyp = r.randint(0, 4, (6, 7)).astype(np.int64)
    ref = r.randint(0, 4, (6, 5)).astype(np.int64)
    hl = np.array([7, 0, 3, 1, 5, 2], np.int64)
    rl = np.array([5, 4, 0, 5, 2, 1], np.int64)
    got = run_port("edit_distance", {"Hyps": [hyp], "Refs": [ref],
                                     "HypsLength": [hl], "RefsLength": [rl]},
                   {"normalized": False})["Out"][0].numpy()[:, 0]
    want = [ref_crf.TestEditDistance._lev(hyp[i, :hl[i]], ref[i, :rl[i]])
            for i in range(6)]
    np.testing.assert_array_equal(got, np.array(want, np.float32))


GRAD_CASES = {
    "ragged": lambda r: crf_ins(r, [5, 3, 0, 1], 5),
    "full": lambda r: crf_ins(r, None, 4),
    "s1": lambda r: crf_ins(r, [1, 0], 1),
    "ties": lambda r: crf_ins(r, [4, 2, 4], 4, ties=True),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_crf_gradients_match_jax_vjp(case):
    r = _rng(f"grad[{case}]")
    ins = GRAD_CASES[case](r)
    fwd = jax_registry.get("linear_chain_crf").forward
    rest = {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()
            if k not in ("Emission", "Transition")}

    def f(e, w):
        out = fwd(dict(rest, Emission=[e], Transition=[w]), {})
        return out["LogLikelihood"], out["Alpha"]

    e, w = ins["Emission"][0], ins["Transition"][0]
    (ll, alpha), pull = jax.vjp(f, jnp.asarray(e), jnp.asarray(w))
    cts = [r.randn(*ll.shape).astype(np.float32),
           r.randn(*alpha.shape).astype(np.float32)]
    length = ins.get("Length", [None])[0]
    empty = None if length is None else np.asarray(length) == 0
    if empty is not None:
        cts[1][empty] = 0.0     # an empty row's cost has no gradient
    want = pull(tuple(jnp.asarray(c) for c in cts))
    pins = {f"In__{k}": [torch.from_numpy(np.array(v).astype(
        np.int32 if np.asarray(v).dtype == np.int64 else np.asarray(v).dtype))
        for v in vs] for k, vs in ins.items()}
    pins["OG__LogLikelihood"] = [torch.from_numpy(cts[0])]
    pins["OG__Alpha"] = [torch.from_numpy(cts[1])]
    got = pt_registry.get("__vjp_grad__").forward(
        pins, {"fwd_type": "linear_chain_crf", "fwd_attrs": {}})
    compare("dEmission", got["IG__Emission"][0], want[0], GRAD_TOL)
    compare("dTransition", got["IG__Transition"][0], want[1], GRAD_TOL)
    if empty is not None and empty.any():
        assert not got["IG__Emission"][0].numpy()[empty].any()


def _json(prog):
    return json.loads(json.dumps(prog.to_dict()))


def _layers(pkg, names, L, attr):
    main, startup = pkg.Program(), pkg.Program()
    with names.guard(), pkg.program_guard(main, startup):
        em = L.static_data("em", [4, 6, 5])
        label = L.static_data("label", [4, 6], "int64")
        ln = L.static_data("ln", [4], "int64")
        cost = L.linear_chain_crf(em, label, param_attr=attr(name="trans"),
                                  length=ln)
        path = L.crf_decoding(em, attr(name="trans"), length=ln)
        mask = L.crf_decoding(em, attr(name="trans"), label=label)
        ids, ids_len = L.ctc_greedy_decoder(em, blank=0, input_length=ln,
                                            padding_value=-1)
        dist, num = L.edit_distance(ids, label, normalized=False,
                                    input_length=ids_len, label_length=ln)
    return main, startup, [cost, path, mask, ids, ids_len, dist, num]


def test_layers_build_and_run_as_the_reference():
    jm, js, jf = _layers(pt, jax_names, pt.layers, pt.ParamAttr)
    pm, ps, pf = _layers(ptt, pt_names, players, ParamAttr)
    assert _json(pm) == _json(jm) and _json(ps) == _json(js)
    assert [p.name for p in pm.all_parameters()] == ["trans"]
    sc = Scope()
    Executor(device="cpu").run(ps, scope=sc)
    r = np.random.RandomState(1)
    feed = {"em": r.randn(4, 6, 5).astype(np.float32),
            "label": r.randint(0, 5, (4, 6)).astype(np.int64),
            "ln": np.array([6, 3, 0, 1], np.int64)}
    got = Executor(device="cpu").run(pm, feed=feed, fetch_list=pf, scope=sc)
    jsc = pt.Scope()
    jsc.set("trans", jnp.asarray(sc.find_var("trans").numpy()))
    want = pt.Executor(pt.CPUPlace()).run(jm, feed=feed, fetch_list=jf,
                                          scope=jsc)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, i
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=str(i))


def test_tiny_ner_tagger_trains_on_the_port():
    """test_crf_ops.py TestNERFixture on the port: embedding -> fc
    emissions -> CRF, Adam 0.05; the loss halves in 30 steps and the
    decoded tags beat 0.8 accuracy."""
    B, S, V, T = 8, 6, 30, 4
    main, startup = ptt.Program(), ptt.Program()
    with pt_names.guard(), ptt.program_guard(main, startup):
        words = players.data("words", [S], dtype="int64")
        label = players.data("label", [S], dtype="int64")
        length = players.data("length", [], dtype="int64")
        emb = players.embedding(words, [V, 16])
        emission = players.fc(emb, T, num_flatten_dims=2)
        nll = players.linear_chain_crf(emission, label, length=length,
                                       param_attr=ParamAttr(name="crf_t"))
        loss = players.mean(nll)
        decoded = players.crf_decoding(emission, ParamAttr(name="crf_t"),
                                       length=length)
        from paddle_tpu_torch.optimizer import AdamOptimizer

        AdamOptimizer(0.05).minimize(loss)
    r = np.random.RandomState(0)
    w = r.randint(0, V, (B, S)).astype(np.int64)
    y = (w % T).astype(np.int64)
    ln = r.randint(3, S + 1, (B,)).astype(np.int64)
    exe, sc = Executor(device="cpu"), Scope()
    exe.run(startup, scope=sc)
    losses = []
    for _ in range(30):
        lv, path = exe.run(main, feed={"words": w, "label": y,
                                       "length": ln},
                           fetch_list=[loss, decoded], scope=sc)
        losses.append(float(lv))
    assert losses[-1] < losses[0] * 0.5, losses
    valid = np.arange(S)[None, :] < ln[:, None]
    assert (path == y)[valid].mean() > 0.8
