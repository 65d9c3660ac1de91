"""Slim quantisation and the int8 serving path, held against the reference
on the CPU.

* The reference's own cases (``tests/test_quant_kv.py`` ``TestQATPass``
  and ``TestPTQ``, ``tests/test_int8_inference.py``, all three), imported
  and run as they are with the names they import pointed at the port's
  (``pt``, ``layers``, ``slim``, the predictor, the name generator).
* Each fake quantise-dequantise op, ``dequantize_weight`` and the
  static-quant ``int8_matmul`` against the reference's lowering on the
  same numpy inputs: bit for bit. The straight-through gradients of a QAT
  step on the reference's weights: within 1e-6 (the fp32 products of
  the two packages may differ in the last bits).
* The programs: the QAT pass, PTQ and both converts give the reference's
  JSON; ``calibrated_scales`` and the int8 scope (arrays and
  ``@int8_scale`` vectors) equal the reference's bit for bit.
* BERT-tiny in int8 (weight-only and static) through the predictor's
  seven passes in both packages: the same pass JSON, logits within 1e-5
  (weight-only: fp32 products in both) and 1e-4 (static: a 1-ulp
  difference of an activation may move its int8 value by one step; the
  bound is that step's share of the logits), the same argmax. An int8 dir
  saved and loaded keeps its int8 weights int8; ``scope_from_numpy``
  carries the reference's int8 scope unchanged.
"""

import functools
import types

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.contrib.slim as jslim
import paddle_tpu.core.unique_name as j_unique
import paddle_tpu.ops.quant_ops as jq
from paddle_tpu import layers as jl
from paddle_tpu.inference.predictor import (AnalysisConfig as JConfig,
                                            AnalysisPredictor as JPredictor)

import paddle_tpu_torch as ptt
import paddle_tpu_torch.contrib.slim as pslim
import paddle_tpu_torch.ops.quant_ops as pq
from paddle_tpu_torch import io as pio
from paddle_tpu_torch import initializer, optimizer, param_attr
from paddle_tpu_torch import layers as pl
from paddle_tpu_torch.core import unique_name as p_unique
from paddle_tpu_torch.core.scope import scope_from_numpy
from paddle_tpu_torch.inference import predictor as ppred

import tests.test_int8_inference as ref_int8
import tests.test_quant_kv as ref_quant
from tests.test_torch_passes import (FEEDS, NSP, _json, _scope_arrays,
                                     bert_batch, bert_tiny_inference)

torch.set_num_threads(2)

# the port's user surface under the reference's names
PORT_PT = types.SimpleNamespace(
    Program=ptt.Program, program_guard=ptt.program_guard,
    Executor=functools.partial(ptt.Executor, device="cpu"),
    Scope=ptt.Scope, ParamAttr=param_attr.ParamAttr, optimizer=optimizer,
    initializer=initializer)


@pytest.fixture
def port_in_reference(monkeypatch):
    """Point the names the reference's slim cases import at the port's;
    the reference's name-generator switch also switches the port's, so a
    rebuilt inference program gets the training program's names."""
    for mod in (ref_quant, ref_int8):
        monkeypatch.setattr(mod, "pt", PORT_PT)
        monkeypatch.setattr(mod, "layers", pl)
    monkeypatch.setattr(ref_int8, "slim", pslim)
    monkeypatch.setattr(ref_int8, "AnalysisConfig",
                        functools.partial(ppred.AnalysisConfig, device="cpu"))
    monkeypatch.setattr(ref_int8, "AnalysisPredictor",
                        ppred.AnalysisPredictor)
    for name in ("QuantizationTransformPass", "PostTrainingQuantization",
                 "quantize_weights_int8", "convert_to_int8_program"):
        monkeypatch.setattr(jslim, name, getattr(pslim, name))
    real_switch = j_unique.switch

    def switch(gen=None):
        p_unique.switch()
        return real_switch(gen)

    monkeypatch.setattr(j_unique, "switch", switch)
    p_unique.switch()


REF_CASES = [(ref_quant, "TestQATPass", "test_insert_and_train"),
             (ref_quant, "TestQATPass", "test_quantized_close_to_fp"),
             (ref_quant, "TestPTQ", "test_calibrate_and_freeze"),
             (ref_int8, None, "test_int8_predictor_top1_parity"),
             (ref_int8, None, "test_weight_only_path"),
             (ref_int8, None, "test_weight_tied_param_stays_fp")]


@pytest.mark.parametrize("mod,cls,case", REF_CASES,
                         ids=[c for _, _, c in REF_CASES])
def test_reference_slim_cases_on_the_port(mod, cls, case,
                                          port_in_reference):
    fn = getattr(getattr(mod, cls)(), case) if cls else getattr(mod, case)
    fn(ptt.Scope())


# ---------------------------------------------------------------------------
# the lowerings, bit for bit
# ---------------------------------------------------------------------------

def _np(v):
    """A port scope value (a tensor, or the host step counter) as numpy."""
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _both(op, j_ins, attrs):
    """The reference's and the port's outputs of ``op`` on the same numpy
    inputs, as {slot: numpy}."""
    jout = getattr(jq, op)({k: [None if v is None else np.asarray(v)]
                            for k, v in j_ins.items()}, attrs)
    pout = getattr(pq, op)({k: [None if v is None else
                                torch.from_numpy(np.array(v))]
                            for k, v in j_ins.items()}, attrs)
    return ({k: np.asarray(v) for k, v in jout.items()},
            {k: v.numpy() for k, v in pout.items()})


QDQ_CASES = [("fake_qdq_abs_max", {"bit_length": 8}),
             ("fake_qdq_abs_max", {"bit_length": 4}),
             ("fake_qdq_channel", {"quant_axis": 0}),
             ("fake_qdq_channel", {"quant_axis": 1, "bit_length": 8}),
             ("fake_qdq_moving_avg", {"is_test": False, "moving_rate": 0.9}),
             ("fake_qdq_moving_avg", {"is_test": True})]


@pytest.mark.parametrize("op,attrs", QDQ_CASES,
                         ids=[f"{o}-{i}" for i, (o, _) in
                              enumerate(QDQ_CASES)])
def test_fake_qdq_lowerings_bitwise(op, attrs):
    rng = np.random.RandomState(3)
    ins = {"X": (rng.randn(6, 10) * 2.5).astype(np.float32)}
    if op == "fake_qdq_moving_avg":
        ins.update(InScale=np.float32([0.7]), InState=np.float32([2.0]),
                   InAccum=np.float32([3.1]))
    jout, pout = _both(op, ins, attrs)
    assert set(jout) == set(pout)
    for k in jout:
        assert pout[k].dtype == jout[k].dtype and \
            pout[k].tobytes() == jout[k].tobytes(), k


def test_dequantize_weight_bitwise():
    rng = np.random.RandomState(4)
    ins = {"X": rng.randint(-127, 128, (8, 3, 2, 2)).astype(np.int8),
           "Scale": (rng.rand(8) * 0.02).astype(np.float32)}
    jout, pout = _both("dequantize_weight", ins, {"axis": 0})
    assert pout["Out"].tobytes() == jout["Out"].tobytes()


# (x shape, N): BERT-tiny's 3-D projections, a pooler-like M = 3 and a
# 2-wide classifier (the shapes torch._int_mm pads on the card)
STATIC_SHAPES = [((2, 16, 32), 64), ((3, 32), 32), ((3, 32), 2),
                 ((5, 24), 8)]


@pytest.mark.parametrize("shape,n", STATIC_SHAPES,
                         ids=[f"{s}x{n}" for s, n in STATIC_SHAPES])
@pytest.mark.parametrize("act_scale", [0.37, 4.0, 100.0])
def test_static_int8_matmul_bitwise(shape, n, act_scale):
    """clip(round(x / sx)) to int8, the exact int32 product, * sx * sy:
    the port's CPU path equals the reference's bits, half-way values
    (rounded to even in both) included."""
    rng = np.random.RandomState(5)
    x = (rng.randn(*shape) * 2).astype(np.float32)
    sx = act_scale / 127.0
    x.reshape(-1)[:4] = np.float32([0.5, 1.5, -2.5, 126.5]) * np.float32(sx)
    ins = {"X": x, "Y": rng.randint(-127, 128, (shape[-1], n)).astype(
        np.int8), "YScale": (rng.rand(n) * 0.01).astype(np.float32)}
    jout, pout = _both("int8_matmul", ins, {"act_scale": act_scale})
    assert pout["Out"].shape == jout["Out"].shape
    assert pout["Out"].tobytes() == jout["Out"].tobytes()


def test_int8_matmul_shapes_on_meta():
    """The verifier's shape check runs lowerings on meta tensors: both
    modes infer [*, N] fp32 there."""
    x = torch.empty(4, 7, 32, device="meta")
    w = torch.empty(32, 6, dtype=torch.int8, device="meta")
    s = torch.empty(6, device="meta")
    for attrs in ({}, {"act_scale": 2.0}):
        out = pq.int8_matmul({"X": [x], "Y": [w], "YScale": [s]},
                             attrs)["Out"]
        assert out.shape == (4, 7, 6) and out.dtype == torch.float32
        assert out.device.type == "meta"


def test_static_int8_product_refuses_another_device():
    """No silent fallback: a device that is neither the card, the CPU nor
    meta raises."""
    xq = types.SimpleNamespace(device=types.SimpleNamespace(type="xla"))
    with pytest.raises(ValueError, match="unsupported device"):
        pq.static_int8_product(xq, torch.zeros(8, 2, dtype=torch.int8))


# ---------------------------------------------------------------------------
# programs and scopes against the reference
# ---------------------------------------------------------------------------

def _mlp(pkg, layers, data):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = data("x")
        label = layers.data("label", [1], dtype="int64", stop_gradient=True)
        h = layers.fc(x, 16, act="relu")
        logits = layers.fc(h, 4)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    return main, startup, logits, loss


def _both_mlps():
    """The test MLP built in both packages with fresh name generators, and
    the reference's startup weights."""
    j_unique.switch()
    p_unique.switch()
    jmain, jstart, jlogits, jloss = _mlp(
        pt, jl, lambda n: jl.data(n, [8], stop_gradient=True))
    pmain, _, plogits, ploss = _mlp(
        ptt, pl, lambda n: pl.data(n, [8], stop_gradient=True))
    jscope = pt.Scope()
    pt.Executor().run(jstart, scope=jscope, use_compiled=False)
    return (jmain, jlogits, jloss), (pmain, plogits, ploss), \
        _scope_arrays(jscope)


def _feed(n=16, seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(n, 8).astype(np.float32),
            "label": rng.randint(0, 4, (n, 1)).astype(np.int64)}


def test_qat_program_json_and_ste_gradients():
    """QuantizationTransformPass then SGD's minimize in both packages: the
    same program JSON (fake-quant ops, their state vars, the ``assign``
    straight-through grad ops); one step from the reference's weights
    gives the reference's gradients of both weights within 1e-6 and the
    same moving-average state."""
    (jmain, _, jloss), (pmain, _, ploss), arrays = _both_mlps()
    jpass, ppass = jslim.QuantizationTransformPass(), \
        pslim.QuantizationTransformPass()
    jpass.apply(jmain)
    ppass.apply(pmain)
    assert _json(pmain) == _json(jmain)
    with pt.program_guard(jmain):
        pt.optimizer.SGDOptimizer(0.1).minimize(jloss)
    with ptt.program_guard(pmain):
        optimizer.SGDOptimizer(0.1).minimize(ploss)
    assert _json(pmain) == _json(jmain)
    types_ = [op.type for op in pmain.global_block().ops]
    # two weights and the hidden activation (x is a feed, stop_gradient)
    assert types_.count("assign") == 3
    lr = [n for n, v in jmain.global_block().vars.items()
          if n.startswith("learning_rate") and v.persistable]
    arrays = dict(arrays, **{n: np.float32([0.1]) for n in lr})
    jscope = pt.Scope()
    for k, v in arrays.items():
        jscope.set(k, v)
    jpass.init_scale_state(jscope)
    pscope = scope_from_numpy(arrays, "cpu")
    ppass.init_scale_state(pscope)
    fetch = ["fc_0.w_0@GRAD", "fc_1.w_0@GRAD"] + ppass.scale_var_names
    feed = _feed()
    want = pt.Executor().run(jmain, feed=feed, fetch_list=fetch,
                             scope=jscope, use_compiled=False)
    got = ptt.Executor(device="cpu").run(pmain, feed=feed, fetch_list=fetch,
                                         scope=pscope, use_compiled=False)
    for name, g, w in zip(fetch, got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6,
                                   err_msg=name)


def test_ptq_program_scales_and_int8_scope_equal_the_reference():
    """PostTrainingQuantization over three batches in both packages from
    the reference's weights: the same calibrated scales (bit for bit),
    the same frozen program, the same int8 arrays and scales."""
    (jmain, _, _), (pmain, _, _), arrays = _both_mlps()
    batches = [_feed(8, s) for s in (1, 2, 3)]
    jscope = pt.Scope()
    for k, v in arrays.items():
        jscope.set(k, v)
    pscope = scope_from_numpy(arrays, "cpu")
    jptq = jslim.PostTrainingQuantization(pt.Executor(), jmain,
                                          ["x", "label"], jscope, batches)
    pptq = pslim.PostTrainingQuantization(ptt.Executor(device="cpu"), pmain,
                                          ["x", "label"], pscope, batches)
    jq_prog, pq_prog = jptq.quantize(), pptq.quantize()
    assert pptq.calibrated_scales == jptq.calibrated_scales
    assert all(s > 0 for s in pptq.calibrated_scales.values())
    assert _json(pq_prog) == _json(jq_prog)
    jpacks = jslim.quantize_weights_int8(jq_prog, jscope)
    ppacks = pslim.quantize_weights_int8(pq_prog, pscope)
    assert sorted(ppacks) == sorted(jpacks) == ["fc_0.w_0", "fc_1.w_0"]
    for name in jpacks:
        for key in ("int8", "scale"):
            a, b = ppacks[name][key], jpacks[name][key]
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), \
                (name, key)


def _bert_int8(mode):
    """BERT-tiny's pruned inference program and the reference's weights,
    converted in both packages with the reference's calibrated scales
    (static) or none (weight-only). Returns (jprog, jscope, pprog,
    pscope, act_scales)."""
    jprog, pprog, jscope0 = bert_tiny_inference()
    arrays = _scope_arrays(jscope0)
    act_scales = None
    if mode == "static":
        jcal = pt.Scope()
        for k, v in arrays.items():
            jcal.set(k, v)
        ptq = jslim.PostTrainingQuantization(
            pt.Executor(), jprog.clone(for_test=True), FEEDS, jcal,
            [bert_batch(3, s) for s in (1, 2)])
        ptq.quantize()
        act_scales = ptq.calibrated_scales
    jscope = pt.Scope()
    for k, v in arrays.items():
        jscope.set(k, np.copy(v))
    pscope = scope_from_numpy(arrays, "cpu")
    jslim.convert_to_int8_program(jprog, jscope, act_scales)
    pslim.convert_to_int8_program(pprog, pscope, act_scales)
    return jprog, jscope, pprog, pscope, act_scales


@pytest.mark.parametrize("mode", ["weight_only", "static"])
def test_bert_tiny_convert_json_and_int8_scope(mode):
    jprog, jscope, pprog, pscope, act_scales = _bert_int8(mode)
    assert _json(pprog) == _json(jprog)
    mm = [op for op in pprog.global_block().ops if op.type == "int8_matmul"]
    # 6 projections a layer (q, k, v, out, ffn in, ffn out), the pooler
    # and the NSP classifier
    assert len(mm) == 6 * 2 + 2
    assert all(bool(op.attrs.get("act_scale")) == (mode == "static")
               for op in mm)
    names = {n for n, _ in jscope.items()}
    assert names == {n for n, _ in pscope.items()}
    for n in names:
        want = np.asarray(jscope.find_var(n))
        got = _np(pscope.find_var(n))
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), n
    assert sum(n.endswith("@int8_scale") for n in names) == len(mm)


def test_calibrated_scales_bert_tiny_against_the_reference():
    """PTQ over BERT-tiny's activations in both packages: the same
    activations are calibrated; the port's scales are within 1e-6
    relative of the reference's (an activation past the embeddings comes
    from fp32 products whose last bits may differ between the packages)."""
    jprog, pprog, jscope0 = bert_tiny_inference()
    arrays = _scope_arrays(jscope0)
    batches = [bert_batch(3, s) for s in (1, 2)]
    jscope = pt.Scope()
    for k, v in arrays.items():
        jscope.set(k, v)
    jptq = jslim.PostTrainingQuantization(pt.Executor(), jprog, FEEDS,
                                          jscope, batches)
    pptq = pslim.PostTrainingQuantization(
        ptt.Executor(device="cpu"), pprog, FEEDS,
        scope_from_numpy(arrays, "cpu"), batches)
    jptq.quantize()
    pptq.quantize()
    assert list(pptq.calibrated_scales) == list(jptq.calibrated_scales)
    for n, s in jptq.calibrated_scales.items():
        assert abs(pptq.calibrated_scales[n] - s) <= 1e-6 * s, n


@pytest.mark.parametrize("mode,tol", [("weight_only", 1e-5),
                                      ("static", 1e-4)])
def test_bert_tiny_int8_predictor_against_the_reference(mode, tol,
                                                        tmp_path):
    """The converted BERT-tiny saved by the port, loaded by
    ``create_predictor`` (the seven passes, each verified) against the
    reference's predictor over the same converted program and scope: the
    same pass JSON, logits within ``tol``, the same argmax; the int8
    weights load as int8."""
    jprog, jscope, pprog, pscope, _ = _bert_int8(mode)
    path = str(tmp_path / "int8")
    pio.save_inference_model(path, FEEDS, [NSP], main_program=pprog,
                             scope=pscope)
    pred = ppred.create_predictor(ppred.AnalysisConfig(path, device="cpu"))
    ref = JPredictor(JConfig(), program=jprog, feed_names=FEEDS,
                     fetch_names=[NSP], scope=jscope)
    assert _json(pred.program) == _json(ref.program)
    # no pass fused across an int8_matmul: every one is there, reading
    # its int8 weight and scale
    mm = [op for op in pred.program.global_block().ops
          if op.type == "int8_matmul"]
    assert len(mm) == 14
    assert all(op.inputs["YScale"] == [op.inputs["Y"][0] + "@int8_scale"]
               for op in mm)
    for n in (n for n, _ in pscope.items() if n.endswith("@int8_scale")):
        base = n[:-len("@int8_scale")]
        assert pred._params[base].dtype == torch.int8, base
    batch = bert_batch(3, 7)
    got, = pred.run(batch)
    want, = ref.run(batch)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)
    assert (got.argmax(1) == np.asarray(want).argmax(1)).all()


def test_int8_dirs_keep_int8_weights_across_packages(tmp_path):
    """An int8 dir saved by either package loads into the port with each
    ``@int8_scale``'s weight int8 and every array bit for bit."""
    jprog, jscope, pprog, pscope, _ = _bert_int8("weight_only")
    from paddle_tpu import io as jio

    for who, save in (("reference", lambda p: jio.save_inference_model(
            p, FEEDS, [NSP], main_program=jprog, scope=jscope)),
                      ("port", lambda p: pio.save_inference_model(
                          p, FEEDS, [NSP], main_program=pprog,
                          scope=pscope))):
        path = str(tmp_path / who)
        save(path)
        scope = ptt.Scope()
        prog, feeds, fetches = pio.load_inference_model(path, scope=scope)
        assert (feeds, fetches) == (FEEDS, [NSP])
        assert _json(prog) == _json(pprog)
        for n, v in scope.items():
            want = np.asarray(jscope.find_var(n))
            assert _np(v).dtype == want.dtype and \
                _np(v).tobytes() == want.tobytes(), (who, n)


def test_scope_from_numpy_carries_an_int8_scope():
    """The converter that carries the reference's state into the port
    keeps an int8 scope as the reference's convert leaves it: int8
    arrays int8, ``@int8_scale`` vectors fp32, bit for bit."""
    _, jscope, _, _, _ = _bert_int8("static")
    arrays = _scope_arrays(jscope)
    scope = scope_from_numpy(arrays, "cpu")
    int8 = [n for n, a in arrays.items() if a.dtype == np.int8]
    assert len(int8) == 14
    for n, a in arrays.items():
        t = _np(scope.find_var(n))
        assert t.dtype == a.dtype and t.tobytes() == a.tobytes(), n
