"""The training slice's op lowerings, grads, IR transform, initializers and
executor of paddle_tpu_torch, held against paddle_tpu.

* Each forward lowering the pre-training program adds runs through its JAX
  lowering and its torch lowering on the same numpy inputs (made from a
  seed), and so does its ``__vjp_grad__``: the grad op is built by each
  package's ``default_grad_maker`` from the same OpDesc and run on the same
  inputs and cotangents. fp32, ``rtol = atol = 1e-5`` (the two frameworks
  sum in different orders); integer outputs and masks bitwise.
* ``append_backward`` + ``minimize`` is a pure IR transform: a program with
  fan-out, a stop_gradient branch and a shared parameter serialises to the
  same JSON after ``minimize`` in both packages.
* Initializers: shape, dtype, exact constants; mean, std and the two-sigma
  bound of the truncated normal.
* ``Executor``: feeds cast as declared (64-bit to 32), persistables written
  back, the step counter, last-use freeing, and the device rule.
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu import layers as jlayers
from paddle_tpu.core import registry as jax_registry
from paddle_tpu.core import unique_name as jax_names
from paddle_tpu.core.ir import OpDesc as JOpDesc

import paddle_tpu_torch as ptt
from paddle_tpu_torch import layers as players
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.core import unique_name as pt_names
from paddle_tpu_torch.core.executor import (STEP_COUNTER, Executor,
                                            _last_readers)
from paddle_tpu_torch.core.ir import OpDesc as POpDesc
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.initializer import (Constant, Normal, TruncatedNormal,
                                          Uniform, Xavier)
from paddle_tpu_torch.param_attr import ParamAttr

torch.set_num_threads(2)

RTOL = ATOL = 1e-5


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _ce_inputs(rng, ignore=False):
    logits = _rand(rng, 4, 6, 50) * 3
    label = rng.randint(0, 50, (4, 6, 1)).astype(np.int32)
    if ignore:
        label[0, 0, 0] = -100
    return {"Logits": logits, "Label": label}, {
        "soft_label": False, "ignore_index": -100, "axis": -1}


def _topk_inputs(rng):
    # 0/1 weights: ties decide which positions are gathered
    w = (rng.rand(5, 40) < 0.3).astype(np.float32)
    return {"X": w}, {"k": 8}


# case -> (inputs, attrs[, slots whose cotangent is fed to the grad op])
OP_CASES = {
    "lookup_table_v2": lambda r: ({"W": _rand(r, 30, 8),
                                   "Ids": r.randint(0, 30, (4, 6))
                                   .astype(np.int32)},
                                  {"padding_idx": -1, "is_sparse": False}),
    "lookup_table_v2[pad]": lambda r: ({"W": _rand(r, 30, 8),
                                        "Ids": r.randint(0, 4, (4, 6))
                                        .astype(np.int32)},
                                       {"padding_idx": 2}),
    "mul": lambda r: ({"X": _rand(r, 4, 16), "Y": _rand(r, 16, 3)},
                      {"x_num_col_dims": 1, "y_num_col_dims": 1}),
    "mul[3d]": lambda r: ({"X": _rand(r, 2, 3, 8), "Y": _rand(r, 8, 5)},
                          {"x_num_col_dims": 2, "y_num_col_dims": 1}),
    "dropout": lambda r: ({"X": _rand(r, 4, 16, 32)},
                          {"dropout_prob": 0.1, "is_test": False, "seed": 11,
                           "dropout_implementation": "upscale_in_train",
                           "__step__": np.int32(3)}),
    "dropout[test]": lambda r: ({"X": _rand(r, 4, 16)},
                                {"dropout_prob": 0.1, "is_test": True,
                                 "seed": 11, "dropout_implementation":
                                 "downgrade_in_infer"}),
    "gelu": lambda r: ({"X": _rand(r, 5, 33) * 2}, {"approximate": False}),
    "gelu[tanh]": lambda r: ({"X": _rand(r, 5, 33) * 2},
                             {"approximate": True}),
    "tanh": lambda r: ({"X": _rand(r, 5, 33)}, {}),
    "squeeze2": lambda r: ({"X": _rand(r, 4, 6, 1)}, {"axes": [2]}),
    "reshape2": lambda r: ({"X": _rand(r, 4, 1, 16)}, {"shape": [0, 16]}),
    "take_along_axis": lambda r: ({"Input": _rand(r, 4, 20, 8),
                                   "Index": r.randint(0, 20, (4, 5, 1))
                                   .astype(np.int32)}, {"Axis": 1}),
    "take_along_axis[2d]": lambda r: ({"Input": r.randint(0, 99, (4, 20))
                                       .astype(np.int32),
                                       "Index": r.randint(0, 20, (4, 5))
                                       .astype(np.int32)}, {"Axis": 1}),
    "top_k": _topk_inputs,
    "softmax_with_cross_entropy": _ce_inputs,
    "softmax_with_cross_entropy[ignore]": lambda r: _ce_inputs(r, True),
    "softmax_with_cross_entropy[2d]": lambda r: (
        {"Logits": _rand(r, 6, 2), "Label": r.randint(0, 2, (6, 1))
         .astype(np.int32)}, {"soft_label": False, "ignore_index": -100,
                              "axis": -1}),
    "mean": lambda r: ({"X": _rand(r, 6, 1)}, {}),
    "elementwise_mul": lambda r: ({"X": _rand(r, 4, 6), "Y": _rand(r, 4, 6)},
                                  {"axis": -1}),
    "elementwise_div": lambda r: ({"X": _rand(r, 1), "Y": r.rand(1)
                                   .astype(np.float32) + 1.0}, {"axis": -1}),
    "elementwise_add[axis]": lambda r: ({"X": _rand(r, 6, 2),
                                         "Y": _rand(r, 2)}, {"axis": 1}),
    "matmul[tied]": lambda r: ({"X": _rand(r, 4, 5, 16),
                                "Y": _rand(r, 30, 16)},
                               {"transpose_X": False, "transpose_Y": True,
                                "alpha": 1.0}),
    "matmul_v2": lambda r: ({"X": _rand(r, 2, 5, 16), "Y": _rand(r, 16, 12)},
                            {}),
    "layer_norm": lambda r: ({"X": _rand(r, 3, 7, 32) * 3 + 1,
                              "Scale": _rand(r, 32), "Bias": _rand(r, 32)},
                             {"epsilon": 1e-5, "begin_norm_axis": 2}),
    "scale": lambda r: ({"X": _rand(r, 3, 6)},
                        {"scale": 10000.0, "bias": -1.0,
                         "bias_after_scale": False}),
    "reduce_sum": lambda r: ({"X": _rand(r, 4, 8)},
                             {"dim": None, "keep_dim": False,
                              "reduce_all": True}),
    "slice": lambda r: ({"Input": _rand(r, 4, 12, 6)},
                        {"axes": [1], "starts": [0], "ends": [1]}),
    "unsqueeze2": lambda r: ({"X": _rand(r, 2, 7)}, {"axes": [1, 2]}),
    "fill_constant": lambda r: ({}, {"shape": [3, 2], "value": 1e-5,
                                     "dtype": "float32"}),
    "sum": lambda r: ({"X": [_rand(r, 4, 6), _rand(r, 4, 6),
                             _rand(r, 4, 6)]}, {}),
}


def _as_lists(ins_np, conv):
    return {k: [conv(x) for x in (v if isinstance(v, list) else [v])]
            for k, v in ins_np.items()}


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _compare(tag, got, want):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape, tag
    assert got.dtype == want.dtype, tag
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=tag)
    else:
        assert np.array_equal(got, want), tag


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_forward_lowering_matches_reference(case):
    op_type = case.split("[")[0]
    rng = np.random.RandomState(sum(map(ord, case)))
    ins_np, attrs = OP_CASES[case](rng)
    want = jax_registry.normalize_outputs(jax_registry.get(op_type).forward(
        _as_lists(ins_np, lambda x: x), dict(attrs)))
    got = pt_registry.normalize_outputs(pt_registry.get(op_type).forward(
        _as_lists(ins_np, _t), dict(attrs)))
    assert set(got) == set(want)
    for slot, vals in want.items():
        for i, w in enumerate(vals):
            _compare(f"{case}:{slot}[{i}]", got[slot][i], w)


GRAD_CASES = sorted(c for c in OP_CASES
                    if c.split("[")[0] not in ("top_k", "fill_constant")
                    and c != "take_along_axis[2d]")


@pytest.mark.parametrize("case", GRAD_CASES)
def test_vjp_grad_matches_reference(case):
    """Both packages build the grad op of the same forward OpDesc with
    their default grad maker; the two descs are equal, and so are the
    gradients their ``__vjp_grad__`` lowerings return."""
    op_type = case.split("[")[0]
    rng = np.random.RandomState(sum(map(ord, case)) + 1)
    ins_np, attrs = OP_CASES[case](rng)
    step = attrs.pop("__step__", None)
    ins_l = _as_lists(ins_np, lambda x: x)
    outs = jax_registry.normalize_outputs(
        jax_registry.get(op_type).forward(
            ins_l, dict(attrs, **({"__step__": step} if step is not None
                                  else {}))))
    in_names = {s: [f"{s}_{i}" for i in range(len(v))]
                for s, v in ins_l.items()}
    out_names = {s: [f"{s}_{i}" for i in range(len(v))]
                 for s, v in outs.items()}
    # cotangents for the floating outputs that a loss would reach
    skip = {"XShape", "Mask", "Mean", "Variance", "Softmax"}
    out_grads = {s: [f"{n}@GRAD" if s not in skip and np.issubdtype(
        np.asarray(outs[s][i]).dtype, np.floating) else None
        for i, n in enumerate(names)] for s, names in out_names.items()}
    in_grads = {}
    for s, names in in_names.items():
        nd = jax_registry.get(op_type).non_diff_inputs
        in_grads[s] = [f"{n}@GRAD" if s not in nd and np.issubdtype(
            np.asarray(ins_l[s][i]).dtype, np.floating) else None
            for i, n in enumerate(names)]
    jop = JOpDesc(op_type, in_names, out_names, attrs)
    pop = POpDesc(op_type, in_names, out_names, attrs)
    (jg,) = jax_registry.default_grad_maker(jop, out_grads, in_grads)
    (pg,) = pt_registry.default_grad_maker(pop, out_grads, in_grads)
    assert json.dumps(pg.to_dict(), sort_keys=True) == \
        json.dumps(jg.to_dict(), sort_keys=True)
    assert pt_registry.get(op_type).non_diff_inputs == \
        jax_registry.get(op_type).non_diff_inputs

    env = {}
    for s, names in in_names.items():
        env.update(zip(names, ins_l[s]))
    for s, names in out_names.items():
        for i, n in enumerate(names):
            if out_grads[s][i] is not None:
                env[n + "@GRAD"] = np.asarray(
                    rng.randn(*np.shape(outs[s][i])), np.float32)

    def gather(conv):
        return {slot: [None if n == "@EMPTY@" else conv(env[n])
                       for n in names] for slot, names in jg.inputs.items()}

    g_attrs = dict(jg.attrs)
    if step is not None:
        g_attrs["__step__"] = step
    want = jax_registry.normalize_outputs(
        jax_registry.get("__vjp_grad__").forward(gather(lambda x: x),
                                                 dict(g_attrs)))
    got = pt_registry.normalize_outputs(
        pt_registry.get("__vjp_grad__").forward(gather(_t), dict(g_attrs)))
    checked = 0
    for slot, names in jg.outputs.items():
        for i, n in enumerate(names):
            if n == "@EMPTY@":
                continue
            _compare(f"{case}:{slot}[{i}]", got[slot][i], want[slot][i])
            checked += 1
    assert checked


def test_vjp_grad_leaves_no_graph_and_does_not_touch_its_inputs():
    x = torch.randn(4, 8)
    before = x.clone()
    op = POpDesc("gelu", {"X": ["x"]}, {"Out": ["y"]}, {"approximate": True})
    (g,) = pt_registry.default_grad_maker(op, {"Out": ["y@GRAD"]},
                                          {"X": ["x@GRAD"]})
    out = pt_registry.get("__vjp_grad__").forward(
        {"In__X": [x], "OG__Out": [torch.ones(4, 8)]}, dict(g.attrs))
    dx = out["IG__X"][0]
    assert not dx.requires_grad and not x.requires_grad
    assert torch.equal(x, before)


# ---------------------------------------------------------------------------
# optimizer ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op_type", ["adam", "adamw"])
def test_optimizer_op_matches_reference_and_updates_in_place(op_type):
    rng = np.random.RandomState(5)
    ins = {"Param": _rand(rng, 33, 7), "Grad": _rand(rng, 33, 7) * 0.1,
           "LearningRate": np.array([1e-2], np.float32),
           "Moment1": _rand(rng, 33, 7) * 0.01,
           "Moment2": rng.rand(33, 7).astype(np.float32) * 1e-3,
           "Beta1Pow": np.array([0.9 ** 4], np.float32),
           "Beta2Pow": np.array([0.999 ** 4], np.float32)}
    attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
             "lazy_mode": False}
    if op_type == "adamw":
        attrs.update(coeff=0.01, with_decay=True)
    want = jax_registry.get(op_type).forward(_as_lists(ins, lambda x: x),
                                             dict(attrs))
    tins = _as_lists(ins, _t)
    got = pt_registry.get(op_type).forward(tins, dict(attrs))
    for slot, w in want.items():
        np.testing.assert_allclose(got[slot].numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-6, err_msg=slot)
    for slot in ("Param", "Moment1", "Moment2", "Beta1Pow", "Beta2Pow"):
        assert got[slot + "Out"] is tins[slot][0]
    with pytest.raises(NotImplementedError):
        pt_registry.get(op_type).forward(_as_lists(ins, _t),
                                         dict(attrs, lazy_mode=True))


# ---------------------------------------------------------------------------
# append_backward / minimize as an IR transform
# ---------------------------------------------------------------------------

def _build_mlp(pkg, layers, names, opt_cls):
    main, startup = pkg.Program(), pkg.Program()
    with names.guard(), pkg.program_guard(main, startup):
        x = layers.static_data("x", [-1, 16])
        label = layers.static_data("label", [-1, 1], dtype="int64")
        h = layers.fc(x, 32, act="tanh")
        h = layers.dropout(h, 0.2, dropout_implementation="upscale_in_train")
        frozen = layers.scale(h, scale=2.0)
        frozen.stop_gradient = True
        h2 = layers.fc(h, 32, act="relu") + h + frozen     # fan-out of h
        logits = layers.fc(h2, 4)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        loss = loss * 0.5 + layers.reduce_sum(h2) / 100.0
        opt_cls(0.01).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("opt", ["AdamOptimizer", "AdamWOptimizer"])
def test_minimize_builds_the_reference_program(opt):
    jmain, jstart, _ = _build_mlp(pt, jlayers, jax_names,
                                  getattr(pt.optimizer, opt))
    pmain, pstart, _ = _build_mlp(ptt, players, pt_names, getattr(popt, opt))
    for j, p in ((jmain, pmain), (jstart, pstart)):
        jd = json.loads(json.dumps(j.to_dict()))
        pd = json.loads(json.dumps(p.to_dict()))
        assert [o["type"] for o in pd["blocks"][0]["ops"]] == \
            [o["type"] for o in jd["blocks"][0]["ops"]]
        assert pd == jd
    types = [o.type for o in pmain.global_block().ops]
    assert "sum" in types and "__vjp_grad__" in types
    assert pmain.grad_var_map == jmain.grad_var_map


def test_gradients_of_inputs_builds_the_reference_program():
    """``gradients(targets, inputs)``: grads with respect to a fed var,
    which is a leaf outside the parameter set."""
    from paddle_tpu.core.backward import gradients as jgradients

    from paddle_tpu_torch.core.backward import gradients as pgradients

    descs, names_out = [], []
    for pkg, layers, names, grads in ((pt, jlayers, jax_names, jgradients),
                                      (ptt, players, pt_names, pgradients)):
        main = pkg.Program()
        with names.guard(), pkg.program_guard(main, pkg.Program()):
            x = layers.static_data("x", [-1, 8])
            x.stop_gradient = False
            y = layers.tanh(layers.fc(x, 4))
            z = y * y + y
            (gx,) = grads([z], [x])
        descs.append(json.loads(json.dumps(main.to_dict())))
        names_out.append(gx.name)
    assert descs[0] == descs[1] and names_out[0] == names_out[1] == "x@GRAD"


def test_mlp_trains_like_the_reference():
    """The same program and state in both packages: 5 steps give the same
    losses (fp32, 1e-5: the dropout masks are the same bits)."""
    jmain, jstart, jloss = _build_mlp(pt, jlayers, jax_names,
                                      pt.optimizer.AdamWOptimizer)
    pmain, _, ploss = _build_mlp(ptt, players, pt_names, popt.AdamWOptimizer)
    jscope = pt.Scope()
    jexe = pt.Executor(pt.CPUPlace())
    jexe.run(jstart, scope=jscope, use_compiled=False)
    from paddle_tpu_torch.models.bert import scope_from_numpy

    pscope = scope_from_numpy({n: np.asarray(v) for n, v in jscope.items()},
                              "cpu")
    rng = np.random.RandomState(0)
    feed = {"x": _rand(rng, 8, 16), "label": rng.randint(0, 4, (8, 1))}
    pexe = Executor(device="cpu")
    for _ in range(5):
        (want,) = jexe.run(jmain, feed=feed, fetch_list=[jloss],
                           scope=jscope, use_compiled=False)
        (got,) = pexe.run(pmain, feed=feed, fetch_list=[ploss], scope=pscope)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    assert int(pscope.find_var(STEP_COUNTER)) == 6   # startup + 5 steps


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def _init_once(init, shape, dtype="float32"):
    prog = ptt.Program()
    blk = prog.global_block()
    var = blk.create_parameter("w", shape, dtype)
    init(var, blk)
    scope = Scope()
    Executor(device="cpu").run(prog, scope=scope)
    return blk.ops[0], scope.find_var("w")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_constant_initializer_is_exact(dtype):
    op, w = _init_once(Constant(0.02), [5, 3], dtype)
    assert op.type == "fill_constant" and op.attrs["dtype"] == dtype
    assert tuple(w.shape) == (5, 3)
    assert w.dtype == (torch.float32 if dtype == "float32"
                       else torch.bfloat16)
    assert torch.equal(w, torch.full((5, 3), 0.02, dtype=w.dtype))


def test_truncated_normal_initializer_distribution():
    op, w = _init_once(TruncatedNormal(0.0, 0.02), [400, 256])
    assert op.type == "truncated_gaussian_random" and op.attrs["seed"] == 1
    assert tuple(w.shape) == (400, 256) and w.dtype == torch.float32
    assert float(w.abs().max()) <= 0.04 + 1e-7       # two sigma
    assert abs(float(w.mean())) < 5e-4
    # std of a unit normal truncated at 2 sigma is 0.8796
    assert abs(float(w.std()) / 0.02 - 0.8796) < 0.01
    _, again = _init_once(TruncatedNormal(0.0, 0.02), [400, 256])
    assert torch.equal(w, again)                     # the seed decides
    _, other = _init_once(TruncatedNormal(0.0, 0.02, seed=9), [400, 256])
    assert not torch.equal(w, other)


def test_normal_uniform_and_xavier_initializers():
    op, w = _init_once(Normal(1.0, 0.5), [300, 300])
    assert op.type == "gaussian_random"
    assert abs(float(w.mean()) - 1.0) < 0.01
    assert abs(float(w.std()) - 0.5) < 0.01
    op, w = _init_once(Uniform(-0.3, 0.1), [300, 300])
    assert op.type == "uniform_random"
    assert float(w.min()) >= -0.3 and float(w.max()) <= 0.1
    assert abs(float(w.mean()) + 0.1) < 0.005
    op, w = _init_once(Xavier(), [64, 192])
    limit = (6.0 / (64 + 192)) ** 0.5
    assert op.type == "uniform_random"
    assert abs(op.attrs["max"] - limit) < 1e-12
    assert float(w.abs().max()) <= limit


def test_initializers_build_the_reference_startup_ops():
    from paddle_tpu import initializer as jinit

    for name, args in (("Constant", (0.5,)), ("Normal", (0.0, 0.02)),
                       ("Uniform", (-1.0, 1.0)),
                       ("TruncatedNormal", (0.0, 0.02)), ("Xavier", ())):
        descs = []
        for pkg, mod in ((pt, jinit), (ptt, ptt.initializer)):
            prog = pkg.Program()
            blk = prog.global_block()
            getattr(mod, name)(*args)(
                blk.create_parameter("w", [8, 4], "float32"), blk)
            descs.append(json.dumps(prog.to_dict(), sort_keys=True))
        assert descs[0] == descs[1], name


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------

def test_executor_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        assert Executor().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Executor()
    assert Executor(device="cpu").device.type == "cpu"


def test_executor_casts_feeds_and_threads_state():
    main, startup = ptt.Program(), ptt.Program()
    with pt_names.guard(), ptt.program_guard(main, startup):
        ids = players.static_data("ids", [-1, 3], dtype="int64")
        emb = players.embedding(ids, [10, 4],
                                param_attr=ParamAttr(name="table"))
        total = players.reduce_sum(emb)
        counter = players.create_global_var([1], 0.0, "float32",
                                            persistable=True, name="runs")
        main.global_block().append_op(
            "scale", {"X": [counter]}, {"Out": [counter]},
            {"scale": 1.0, "bias": 1.0, "bias_after_scale": True})
    scope = Scope()
    exe = Executor(device="cpu")
    exe.run(startup, scope=scope)
    feed = {"ids": np.array([[1, 2, 3], [3, 3, 9]], np.int64)}
    out1 = exe.run(main, feed=feed, fetch_list=[total, emb], scope=scope)
    out2 = exe.run(main, feed=feed, fetch_list=["runs"], scope=scope,
                   return_numpy=False, use_compiled=True)
    assert isinstance(out1[0], np.ndarray) and out1[1].shape == (2, 3, 4)
    table = scope.find_var("table")
    np.testing.assert_allclose(out1[0], table[[1, 2, 3, 3, 3, 9]].sum(),
                               rtol=1e-6)
    assert isinstance(out2[0], torch.Tensor) and float(out2[0]) == 2.0
    assert int(scope.find_var(STEP_COUNTER)) == 3      # startup + 2 runs
    assert "ids" not in scope and emb.name not in scope
    with pytest.raises(Exception, match="was not produced"):
        exe.run(main, feed=feed, fetch_list=["nope"], scope=scope)


def test_last_use_freeing_drops_each_temporary_after_its_last_reader():
    main = ptt.Program()
    with pt_names.guard(), ptt.program_guard(main, ptt.Program()):
        x = players.static_data("x", [-1, 13])
        a = players.tanh(x)
        b = players.relu(a)
        c = a + b
        d = players.reduce_sum(c)
    blk = main.global_block()
    dead = _last_readers(blk, keep={d.name})
    assert [o.type for o in blk.ops] == ["tanh", "relu", "elementwise_add",
                                         "reduce_sum"]
    assert dead == [[x.name], [], [a.name, b.name], [c.name]]
    # and the run holds what the bookkeeping says
    seen = {}
    orig = pt_registry.get("reduce_sum").forward

    def spy(ins, attrs):
        import gc

        gc.collect()
        seen["live"] = sum(1 for o in gc.get_objects()
                           if isinstance(o, torch.Tensor)
                           and o.shape == (5, 13))
        return orig(ins, attrs)

    pt_registry.get("reduce_sum").forward = spy
    try:
        Executor(device="cpu").run(main, feed={"x": np.ones((5, 13),
                                                            np.float32)},
                                   fetch_list=[d], scope=Scope())
    finally:
        pt_registry.get("reduce_sum").forward = orig
    assert seen["live"] == 1          # only c is alive when d is computed
