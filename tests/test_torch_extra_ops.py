"""The reference's ``ops/extra_ops.py`` op types that came with the
linalg_ops slice, the layer functions over both modules, the programs
of the slice's card legs, and the six ``static.nn`` names they unblock,
in paddle_tpu_torch against paddle_tpu on the CPU.

* Per op: every glue case of the 30 op types (``tools/glue_cases.py``:
  the unary table at edge values and over its sweep range, atan2's signed
  zeros, ties at put_along_axis's repeated positions, out-of-range and
  negative indices, zero rows for cos_sim and norm, bf16 inputs, the
  AUC's NaN and out-of-range predictions) through both lowerings, with
  ``test_torch_linalg_ops``' tolerances; their gradients through the
  port's ``__vjp_grad__`` against ``jax.vjp``. ``nll_loss`` refuses what
  the reference's lowering silently drops (ROADMAP queue C).
* Layers: the generated table's new rows, ``rank``, ``cos_sim`` and
  ``auc`` exist with the reference's parameters; a program of them has
  the reference's JSON.
* Programs: each card leg (``tools/linalg_extra_cases.py``) at a small
  width has the reference's JSON, runs from the same numpy state to the
  reference's outputs, and its compiled step equals op by op bit for
  bit; the streamed AUC's stat vars equal the reference's bit for bit and
  its value the port's ``metric.Auc``.
* Interchange: a reference program holding all 64 op types, loaded
  through its JSON, runs in the port to the reference's outputs.
* ``static.nn``: conv2d_transpose, instance_norm, prelu, group_norm,
  case and switch_case build the reference's program and run to its
  outputs."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.ops  # noqa: F401
from paddle_tpu import layers as jl
from paddle_tpu.core import unique_name as jax_names
from paddle_tpu.core.ir import Block as JBlock
from paddle_tpu.layers import generated as jgen

from paddle_tpu_torch import layers as pl
from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.core import telemetry
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.ir import Program as PProgram
from paddle_tpu_torch.core.scope import Scope, scope_from_numpy
from paddle_tpu_torch.metric import Auc
from paddle_tpu_torch.tools import linalg_extra_cases as lec
from paddle_tpu_torch.tools.control_flow_cases import Pkg, build, port
from paddle_tpu_torch.tools.glue_cases import (BF16, CASES, EXTRA_OPS,
                                               LINALG_EXTRA_OPS)
from paddle_tpu_torch.tools.glue_cases import rng as _rng
from tests.test_torch_linalg_ops import (check_op, run_port, vjp_both,
                                         _u)

torch.set_num_threads(2)

JAX = Pkg(pt, pt.layers, pt.initializer, pt.optimizer, pt.ParamAttr,
          jax_names)
PORT = port()
TOL = 1e-5


def test_every_extra_op_has_a_case():
    covered = {c.split("[")[0] for c in CASES}
    assert set(EXTRA_OPS) <= covered


EXTRA_CASES = sorted(c for c in CASES if c.split("[")[0] in EXTRA_OPS)


@pytest.mark.parametrize("case", EXTRA_CASES)
def test_extra_op_matches_the_reference(case):
    op = case.split("[")[0]
    ins, attrs = CASES[case](_rng(case))
    check_op(op, ins, attrs, case)


# -- the rows where a plain torch call is wrong --------------------------------

def test_put_along_axis_assign_keeps_the_last_and_drops_past_the_axis():
    x = np.zeros(4, np.float32)
    v = np.array([5, 6, 7], np.float32)
    got = run_port("put_along_axis", {
        "Input": [x], "Index": [np.array([1, 1, 1], np.int32)],
        "Value": [v]}, {"Axis": 0})["Result"][0]
    assert got.tolist() == [0, 7, 0, 0]
    got = run_port("put_along_axis", {
        "Input": [x], "Index": [np.array([1, 5, -1], np.int32)],
        "Value": [v]}, {"Axis": 0})["Result"][0]
    assert got.tolist() == [0, 5, 0, 7]
    with pytest.raises(RuntimeError):
        torch.zeros(4).scatter_(0, torch.tensor([1, 5, -1]),
                                torch.from_numpy(v))


def test_put_along_axis_add_sums_repeats():
    got = run_port("put_along_axis", {
        "Input": [np.ones(3, np.float32)],
        "Index": [np.array([2, 2, 0, 9], np.int32)],
        "Value": [np.array([1, 2, 3, 4], np.float32)]},
        {"Axis": 0, "Reduce": "add"})["Result"][0]
    assert got.tolist() == [4, 1, 4]


def test_nll_loss_refuses_what_the_reference_drops():
    """The reference's lowering ignores a Weight input and
    ``ignore_index`` (``extra_ops.py:366-383``), either of which changes
    the result; the port raises, as for ``cross_entropy`` (ROADMAP queue
    C). At the defaults it computes the reference's loss."""
    x = _u(np.random.RandomState(0), (4, 3), -3, 0)
    label = np.array([0, 2, 1, 1], np.int32)
    with pytest.raises(NotImplementedError, match="Weight"):
        run_port("nll_loss", {"X": [x], "Label": [label],
                              "Weight": [np.ones(3, np.float32)]}, {})
    with pytest.raises(NotImplementedError, match="ignore_index"):
        run_port("nll_loss", {"X": [x], "Label": [label]},
                 {"ignore_index": 1})
    check_op("nll_loss", {"X": [x], "Label": [label]},
             {"ignore_index": -100})


# -- gradients -----------------------------------------------------------------

UNARY_RANGE = {"asin": (-0.9, 0.9), "acos": (-0.9, 0.9), "atan": (-3, 3),
               "sinh": (-2, 2), "cosh": (-2, 2), "tan": (-1, 1),
               "expm1": (-2, 2), "log1p": (-0.5, 2), "log10": (0.2, 3),
               "trunc": (-3, 3), "atanh": (-0.9, 0.9), "asinh": (-3, 3),
               "acosh": (1.1, 3), "mish": (-3, 3), "celu": (-3, 3),
               "stanh": (-3, 3)}
GRAD_CASES = {op: (lambda r, lo=lo, hi=hi: ({"X": [_u(r, (3, 4), lo, hi)]},
                                            {}))
              for op, (lo, hi) in UNARY_RANGE.items()}
GRAD_CASES.update({
    "mish[zero_and_large]": lambda r: (
        {"X": [np.array([0.0, -0.0, 25.0, -30.0], np.float32)]}, {}),
    "celu[alpha]": lambda r: ({"X": [_u(r, (3, 4), -3, 3)]},
                              {"alpha": 0.5}),
    "atan2": lambda r: ({"X1": [_u(r, (3, 4))], "X2": [_u(r, (3, 4))]}, {}),
    "kron": lambda r: ({"X": [_u(r, (2, 3))], "Y": [_u(r, (3, 2))]}, {}),
    "index_sample": lambda r: (
        {"X": [_u(r, (3, 4))],
         "Index": [np.array([[0, 3], [-1, 9], [2, 2]], np.int32)]}, {}),
    "put_along_axis[assign]": lambda r: (
        {"Input": [_u(r, (3, 4))],
         "Index": [np.array([[1, 1], [0, 5], [-1, 2]], np.int32)],
         "Value": [_u(r, (3, 2))]}, {"Axis": 1}),
    "put_along_axis[add]": lambda r: (
        {"Input": [_u(r, (3, 4))],
         "Index": [np.array([[1, 1], [0, 5], [-1, 2]], np.int32)],
         "Value": [_u(r, (3, 2))]}, {"Axis": 1, "Reduce": "add"}),
    "cos_sim": lambda r: ({"X": [_u(r, (4, 3))], "Y": [_u(r, (4, 3))]},
                          {}),
    "cos_sim[broadcast]": lambda r: ({"X": [_u(r, (4, 3))],
                                      "Y": [_u(r, (1, 3))]}, {}),
    "dist[p3]": lambda r: ({"X": [_u(r, (4, 3))], "Y": [_u(r, (4, 3))]},
                           {"p": 3.0}),
    "dist[p_inf]": lambda r: ({"X": [_u(r, (4, 3))], "Y": [_u(r, (4, 3))]},
                              {"p": float("inf")}),
    "log_loss": lambda r: (
        {"Predicted": [_u(r, (4, 1), 0.1, 0.9)],
         "Labels": [(r.rand(4, 1) > 0.5).astype(np.float32)]}, {}),
    "hinge_loss[ties]": lambda r: (
        {"Logits": [np.array([[1.0], [-1.0], [0.3], [2.0]], np.float32)],
         "Labels": [np.array([[0.0], [1.0], [1.0], [0.0]], np.float32)]},
        {}),
    "rank_loss": lambda r: (
        {"Label": [(r.rand(4, 1) > 0.5).astype(np.float32)],
         "Left": [_u(r, (4, 1))], "Right": [_u(r, (4, 1))]}, {}),
    "nll_loss[mean]": lambda r: (
        {"X": [_u(r, (4, 3))], "Label": [np.array([0, 2, 1, 1], np.int32)]},
        {}),
    "nll_loss[none]": lambda r: (
        {"X": [_u(r, (4, 3))], "Label": [np.array([0, 2, 1, 1], np.int32)]},
        {"reduction": "none"}),
    "norm": lambda r: ({"X": [_u(r, (4, 3))]}, {"axis": 1}),
    "meshgrid": lambda r: ({"X": [_u(r, (3,)), _u(r, (2,))]}, {}),
    "unbind": lambda r: ({"X": [_u(r, (3, 4))]}, {"axis": 1}),
})


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_extra_gradient_matches_jax_vjp(case):
    op = case.split("[")[0]
    r = _rng(case)
    ins, attrs = GRAD_CASES[case](r)
    vjp_both(op, ins, attrs, r)


# -- layers --------------------------------------------------------------------

NEW_LAYERS = ("mish", "stanh", "reverse", "scatter_nd", "multiplex", "size",
              "diag", "pad_constant_like", "expand_as", "shard_index",
              "rank_loss", "log_loss", "unbind", "rank", "cos_sim", "auc",
              "conv2d_transpose", "instance_norm", "prelu", "group_norm",
              "case", "switch_case", "argsort", "cumsum", "eye",
              "linspace", "pow", "argmin", "triu", "elu", "relu6", "selu",
              "softshrink", "thresholded_relu", "pixel_shuffle", "mse_loss",
              "pad")


def _params(fn):
    import inspect

    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("name", NEW_LAYERS)
def test_layer_exists_with_the_reference_parameters(name):
    assert _params(getattr(pl, name)) == _params(getattr(jl, name)), name


def test_every_reference_row_of_a_registered_op_is_in_the_table():
    from paddle_tpu_torch.layers import generated as pgen

    rows = {r[0]: r for r in pgen.TABLE}
    for row in jgen._TABLE:
        if pt_registry.lookup(row[1]):
            assert tuple(rows[row[0]]) == tuple(row), row[0]
    assert {"mish", "stanh", "reverse", "scatter_nd", "multiplex", "size",
            "diag", "pad_constant_like", "expand_as", "shard_index",
            "rank_loss", "log_loss", "unbind"} <= set(rows)


def ref_json(prog):
    """The reference's JSON with Block-valued attrs as the port's
    ``{"__block__": idx}``."""

    def norm(v):
        if isinstance(v, JBlock):
            return {"__block__": v.idx}
        if isinstance(v, dict):
            return {k: norm(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(norm(x) for x in v)
        return v

    return json.loads(json.dumps(norm(prog.to_dict())))


def _json(prog):
    return json.loads(json.dumps(prog.to_dict()))


def _table_layers(P):
    L = P.L
    x = L.static_data("x", [4, 6], "float32")
    y = L.static_data("y", [3, 5], "float32")
    ids = L.static_data("ids", [4, 1], "int32")
    idx = L.static_data("idx", [4, 1], "int32")
    lab = L.static_data("lab", [4, 1], "float32")
    return [L.mish(x), L.stanh(x, scale_a=0.5), L.reverse(x, axis=[0, 1]),
            L.scatter_nd(idx, x, shape=[5, 6]),
            L.multiplex([x, L.scale(x, 2.0)], ids), L.size(x),
            L.diag(L.reduce_sum(x, dim=[1])), L.pad_constant_like(x, y,
                                                                  pad_value=1.0),
            L.expand_as(y, L.concat([y, y], axis=0)),
            L.shard_index(ids, index_num=10, nshards=2, shard_id=1),
            L.rank_loss(lab, L.slice(x, [1], [0], [1]),
                        L.slice(x, [1], [1], [2])),
            L.log_loss(L.sigmoid(L.slice(x, [1], [0], [1])), lab),
            L.unbind(x, axis=1), L.rank(x), L.cos_sim(x, x),
            L.auc(L.softmax(L.slice(x, [1], [0], [2])),
                  L.cast(lab, "int64"), num_thresholds=16)[0],
            L.group_norm(L.reshape(x, [4, 6, 1, 1]), 3)]


def test_table_and_composed_layers_build_the_reference_program():
    jm, js, _ = build(JAX, _table_layers)
    pm, ps, _ = build(PORT, _table_layers)
    assert _json(pm) == ref_json(jm)
    assert _json(ps) == ref_json(js)


# -- the card legs' programs at small widths -----------------------------------

def _state(startup):
    scope = Scope()
    Executor(device="cpu").run(startup, scope=scope)
    return {n: v.numpy().copy() for n, v in scope.items()
            if isinstance(v, torch.Tensor)}


def _jax_runs(main, state, feeds, fetch):
    exe, sc = pt.Executor(pt.CPUPlace()), pt.Scope()
    for n, v in state.items():
        sc.set(n, jnp.asarray(v))
    return [[np.asarray(o) for o in exe.run(main, feed=f, fetch_list=fetch,
                                            scope=sc)] for f in feeds]


def _port_runs(main, state, feeds, fetch, use_compiled):
    exe, sc = Executor(device="cpu"), scope_from_numpy(state, "cpu")
    return [exe.run(main, feed=f, fetch_list=fetch, scope=sc,
                    use_compiled=use_compiled) for f in feeds]


def _close(tag, got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (tag, got.shape, want.shape, got.dtype, want.dtype)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   equal_nan=True, err_msg=tag)
    else:
        np.testing.assert_array_equal(got, want, err_msg=tag)


LEGS = {
    "mlm_nll": (lambda P: lec.mlm_nll(P, 16, 50),
                lambda: [lec.mlm_feed(16, 50, s) for s in (0, 1)]),
    "mlm_softmax_ce": (lambda P: lec.mlm_softmax_ce(P, 16, 50),
                       lambda: [lec.mlm_feed(16, 50, s) for s in (0, 1)]),
    "ctr_auc": (lambda P: lec.ctr_auc(P, 64, 8, 31),
                lambda: lec.ctr_feeds(64, 8, 4)),
    "embedding_scatter": (lambda P: lec.embedding_scatter(P, 96, 40, 6, 4),
                          lambda: [lec.embedding_feed(96, 40, 6, s)
                                   for s in (0, 1)]),
    "order_stats": (lambda P: lec.order_stats(P, 12, 10),
                    lambda: [lec.order_stats_feed(12, 10, s)
                             for s in (0, 1)]),
    "cholesky": (lambda P: lec.linalg(P, 4, 5, "cholesky"),
                 lambda: [lec.linalg_feed(4, 5, 1, s) for s in (0, 1)]),
    "inverse": (lambda P: lec.linalg(P, 4, 5, "inverse"),
                lambda: [lec.linalg_feed(4, 5, 1, s) for s in (0, 1)]),
}


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_card_leg_program_runs_as_the_reference(leg):
    """JSON equal; op by op against the reference (floats within 1e-5,
    integers bit for bit, the streamed AUC's stat vars bit for bit); the
    compiled step against op by op bit for bit, with no uncaptured run
    but for the inverse leg, whose compiled runs are all uncaptured (its
    op decides on the host: ``inv_ex`` cannot be captured on CUDA); the
    reference's program loaded from its JSON runs to the same outputs."""
    builder, feeds = LEGS[leg]
    feeds = feeds()
    jm, js, jf = build(JAX, builder)
    pm, ps, pf = build(PORT, builder)
    assert _json(pm) == ref_json(jm) and _json(ps) == ref_json(js)
    state = _state(ps)
    names = [v.name for v in pf]
    want = _jax_runs(jm, state, feeds, [v.name for v in jf])
    got = _port_runs(pm, state, feeds, names, False)
    for k, (g_run, w_run) in enumerate(zip(got, want)):
        for i, (g, w) in enumerate(zip(g_run, w_run)):
            tol = 0.0 if leg == "ctr_auc" and i > 0 else TOL
            _close(f"{leg}[{k}][{i}]", g, w, tol)
    before = telemetry.counter_get("executor.uncaptured_steps")
    comp = _port_runs(pm, state, feeds + feeds[:1], names, True)
    # a key's first run goes op by op; every compiled run after it
    uncaptured = len(feeds) if leg == "inverse" else 0
    assert telemetry.counter_get("executor.uncaptured_steps") == \
        before + uncaptured
    for k, run in enumerate(comp[:len(got)]):
        for i, (c, g) in enumerate(zip(run, got[k])):
            np.testing.assert_array_equal(c, g, err_msg=f"{leg}[{k}][{i}]")
    loaded = PProgram.from_dict(ref_json(jm))
    again = _port_runs(loaded, state, feeds, [v.name for v in jf], False)
    for k, (a_run, g_run) in enumerate(zip(again, got)):
        for i, (a, g) in enumerate(zip(a_run, g_run)):
            np.testing.assert_array_equal(a, g, err_msg=f"{leg}[{k}][{i}]")


def test_mlm_nll_equals_softmax_cross_entropy():
    """The logsumexp + nll_loss loss and gradient against
    softmax_with_cross_entropy's on the same logits (the card leg's
    yardstick): the loss within 1e-5 relative, the gradient within 1e-5
    of its largest magnitude."""
    feed = lec.mlm_feed(32, 97, 3)
    outs = {}
    for name, builder in (("nll", lambda P: lec.mlm_nll(P, 32, 97)),
                          ("ce", lambda P: lec.mlm_softmax_ce(P, 32, 97))):
        m, s, f = build(PORT, builder)
        outs[name], = _port_runs(m, {}, [feed], [v.name for v in f], False)
    (l1, g1), (l2, g2) = outs["nll"], outs["ce"]
    assert abs(float(l1) - float(l2)) <= 1e-5 * abs(float(l2))
    assert np.abs(g1 - g2).max() <= 1e-5 * np.abs(g2).max()


def test_streamed_auc_equals_the_metric():
    """The auc op's stat vars after a streamed evaluation give the port's
    ``metric.Auc`` value on the same predictions within 1e-6."""
    feeds = lec.ctr_feeds(64, 8, 4, seed=5)
    m, s, f = build(PORT, lambda P: lec.ctr_auc(P, 64, 8, 4095))
    runs = _port_runs(m, _state(s), feeds, [v.name for v in f], True)
    metric = Auc(num_thresholds=4095)
    for feed in feeds:
        q, t = feed["query"], feed["item"]
        cos = (q * t).sum(1) / np.maximum(np.linalg.norm(q, axis=1)
                                          * np.linalg.norm(t, axis=1), 1e-12)
        p = (cos * 0.5 + 0.5).astype(np.float32)
        metric.update(np.stack([1 - p, p], 1), feed["click"])
    assert abs(float(runs[-1][0]) - metric.accumulate()) <= 1e-6
    assert float(runs[-1][1].sum() + runs[-1][2].sum()) == 4 * 64


# -- interchange: a reference program holding all 64 op types ------------------

def _first_case(op):
    """The first glue case of ``op`` the reference runs, without bf16."""
    for case in sorted(c for c in CASES if c.split("[")[0] == op):
        ins, attrs = CASES[case](_rng(case))
        if any(isinstance(v, BF16) for vs in ins.values() for v in vs):
            continue
        try:
            from tests.test_torch_linalg_ops import run_ref

            run_ref(op, ins, attrs)
        except Exception:                       # noqa: BLE001
            continue
        return case, ins, attrs
    raise AssertionError(op)


def _all_ops_program():
    """One reference program: for each of the 64 op types its first glue
    case as one op over fed inputs."""
    from paddle_tpu_torch.tools.linalg_extra_cases import _op

    main, startup = pt.Program(), pt.Program()
    feed, fetch = {}, []
    with jax_names.guard(), pt.program_guard(main, startup):
        for k, op in enumerate(LINALG_EXTRA_OPS):
            case, ins, attrs = _first_case(op)
            vins = {}
            for slot, vals in ins.items():
                vins[slot] = []
                for j, v in enumerate(vals):
                    a = np.asarray(v)
                    a = a.astype(np.int32) if a.dtype == np.int64 else a
                    name = f"in{k}_{slot}_{j}"
                    feed[name] = a
                    vins[slot].append(jl.static_data(name, list(a.shape),
                                                     str(a.dtype)))
            want = pt_registry.normalize_outputs(
                run_port(op, ins, attrs))
            outs = _op(JAX, op, vins, {s: "float32" for s in want}, attrs)
            for slot in sorted(want):
                if len(want[slot]) == 1:
                    fetch.append(outs[slot])
    return main, feed, fetch


def test_a_reference_program_of_all_64_op_types_runs_in_the_port():
    main, feed, fetch = _all_ops_program()
    ops = {o.type for o in main.global_block().ops}
    assert ops == set(LINALG_EXTRA_OPS)
    names = [v.name for v in fetch]
    want = pt.Executor(pt.CPUPlace()).run(main, feed=feed, fetch_list=names,
                                          scope=pt.Scope())
    loaded = PProgram.from_dict(ref_json(main))
    got = Executor(device="cpu").run(loaded, feed=feed, fetch_list=names,
                                     scope=Scope())
    for n, g, w in zip(names, got, want):
        _close(n, g, np.asarray(w))


# -- static.nn's six names -------------------------------------------------------

def _static_nn(P):
    snn = P.mod.static.nn
    L = P.L
    x = L.static_data("img", [2, 4, 5, 5], "float32")
    k = L.static_data("k", [1], "int64")
    up = snn.conv2d_transpose(x, 3, 3, stride=2, padding=1, act="relu")
    inorm = snn.instance_norm(x)
    pr = snn.prelu(x, mode="channel")
    gn = snn.group_norm(x, 2)
    s = L.reshape(L.reduce_mean(x), [1])
    two = L.fill_constant([1], "float32", 2.0)
    c = snn.case([(L.less_than(s, L.fill_constant([1], "float32", -9.0)),
                   lambda: s * two),
                  (L.less_than(s, L.fill_constant([1], "float32", 9.0)),
                   lambda: s + two)], default=lambda: L.scale(s, 3.0))
    sw = snn.switch_case(k, {0: lambda: s - two, 2: lambda: s * s},
                         default=lambda: s + s)
    return [up, inorm, pr, gn, c, sw]


@pytest.mark.parametrize("k", [0, 2, 5])
def test_static_nn_six_names_run_as_the_reference(k):
    jm, js, jf = build(JAX, _static_nn)
    pm, ps, pf = build(PORT, _static_nn)
    assert _json(pm) == ref_json(jm) and _json(ps) == ref_json(js)
    state = _state(ps)
    r = np.random.RandomState(k)
    feed = {"img": r.randn(2, 4, 5, 5).astype(np.float32),
            "k": np.array([k], np.int64)}
    want, = _jax_runs(jm, state, [feed], [v.name for v in jf])
    got, = _port_runs(pm, state, [feed], [v.name for v in pf], False)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(f"static_nn[{i}]", g, w)
