"""Control flow in paddle_tpu_torch against paddle_tpu on the CPU: the
``cond``, ``while_loop``, ``static_loop``, ``DynamicRNN``, ``IfElse``,
``conditional_block`` and rank-table / tensor-array programs, built by
the same layer calls in both packages.

Each program's JSON equals the reference's (Block-valued attrs in the
port's ``{"__block__": idx}`` form); from one state both packages give
the same fetches (floats within 1e-5, integers bit for bit), the port's
compiled step gives its op-by-op results bit for bit, and the
reference's program, loaded by the port from its JSON, runs to the same
results and writes the same JSON back. The reference's own cases
(``tests/test_control_flow.py``, ``tests/test_dynamic_rnn.py``, the
split/merge and IfElse cases of ``tests/test_ops_round5.py``) run on the
port with their numpy oracles. Also: an unbounded ``while_loop``'s
gradient raises at build time; a bounded one's truncation raises op by
op and warns from a compiled step; a ``cond`` whose untaken branch would
give NaN leaves a finite gradient (the branch does not run); a compiled
step holding a host-deciding op runs uncaptured, counted and named; the
12 + 3 control-flow op types against the reference's lowerings."""

import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.ops  # noqa: F401
from paddle_tpu.core import registry as jax_registry
from paddle_tpu.core import unique_name as jax_names
from paddle_tpu.core.ir import Block as JBlock
import tests.test_dynamic_rnn as ref_drnn
from tests.test_torch_math_tensor_ops import check_op, ref_ops, vjp_both

from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.core import telemetry
from paddle_tpu_torch.core.executor import Executor, host_decider
from paddle_tpu_torch.core.ir import Program as PProgram
from paddle_tpu_torch.core.scope import Scope, scope_from_numpy
from paddle_tpu_torch.ops.control_flow_ops import truncation_message
from paddle_tpu_torch.tools.control_flow_cases import (
    FEEDS, Pkg, build as _build, cond_grad, dynamic_rnn, if_else, port,
    static_loop_grad, while_bounded, while_dynamic)
from paddle_tpu_torch.tools.glue_cases import CASES, family, rng as _rng

torch.set_num_threads(2)

TOL = 1e-5


JAX = Pkg(pt, pt.layers, pt.initializer, pt.optimizer, pt.ParamAttr,
          jax_names)
PORT = port()


def ref_json(prog):
    """The reference program's JSON with its Block-valued attrs in the
    port's form (the reference's ``to_dict`` leaves Block objects)."""

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


def _state(startup):
    """The port's startup state as numpy arrays: both packages run from
    it (their random initializers draw other bits)."""
    scope = Scope()
    Executor(device="cpu").run(startup, scope=scope)
    return {n: v.numpy().copy() for n, v in scope.items()
            if isinstance(v, torch.Tensor)}


def _jax_run(main, state, feed, fetch, steps=1):
    exe, sc = pt.Executor(pt.CPUPlace()), pt.Scope()
    for n, v in state.items():
        sc.set(n, jnp.asarray(v))
    return [[np.asarray(o) for o in exe.run(main, feed=feed,
                                            fetch_list=fetch, scope=sc)]
            for _ in range(steps)]


def _port_run(main, state, feed, fetch, steps=1, use_compiled=False):
    exe, sc = Executor(device="cpu"), scope_from_numpy(state, "cpu")
    return [exe.run(main, feed=feed, fetch_list=fetch, scope=sc,
                    use_compiled=use_compiled) for _ in range(steps)]


def _close(tag, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (tag, got.shape, want.shape, got.dtype, want.dtype)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=tag)
    else:
        np.testing.assert_array_equal(got, want, err_msg=tag)


@pytest.mark.parametrize("case", sorted(FEEDS))
def test_program_runs_as_the_reference(case):
    """JSON equal; the port op by op against the reference; the port's
    compiled step (built at its second run) against op by op bit for bit;
    the reference's JSON loaded and run by the port."""
    builder, feed = FEEDS[case]
    jm, js, jf = _build(JAX, builder)
    pm, ps, pf = _build(PORT, builder)
    assert _json(pm) == ref_json(jm) and _json(ps) == ref_json(js)
    state = _state(ps)
    jnames = [v.name for v in jf]
    want, = _jax_run(jm, state, feed, jnames)
    got, = _port_run(pm, state, feed, [v.name for v in pf])
    for i, (g, w) in enumerate(zip(got, want)):
        _close(f"{case}[{i}]", g, w)
    if case.startswith("cond_nan_branch[negative]"):
        assert np.isfinite(got[1]).all() and got[1].item() == -2.0
    comp = _port_run(pm, state, feed, [v.name for v in pf], steps=3,
                     use_compiled=True)
    for run in comp[1:]:
        for i, (c, g) in enumerate(zip(run, got)):
            np.testing.assert_array_equal(c, g, err_msg=f"{case}[{i}]")
    loaded = PProgram.from_dict(ref_json(jm))
    assert _json(loaded) == ref_json(jm)
    again, = _port_run(loaded, state, feed, jnames)
    for i, (a, g) in enumerate(zip(again, got)):
        np.testing.assert_array_equal(a, g, err_msg=f"{case}[{i}]")


def test_cond_and_while_reference_cases():
    """tests/test_control_flow.py's assertions on the port: the branch's
    scale and its gradient, an identity branch, a branch reading the
    predicate, the dynamic trip count, the static loop's w**3 gradient."""
    pm, ps, pf = _build(PORT, cond_grad)
    exe, sc = Executor(device="cpu"), Scope()
    exe.run(ps, scope=sc)
    xv = np.ones((2, 4), np.float32)
    for flag_v, scale in ((True, 3.0), (False, 0.5)):
        o, g = exe.run(pm, feed={"x": xv, "flag": np.array([flag_v])},
                       fetch_list=pf, scope=sc)
        np.testing.assert_allclose(o, scale * xv, atol=1e-6)
        np.testing.assert_allclose(g, scale / 8 * np.ones_like(xv),
                                   atol=1e-6)
    pm, ps, pf = _build(PORT, while_dynamic)
    for n in (3, 7):
        iv, av = exe.run(pm, feed={"limit": np.array([n], np.int32)},
                         fetch_list=pf, scope=sc)
        assert int(iv.reshape(-1)[0]) == n and float(av.reshape(-1)[0]) \
            == 2.0 * n
    pm, ps, pf = _build(PORT, static_loop_grad)
    exe.run(ps, scope=sc)
    xv = np.ones((2, 3), np.float32)
    o, g = exe.run(pm, feed={"x": xv}, fetch_list=pf, scope=sc)
    np.testing.assert_allclose(o, 1.5 ** 3 * xv, atol=1e-5)
    np.testing.assert_allclose(g.reshape(-1)[0], 3 * 1.5 ** 2 * 6.0,
                               rtol=1e-5)


def test_mismatched_branches_are_rejected_as_in_the_reference():
    for P in (JAX, PORT):
        def two(P=P):
            L = P.L
            x = L.data("x", [4])
            flag = L.data("flag", [1], dtype="bool", append_batch_size=False)
            with pytest.raises(ValueError, match="same number"):
                L.cond(flag, lambda: (L.scale(x, scale=1.0),
                                      L.scale(x, scale=2.0)),
                       lambda: L.scale(x, scale=0.5))
            with pytest.raises(ValueError, match="false_fn"):
                L.cond(flag, lambda: L.scale(x, scale=2.0))
            return []

        _build(P, two)


# -- DynamicRNN ---------------------------------------------------------------

def _drnn_feed(seed, lengths=(6, 3, 1, 0)):
    r = np.random.RandomState(seed)
    return {"x": r.randn(4, 6, 3).astype(np.float32),
            "len": np.array(lengths, np.int64),
            "label": r.randn(4, 5).astype(np.float32)}


def test_dynamic_rnn_matches_the_oracle_and_trains():
    """tests/test_dynamic_rnn.py on the port: step 0 against the numpy
    oracle, six falling losses, and zero-length rows giving zeros."""
    pm, ps, (seq_out, final, loss) = _build(PORT, dynamic_rnn)
    exe, sc = Executor(device="cpu"), Scope()
    exe.run(ps, scope=sc)
    feed = _drnn_feed(0)
    w, b = sc.find_var("rnn_w").numpy().copy(), \
        sc.find_var("rnn_b").numpy().copy()
    losses = []
    for step in range(6):
        o, f, lv = exe.run(pm, feed=feed, fetch_list=[seq_out, final, loss],
                           scope=sc)
        if step == 0:
            want_o, want_f = ref_drnn.TestDynamicRNN()._oracle(
                feed["x"], feed["len"], w, b)
            np.testing.assert_allclose(o, want_o, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(f, want_f, rtol=1e-4, atol=1e-5)
        losses.append(float(lv.reshape(-1)[0]))
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    assert losses[-1] < losses[0] * 0.9, losses
    o, f = exe.run(pm, feed=_drnn_feed(1, (0, 0, 0, 0)),
                   fetch_list=[seq_out, final], scope=sc)
    assert not o.any() and not f.any()


def test_dynamic_rnn_trains_as_the_reference_and_compiled_bitwise():
    """Three SGD steps from one state: losses within 1e-5 of the
    reference's; the compiled step's losses, outputs and parameters
    equal op by op bit for bit."""
    jm, js, jf = _build(JAX, dynamic_rnn)
    pm, ps, pf = _build(PORT, dynamic_rnn)
    assert _json(pm) == ref_json(jm) and _json(ps) == ref_json(js)
    state = _state(ps)
    feed = _drnn_feed(2)
    want = _jax_run(jm, state, feed, [v.name for v in jf], steps=3)
    names = [v.name for v in pf]
    op = _port_run(pm, state, feed, names, steps=3)
    comp = _port_run(pm, state, feed, names, steps=3, use_compiled=True)
    for s in range(3):
        for i in range(3):
            _close(f"step{s}[{i}]", op[s][i], want[s][i])
            np.testing.assert_array_equal(comp[s][i], op[s][i])
    loaded = PProgram.from_dict(ref_json(jm))
    assert _json(loaded) == ref_json(jm)
    again = _port_run(loaded, state, feed, names, steps=3)
    for s in range(3):
        for i in range(3):
            np.testing.assert_array_equal(again[s][i], op[s][i])


# -- the truncation guard, the unbounded gradient, the uncaptured step --------

def test_unbounded_while_loop_gradient_raises_at_build_time():
    for P in (JAX, PORT):
        def build(P=P):
            L = P.L
            x = L.data("x", [3], stop_gradient=False)

            def b(v):
                return [L.scale(v, scale=2.0)]

            out, = L.while_loop(
                lambda v: L.less_than(L.reduce_sum(v),
                                      L.fill_constant([1], "float32", 9.0)),
                b, [x])
            with pytest.raises(ValueError, match="grad_max_iters"):
                P.mod.gradients([L.reduce_sum(out)], [x])
            return []

        _build(P, build)


def test_truncation_raises_op_by_op_and_warns_when_compiled():
    """limit 1e6 needs more than the bound's 8 doublings: the reference's
    op-by-op run and the port's raise; the port's compiled step (built at
    the second run of the key) keeps the flag and warns with the same
    message once the fetches are out, and not for an input that fits."""
    feed = {"x": np.full((2, 3), 0.5, np.float32),
            "limit": np.array([1e6], np.float32)}
    jm, js, jf = _build(JAX, while_bounded)
    with pytest.raises(RuntimeError, match="truncated at 8") as ref:
        pt.Executor(pt.CPUPlace()).run(jm, feed=feed, fetch_list=jf,
                                       scope=pt.Scope(), use_compiled=False)
    pm, ps, pf = _build(PORT, while_bounded)
    exe, sc = Executor(device="cpu"), Scope()
    with pytest.raises(RuntimeError) as got:
        exe.run(pm, feed=feed, fetch_list=pf, scope=sc, use_compiled=False)
    message = truncation_message(8)
    assert message in str(got.value) and message in str(ref.value)
    ok = {"x": feed["x"], "limit": np.array([5.0], np.float32)}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        exe.run(pm, feed=ok, fetch_list=pf, scope=sc)    # op by op
    for _ in range(2):                                    # compiled
        with pytest.warns(UserWarning, match="truncated at 8"):
            exe.run(pm, feed=feed, fetch_list=pf, scope=sc)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        exe.run(pm, feed=ok, fetch_list=pf, scope=sc)


def test_host_deciding_ops_run_uncaptured_counted_and_named():
    """A compiled step with a cond runs uncaptured every run (counted by
    executor.uncaptured_steps, named in its compile record); one with
    only a static loop and a bounded while_loop has nothing to name."""
    for builder, want in ((cond_grad, "cond"), (while_dynamic, "while_loop"),
                          (if_else, None), (static_loop_grad, None),
                          (dynamic_rnn, None), (while_bounded, None)):
        pm, _, _ = _build(PORT, builder)
        assert host_decider(pm.global_block().ops) == want, builder
    pm, ps, pf = _build(PORT, cond_grad)
    exe, sc = Executor(device="cpu"), Scope()
    before = telemetry.counter_get("executor.uncaptured_steps") or 0
    feed = {"x": np.ones((2, 4), np.float32), "flag": np.array([True])}
    for _ in range(3):
        exe.run(pm, feed=feed, fetch_list=pf, scope=sc)
    after = telemetry.counter_get("executor.uncaptured_steps") or 0
    assert after - before == 2
    step, = [c for steps in exe._compiled[pm].values()
             for c in steps.values()]
    assert step.host_op == "cond"
    compiles = [e for e in telemetry.recent_events("compile")
                if e["attrs"].get("program") == step.cause_key[0]]
    assert compiles and compiles[-1]["attrs"]["uncaptured"] == "cond"


# -- the op types ---------------------------------------------------------------

NEW_TYPES = ("conditional_block", "while", "print", "cond", "while_loop",
             "static_loop", "array_read", "array_write", "lod_rank_table",
             "split_lod_tensor", "merge_lod_tensor", "run_program",
             "shrink_rnn_memory", "lod_tensor_to_array",
             "array_to_lod_tensor")


def test_every_control_flow_op_type_is_registered():
    """The reference's control_flow_ops module (13 op types with
    block_call) and the three array ops of extra_ops4 are all in the
    port."""
    ours = ref_ops("control_flow_ops")
    assert sorted(ours) == sorted(set(NEW_TYPES[:12]) | {"block_call"})
    for op in NEW_TYPES:
        assert pt_registry.lookup(op) is not None, op
        assert jax_registry.lookup(op) is not None, op


ARRAY_CASES = {c: f for c, f in CASES.items() if family(c.split("[")[0])
               == "array"}


@pytest.mark.parametrize("case", sorted(ARRAY_CASES))
def test_array_op_matches_the_reference(case):
    check_op(case.split("[")[0], *ARRAY_CASES[case](_rng(case)), case, 0.0)


ARRAY_GRAD_CASES = ("array_read[sweep]", "array_write[sweep]",
                    "split_lod_tensor[rows]", "merge_lod_tensor[rows]",
                    "shrink_rnn_memory[step2]",
                    "lod_tensor_to_array[ragged]",
                    "array_to_lod_tensor[ragged]")


@pytest.mark.parametrize("case", ARRAY_GRAD_CASES)
def test_array_op_gradient_matches_the_reference(case):
    r = _rng(case)
    ins, attrs = ARRAY_CASES[case](r)
    vjp_both(case.split("[")[0], ins, attrs, r, TOL)


def test_split_merge_and_ifelse_reference_cases():
    """tests/test_ops_round5.py TestSplitMergeLodTensor on the port:
    split's zeroed rows, merge's row select, IfElse's rowwise result."""
    r = np.random.RandomState(5)
    x = r.randn(4, 3).astype(np.float32)
    mask = np.array([[1], [0], [1], [0]], np.int32)
    m = mask.reshape(-1).astype(bool)
    got = pt_registry.get("split_lod_tensor").forward(
        {"X": [torch.from_numpy(x)], "Mask": [torch.from_numpy(mask)]}, {})
    np.testing.assert_array_equal(got["OutTrue"].numpy(),
                                  np.where(m[:, None], x, 0))
    np.testing.assert_array_equal(got["OutFalse"].numpy(),
                                  np.where(m[:, None], 0, x))
    it, if_ = r.randn(4, 3).astype(np.float32), r.randn(4, 3).astype(
        np.float32)
    got = pt_registry.get("merge_lod_tensor").forward(
        {"InTrue": [torch.from_numpy(it)], "InFalse": [torch.from_numpy(if_)],
         "Mask": [torch.from_numpy(mask)]}, {})["Out"]
    np.testing.assert_array_equal(got.numpy(), np.where(m[:, None], it, if_))
    pm, ps, (out,) = _build(PORT, if_else)
    r = np.random.RandomState(6)
    xv = r.randn(4, 3).astype(np.float32)
    mk = np.array([[1], [0], [0], [1]], np.float32)
    o, = Executor(device="cpu").run(pm, feed={"x": xv, "mk": mk},
                                    fetch_list=[out], scope=Scope())
    np.testing.assert_allclose(o, np.where(mk.astype(bool), xv * 2.0,
                                           xv - 1.0), atol=1e-6)


def test_dynamic_rnn_reference_array_cases():
    """tests/test_dynamic_rnn.py TestArrayOps on the port."""
    buf, v = torch.zeros(4, 2, 3), torch.ones(2, 3)
    w = pt_registry.get("array_write").forward(
        {"X": [buf], "I": [torch.tensor(2, dtype=torch.int32)], "V": [v]},
        {})["Out"]
    rd = pt_registry.get("array_read").forward(
        {"X": [w], "I": [torch.tensor(2, dtype=torch.int32)]}, {})["Out"]
    assert torch.equal(rd, v) and float(w.sum()) == 6.0
    out = pt_registry.get("lod_rank_table").forward(
        {"X": [torch.tensor([2, 5, 0, 5], dtype=torch.int32)]}, {})
    assert out["Items"].tolist() == [5, 5, 2, 0]
    assert out["Index"].tolist() == [1, 3, 0, 2]
    assert out["Index"].dtype == torch.int32


def test_conditional_block_runs_only_when_its_condition_holds():
    """A conditional_block whose sub-block updates a var with ``sum``:
    where Cond is false the sub-block does not run and the output is its
    input; the reference's lowering gives the same values."""
    for_cond = {}
    for P in (JAX, PORT):
        main = P.mod.Program()
        with P.names.guard(), P.mod.program_guard(main, P.mod.Program()):
            acc = P.L.static_data("acc", [2], "float32")
            inc = P.L.static_data("inc", [2], "float32")
            flag = P.L.static_data("flag", [1], "bool")
            blk = main.global_block()
            sub = main.create_block()
            sub.append_op("sum", {"X": [acc, inc]}, {"Out": [acc]}, {})
            main.rollback()
            blk.append_op("conditional_block",
                          {"Cond": [flag], "X": [acc, inc]}, {"Out": [acc]},
                          {"sub_block": sub, "input_names": [acc.name,
                                                             inc.name],
                           "output_names": [acc.name]})
        for_cond[P is PORT] = main
    assert _json(for_cond[True]) == ref_json(for_cond[False])
    loaded = PProgram.from_dict(ref_json(for_cond[False]))
    assert _json(loaded) == ref_json(for_cond[False])
    for_cond[True] = loaded
    a, i = np.array([1.0, 2.0], np.float32), np.array([3.0, 5.0],
                                                        np.float32)
    for f, want in ((True, a + i), (False, a)):
        feed = {"acc": a, "inc": i, "flag": np.array([f])}
        j, = pt.Executor(pt.CPUPlace()).run(for_cond[False], feed=feed,
                                            fetch_list=["acc"],
                                            scope=pt.Scope())
        p, = Executor(device="cpu").run(for_cond[True], feed=feed,
                                        fetch_list=["acc"], scope=Scope())
        np.testing.assert_array_equal(p, want)
        np.testing.assert_array_equal(np.asarray(j), want)


def test_print_op_prints_and_passes_its_input(capsys):
    x = torch.tensor([1.5, -2.0])
    out = pt_registry.get("print").forward({"X": [x]},
                                           {"message": "probe"})["Out"]
    assert out is x and "probe: [ 1.5 -2. ]" in capsys.readouterr().out


def test_run_program_runs_its_program_and_differentiates():
    """run_program with a two-op Program (x * w + 1) against the
    reference's run_program of the same program; its gradient through the
    generic vjp against jax.vjp."""
    progs = {}
    for P in (JAX, PORT):
        prog = P.mod.Program()
        with P.names.guard(), P.mod.program_guard(prog, P.mod.Program()):
            x = P.L.static_data("x", [2, 3], "float32")
            w = P.L.static_data("w", [3], "float32")
            y = P.L.scale(P.L.elementwise_mul(x, w), bias=1.0)
        progs[P is PORT] = (prog, y.name)
    r = np.random.RandomState(4)
    ins = {"X": [r.randn(2, 3).astype(np.float32)],
           "Params": [r.randn(3).astype(np.float32)]}
    attrs = {"feed_names": ["x"], "param_names": ["w"]}
    jprog, jy = progs[False]
    pprog, py = progs[True]
    want = jax_registry.get("run_program").forward(
        {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()},
        dict(attrs, program=jprog, fetch_names=[jy]))["Out"][0]
    got = pt_registry.get("run_program").forward(
        {k: [torch.from_numpy(v) for v in vs] for k, vs in ins.items()},
        dict(attrs, program=pprog, fetch_names=[py]))["Out"][0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    ct = torch.from_numpy(r.randn(2, 3).astype(np.float32))
    grads = pt_registry.get("__vjp_grad__").forward(
        {"In__X": [torch.from_numpy(ins["X"][0])],
         "In__Params": [torch.from_numpy(ins["Params"][0])],
         "OG__Out": [ct]},
        {"fwd_type": "run_program",
         "fwd_attrs": dict(attrs, program=pprog, fetch_names=[py])})
    np.testing.assert_allclose(grads["IG__Params"][0].numpy(),
                               (ct.numpy() * ins["X"][0]).sum(0), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(grads["IG__X"][0].numpy(),
                               ct.numpy() * ins["Params"][0], rtol=TOL,
                               atol=TOL)
