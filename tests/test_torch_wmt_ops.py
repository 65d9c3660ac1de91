"""The WMT Transformer's new ops in paddle_tpu_torch, held against
paddle_tpu on the CPU: ``one_hot``, ``one_hot_v2``, ``label_smooth``,
``assign_value``, ``increment`` and every branch of ``lr_schedule``.

Both lowerings get the same numpy inputs, made from a seed. The one-hot
rows, the smoothed labels, the copies and the counter are compared bit
for bit; the schedules' rates within rtol = atol = 1e-6 (most are bit
for bit, a few steps of noam, natural_exp and inverse_time one ulp
apart: the frameworks round s^-0.5, exp and the division their own
way). The learning-rate schedules run at steps 0 and 1, around their
warm-up or decay steps and well beyond, with cycle and staircase both
ways, the step read from the ``Step`` input tensor as the programs feed
it; the host-step fallback runs op by op and raises in a compiled step.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu.core import registry as jax_registry

from paddle_tpu_torch import layers as players
from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.core import unique_name as pt_names
from paddle_tpu_torch.core.executor import ExecutionError, Executor
from paddle_tpu_torch.core.ir import OpRole, Program, program_guard
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.initializer import NumpyArrayInitializer
from paddle_tpu_torch.param_attr import ParamAttr

torch.set_num_threads(2)

NEW_OPS = ("one_hot", "one_hot_v2", "label_smooth", "assign_value",
           "increment", "lr_schedule")


def _ids(rng, shape, depth, dtype):
    ids = rng.randint(0, depth, shape).astype(dtype)
    flat = ids.reshape(-1)
    flat[0], flat[-1] = 0, depth - 1        # both ends of the range
    return ids


# case -> (inputs, attrs, exact)
OP_CASES = {
    "one_hot[trailing1,int32]": lambda r: (
        {"X": _ids(r, (4, 6, 1), 11, np.int32)}, {"depth": 11}, True),
    "one_hot[trailing1,int64]": lambda r: (
        {"X": _ids(r, (4, 6, 1), 11, np.int64)}, {"depth": 11}, True),
    "one_hot[2d,int32]": lambda r: (
        {"X": _ids(r, (4, 6), 7, np.int32)}, {"depth": 7}, True),
    "one_hot[2d,int64]": lambda r: (
        {"X": _ids(r, (2, 9), 96, np.int64)}, {"depth": 96}, True),
    "one_hot_v2[trailing1,int32]": lambda r: (
        {"X": _ids(r, (4, 6, 1), 11, np.int32)}, {"depth": 11}, True),
    "one_hot_v2[2d,int64]": lambda r: (
        {"X": _ids(r, (4, 6), 5, np.int64)}, {"depth": 5}, True),
    "label_smooth[eps0]": lambda r: (
        {"X": np.eye(12, dtype=np.float32)[r.randint(0, 12, (3, 5))]},
        {"epsilon": 0.0}, True),
    "label_smooth[eps0.1]": lambda r: (
        {"X": np.eye(12, dtype=np.float32)[r.randint(0, 12, (3, 5))]},
        {"epsilon": 0.1}, True),
    "label_smooth[soft]": lambda r: (
        {"X": r.rand(4, 33).astype(np.float32)}, {"epsilon": 0.1}, True),
    "assign_value[float32]": lambda r: (
        {}, {"shape": [3, 4], "values": r.randn(12).astype(np.float32)
             .tolist(), "dtype": "float32"}, True),
    "assign_value[int32]": lambda r: (
        {}, {"shape": [2, 5], "values": r.randint(-9, 9, 10).tolist(),
             "dtype": "int32"}, True),
    "assign_value[int64]": lambda r: (
        {}, {"shape": [6], "values": r.randint(0, 99, 6).tolist(),
             "dtype": "int64"}, True),
    "increment[float32]": lambda r: (
        {"X": np.array([-1.0], np.float32)}, {"step": 1.0}, True),
    "increment[float32,step2]": lambda r: (
        {"X": np.array([7.0], np.float32)}, {"step": 2.0}, True),
    "increment[int32]": lambda r: (
        {"X": np.array([3], np.int32)}, {"step": 1.0}, True),
}


def _lists(ins_np, conv):
    return {k: [conv(v)] for k, v in ins_np.items()}


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _compare(tag, got, want, exact):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape, tag
    assert got.dtype == want.dtype, tag
    if exact or not np.issubdtype(want.dtype, np.floating):
        assert np.array_equal(got, want), tag
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=tag)


def _run_both(op_type, ins_np, attrs):
    want = jax_registry.normalize_outputs(jax_registry.get(op_type).forward(
        _lists(ins_np, lambda x: x), dict(attrs)))
    got = pt_registry.normalize_outputs(pt_registry.get(op_type).forward(
        _lists(ins_np, _t), dict(attrs)))
    assert set(got) == set(want)
    return got, want


def test_the_new_ops_are_registered():
    for op_type in NEW_OPS:
        assert pt_registry.lookup(op_type) is not None, op_type
        assert pt_registry.get(op_type).forward is not None, op_type
    # a compiled step must not replay a host-to-device copy
    assert not pt_registry.get("assign_value").capturable
    for op_type in ("one_hot", "one_hot_v2", "increment", "lr_schedule"):
        assert pt_registry.get(op_type).capturable, op_type


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_matches_reference(case):
    op_type = case.split("[")[0]
    rng = np.random.RandomState(sum(map(ord, case)))
    ins_np, attrs, exact = OP_CASES[case](rng)
    got, want = _run_both(op_type, ins_np, attrs)
    for slot, vals in want.items():
        for i, w in enumerate(vals):
            _compare(f"{case}:{slot}[{i}]", got[slot][i], w, exact)


def test_one_hot_gives_zero_rows_outside_the_depth():
    """Ids outside [0, depth) get all-zero rows in both packages: the port
    compares against an arange and checks no bound."""
    ids = np.array([[-1, 0, 4, 5, 9]], np.int32)
    got, want = _run_both("one_hot_v2", {"X": ids}, {"depth": 5})
    _compare("one_hot_v2[outside]", got["Out"][0], want["Out"][0], True)
    assert not got["Out"][0][0, [0, 3, 4]].any()


# schedule -> (attrs, steps)
SCHEDULES = {
    "noam": ({"d_model": 1024, "warmup_steps": 4000, "learning_rate": 2.0},
             (0, 1, 2, 3999, 4000, 4001, 250000)),
    "noam[short]": ({"d_model": 128, "warmup_steps": 10,
                     "learning_rate": 1.0}, (0, 1, 9, 10, 11, 500)),
    "exponential": ({"learning_rate": 0.1, "decay_steps": 100,
                     "decay_rate": 0.5, "staircase": False},
                    (0, 1, 99, 100, 101, 2500)),
    "exponential[staircase]": ({"learning_rate": 0.1, "decay_steps": 100,
                                "decay_rate": 0.5, "staircase": True},
                               (0, 1, 99, 100, 101, 2500)),
    "natural_exp": ({"learning_rate": 0.1, "decay_steps": 50,
                     "decay_rate": 0.3, "staircase": False},
                    (0, 1, 49, 50, 51, 900)),
    "natural_exp[staircase]": ({"learning_rate": 0.1, "decay_steps": 50,
                                "decay_rate": 0.3, "staircase": True},
                               (0, 1, 49, 50, 51, 900)),
    "inverse_time": ({"learning_rate": 0.2, "decay_steps": 10,
                      "decay_rate": 0.5, "staircase": False},
                     (0, 1, 9, 10, 11, 777)),
    "inverse_time[staircase]": ({"learning_rate": 0.2, "decay_steps": 10,
                                 "decay_rate": 0.5, "staircase": True},
                                (0, 1, 9, 10, 11, 777)),
    "polynomial": ({"learning_rate": 0.1, "decay_steps": 100,
                    "end_learning_rate": 1e-4, "power": 2.0,
                    "cycle": False}, (0, 1, 99, 100, 101, 350)),
    "polynomial[cycle]": ({"learning_rate": 0.1, "decay_steps": 100,
                           "end_learning_rate": 1e-4, "power": 2.0,
                           "cycle": True}, (0, 1, 99, 100, 101, 350)),
    "piecewise": ({"boundaries": [10.0, 20.0, 40.0],
                   "values": [1.0, 0.5, 0.25, 0.125]},
                  (0, 1, 9, 10, 11, 20, 39, 40, 1000)),
    "cosine": ({"learning_rate": 0.1, "step_each_epoch": 10, "epochs": 5},
               (0, 1, 9, 10, 11, 49, 50, 120)),
    "linear_warmup": ({"warmup_steps": 20, "start_lr": 0.0, "end_lr": 0.1,
                       "base_lr": 0.05}, (0, 1, 19, 20, 21, 400)),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_lr_schedule_matches_reference(case):
    attrs, steps = SCHEDULES[case]
    attrs = dict(attrs, schedule=case.split("[")[0])
    for step in steps:
        ins = {"Step": np.array([step], np.float32)}
        got, want = _run_both("lr_schedule", ins, attrs)
        _compare(f"{case}@{step}", got["Out"][0], want["Out"][0], False)


def test_lr_schedule_linear_warmup_over_a_base_schedule():
    """linear_warmup with its base rate from another schedule's output
    tensor (``BaseLR``)."""
    attrs = {"schedule": "linear_warmup", "warmup_steps": 8,
             "start_lr": 0.01, "end_lr": 0.2}
    for step in (0, 3, 8, 9, 60):
        ins = {"Step": np.array([step], np.float32),
               "BaseLR": np.array([0.0625], np.float32)}
        got, want = _run_both("lr_schedule", ins, attrs)
        _compare(f"warmup@{step}", got["Out"][0], want["Out"][0], False)


def test_lr_schedule_host_step_fallback_and_its_raise():
    """Without a Step input the op reads ``__step__``, as the reference
    does; a compiled step passes none, and the op says why it raises."""
    attrs = {"schedule": "noam", "d_model": 64, "warmup_steps": 5,
             "learning_rate": 1.0}
    for step in (0, 4, 30):
        got, want = _run_both("lr_schedule", {}, dict(attrs, __step__=step))
        _compare(f"host@{step}", got["Out"][0], want["Out"][0], False)
    with pytest.raises(RuntimeError, match="compiled step"):
        pt_registry.get("lr_schedule").forward({}, dict(attrs))


def _counter_program(with_step_input=True):
    main, startup = Program(), Program()
    with pt_names.guard(), program_guard(main, startup):
        if with_step_input:
            lr = players.noam_decay(64, 5, learning_rate=1.0)
        else:
            block = main.global_block()
            lr = block.create_var(name="lr", shape=(1,), dtype="float32",
                                  persistable=True)
            block.append_op("lr_schedule", {}, {"Out": [lr]},
                            {"schedule": "noam", "d_model": 64,
                             "warmup_steps": 5, "learning_rate": 1.0},
                            infer_shape=False)
    return main, startup, lr


def test_noam_decay_counter_advances_in_both_executor_paths():
    """layers.noam_decay: a persistable float32 counter from -1, an
    ``increment`` under the LRSched role, then ``lr_schedule``; each run
    reads the next step, op by op and compiled alike."""
    main, startup, lr = _counter_program()
    ops = main.global_block().ops
    assert [o.type for o in ops] == ["increment", "lr_schedule"]
    assert all(o.attrs["op_role"] == OpRole.LRSched for o in ops)
    assert [o.type for o in startup.global_block().ops] == ["fill_constant"]
    counter = main.global_block().var("@LR_DECAY_COUNTER@")
    assert counter.persistable and str(counter.dtype) == "float32"

    def noam(k):
        s = np.float32(k + 1)
        return np.float32(64 ** -0.5) * min(s ** np.float32(-0.5),
                                            s * np.float32(5 ** -1.5))

    for compiled in (False, True):
        exe, scope = Executor(device="cpu"), Scope()
        exe.run(startup, scope=scope)
        got = [float(exe.run(main, fetch_list=[lr], scope=scope,
                             use_compiled=compiled)[0][0])
               for _ in range(8)]
        np.testing.assert_allclose(got, [noam(k) for k in range(8)],
                                   rtol=1e-6)
        assert float(scope.find_var("@LR_DECAY_COUNTER@")[0]) == 7.0


def test_compiled_step_refuses_the_host_step_fallback():
    main, startup, lr = _counter_program(with_step_input=False)
    exe, scope = Executor(device="cpu"), Scope()
    exe.run(main, fetch_list=[lr], scope=scope)     # op by op: __step__
    with pytest.raises(ExecutionError, match="compiled step"):
        exe.run(main, fetch_list=[lr], scope=scope)


def test_numpy_array_initializer_appends_one_assign_value():
    table = np.arange(12, dtype=np.float32).reshape(3, 4) / 7
    main, startup = Program(), Program()
    with pt_names.guard(), program_guard(main, startup):
        w = players.create_parameter(
            [3, 4], "float32", attr=ParamAttr(
                name="table", initializer=NumpyArrayInitializer(table),
                trainable=False))
    op, = startup.global_block().ops
    assert op.type == "assign_value" and op.attrs["shape"] == [3, 4]
    assert op.attrs["dtype"] == "float32"
    scope = Scope()
    Executor(device="cpu").run(startup, scope=scope)
    assert np.array_equal(scope.find_var(w.name).numpy(), table)


def test_a_fetched_persistable_keeps_its_fetched_value():
    """A fetch comes back as a copy. On the CPU a tensor's numpy() is a
    view, and a fetched persistable is the scope's own tensor: the
    optimizer ops update it in place, and so does a compiled step's
    write-back of the learning rate, so a view would change under the
    caller with every later run."""
    from paddle_tpu_torch import optimizer as popt

    main, startup = Program(), Program()
    with pt_names.guard(), program_guard(main, startup):
        x = players.static_data("x", [4, 3])
        w = players.create_parameter([3, 2], "float32", name="w")
        lr = players.noam_decay(64, 5, learning_rate=1.0)
        loss = players.reduce_sum(players.matmul(x, w))
        popt.SGDOptimizer(lr).minimize(loss)
    exe, scope = Executor(device="cpu"), Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((4, 3), np.float32)}
    runs = [exe.run(main, feed=feed, fetch_list=[w, lr], scope=scope)
            for _ in range(3)]
    kept = [[np.array(a, copy=True) for a in r] for r in runs]
    for _ in range(2):
        exe.run(main, feed=feed, fetch_list=[w, lr], scope=scope)
    for r, k in zip(runs, kept):
        assert all(np.array_equal(a, b) for a, b in zip(r, k))
    assert not np.array_equal(runs[0][0], runs[2][0])
    assert runs[0][1][0] < runs[1][1][0] < runs[2][1][0]
