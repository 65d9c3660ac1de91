"""The 2.0 static namespace of the port (``paddle_tpu_torch.static``) and
``core/compiler.py`` against the reference's, on the CPU.

``static.data`` (the batch dim in the shape, None as -1), ``InputSpec``
(``from_tensor``, ``from_numpy``, ``batch`` / ``unbatch`` in place),
``scope_guard`` and ``global_scope``, ``enable_static`` /
``disable_static``, ``static.save`` / ``static.load`` across the
packages; a ``CompiledProgram`` with a ``BuildStrategy`` and an
``ExecutionStrategy`` through the port's ``Executor.run`` and
``run_steps``, and ``with_data_parallel`` on the one device, each giving
the reference's fetches (within 1e-6: the same fp32 math, summed in
another order); the names that come with ROADMAP A7 and A8 raise
naming their item.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as rpt
import paddle_tpu_torch as tpt
from paddle_tpu import layers as rlayers
from paddle_tpu.core import unique_name as r_names
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.core import unique_name as t_names

TOL = 1e-6


def _program(pkg, layers, names):
    """x [-1, 6] -> fc 5 (relu) -> fc 3 -> softmax cross entropy against
    label, SGD 0.1: (main, startup, loss)."""
    main, startup = pkg.Program(), pkg.Program()
    with names.guard(), pkg.program_guard(main, startup):
        x = pkg.static.data("x", [None, 6])
        y = pkg.static.data("y", [None, 1], "int64")
        h = layers.fc(x, 5, act="relu")
        loss = layers.mean(layers.softmax_with_cross_entropy(
            layers.fc(h, 3), y))
        pkg.optimizer.SGDOptimizer(0.1).minimize(loss)
    return main, startup, loss


def _batches(n=3, b=8):
    r = np.random.RandomState(4)
    return [{"x": r.randn(b, 6).astype(np.float32),
             "y": r.randint(0, 3, (b, 1)).astype(np.int64)}
            for _ in range(n)]


def _ref_run(compiled=None):
    """The reference's losses over three batches, from its startup's
    weights: (losses, the weights it started from)."""
    main, startup, loss = _program(rpt, rlayers, r_names)
    exe, scope = rpt.Executor(rpt.CPUPlace()), rpt.Scope()
    exe.run(startup, scope=scope, use_compiled=False)
    start = {p.name: np.asarray(scope.find_var(p.name))
             for p in main.all_parameters()}
    prog = main if compiled is None else compiled(main)
    losses = [float(np.asarray(exe.run(prog, feed=b, fetch_list=[loss],
                                       scope=scope)[0]).reshape(-1)[0])
              for b in _batches()]
    return losses, start


def _port_exe(start):
    main, startup, loss = _program(tpt, tlayers, t_names)
    exe, scope = tpt.Executor(device="cpu"), tpt.Scope()
    exe.run(startup, scope=scope)
    for name, a in start.items():
        scope.set(name, torch.from_numpy(a.copy()))
    return main, loss, exe, scope


def _compiled(pkg, main):
    """main in a CompiledProgram with a BuildStrategy and an
    ExecutionStrategy whose knobs are moved from their defaults."""
    bs = pkg.static.BuildStrategy()
    bs.fuse_elewise_add_act_ops = False
    bs.memory_optimize = False
    cp = pkg.static.CompiledProgram(main, build_strategy=bs)
    cp._exec_strategy.num_threads = 2
    return cp


def test_compiled_program_with_strategies_gives_the_reference_fetches():
    want, start = _ref_run(lambda main: _compiled(rpt, main))
    main, loss, exe, scope = _port_exe(start)
    cp = _compiled(tpt, main)
    got = [float(exe.run(cp, feed=b, fetch_list=[loss], scope=scope)[0])
           for b in _batches()]
    assert isinstance(cp._exec_strategy, tpt.static.ExecutionStrategy)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert got[-1] < got[0]


def test_compiled_program_through_run_steps():
    """run_steps takes a CompiledProgram as run does: three stacked steps
    give the reference's three run() losses."""
    want, start = _ref_run()
    main, loss, exe, scope = _port_exe(start)
    stacked = {k: np.stack([b[k] for b in _batches()]) for k in ("x", "y")}
    got, = exe.run_steps(tpt.static.CompiledProgram(main), feed=stacked,
                         fetch_list=[loss], scope=scope)
    np.testing.assert_allclose(np.asarray(got).reshape(-1), want, rtol=TOL,
                               atol=TOL)


def test_with_data_parallel_on_one_device_runs_the_program_as_it_is():
    want, start = _ref_run()
    main, loss, exe, scope = _port_exe(start)
    cp = tpt.static.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, places=tpt.static.cpu_places())
    got = [float(exe.run(cp, feed=b, fetch_list=[loss], scope=scope)[0])
           for b in _batches()]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kw", [{"places": ["cpu", "cpu"]},
                                {"mesh": object()}])
def test_with_data_parallel_across_devices_raises_naming_a8(kw):
    with pytest.raises(NotImplementedError, match="A8"):
        tpt.static.CompiledProgram(tpt.Program()).with_data_parallel(**kw)


def _data_vars(pkg, names):
    main = pkg.Program()
    with names.guard(), pkg.program_guard(main, pkg.Program()):
        a = pkg.static.data("a", [None, 784])
        b = pkg.static.data("b", [4, -1, 2], "int64")
    return [(v.name, list(v.shape), str(v.dtype)) for v in (a, b)]


def test_static_data_keeps_the_batch_dim_as_the_reference():
    got, want = _data_vars(tpt, t_names), _data_vars(rpt, r_names)
    assert got == want
    assert got[0][1] == [-1, 784] and got[1][1] == [4, -1, 2]


def _spec(pkg):
    S = pkg.static.InputSpec
    s = S([None, 784], "float32", "x")
    out = [s.shape, s.dtype, s.name]
    s.batch(8)
    out.append(s.shape)
    s.unbatch()
    out.append(s.shape)
    s2 = S.from_numpy(np.zeros((4, 3), np.float32), name="a")
    out += [s2.shape, s2.dtype, s2.name]
    with (pkg.dygraph.guard() if pkg is rpt
          else pkg.dygraph.guard("cpu")):
        s3 = S.from_tensor(pkg.to_tensor(np.zeros((4, 3), np.float32)))
    out += [s3.shape, s3.dtype]
    return out


def test_input_spec_matches_the_reference():
    got, want = _spec(tpt), _spec(rpt)
    assert got == want
    assert got[3] == (8, -1, 784) and got[4] == (-1, 784)
    with pytest.raises(ValueError, match="no dims"):
        tpt.static.InputSpec([]).unbatch()


def test_scope_guard_and_global_scope():
    for pkg in (rpt, tpt):
        outer = pkg.static.global_scope()
        scope = pkg.Scope()
        with pkg.static.scope_guard(scope):
            assert pkg.static.global_scope() is scope
        assert pkg.static.global_scope() is outer
    assert tpt.static.cpu_places() == [torch.device("cpu")]


def test_enable_and_disable_static_switch_dygraph_mode():
    assert not tpt.in_dygraph_mode()
    tpt.static.disable_static("cpu")
    try:
        assert tpt.in_dygraph_mode()
        assert tpt.to_tensor(np.ones(2, np.float32)).place.type == "cpu"
    finally:
        tpt.static.enable_static()
    assert not tpt.in_dygraph_mode()


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_static_save_and_load_across_the_packages(tmp_path, direction):
    """static.save writes the reference's three files; the other
    package's static.load reads every persistable back bit for bit."""
    want, start = _ref_run()
    path = str(tmp_path / "ckpt")
    if direction == "ref_to_port":
        main, _, _ = _program(rpt, rlayers, r_names)
        scope = rpt.Scope()
        for name, a in start.items():
            scope.set(name, a)
        rpt.static.save(main, path, scope=scope)
        pmain, _, _ = _program(tpt, tlayers, t_names)
        pscope = tpt.Scope()
        tpt.static.load(pmain, path, scope=pscope)
        got = {n: pscope.find_var(n).numpy() for n in start}
    else:
        pmain, _, exe, pscope = _port_exe(start)
        tpt.static.save(pmain, path, scope=pscope)
        main, _, _ = _program(rpt, rlayers, r_names)
        scope = rpt.Scope()
        rpt.static.load(main, path, scope=scope)
        got = {n: np.asarray(scope.find_var(n)) for n in start}
    for name, a in start.items():
        np.testing.assert_array_equal(got[name], a)


# the six whose op types are not registered yet (conv2d_transpose,
# group_norm, instance_norm, prelu, case and switch_case are held against
# the reference in tests/test_torch_extra_ops.py)
A7_NAMES = ("conv3d", "conv3d_transpose", "data_norm", "nce", "row_conv",
            "spectral_norm")


@pytest.mark.parametrize("name", A7_NAMES)
def test_static_nn_names_of_a7_raise_naming_it(name):
    """The reference's static.nn has the name; the port's raises until
    the layer comes with the rest of the op registry (ROADMAP A7)."""
    assert callable(getattr(rpt.static.nn, name))
    with pytest.raises(NotImplementedError, match="A7"):
        getattr(tpt.static.nn, name)


def test_static_nn_reexports_what_the_port_has():
    for name in ("batch_norm", "conv2d", "embedding", "fc", "layer_norm",
                 "pool2d", "cond", "static_loop", "while_loop",
                 "bilinear_tensor_product", "crf_decoding",
                 "create_parameter"):
        assert callable(getattr(tpt.static.nn, name)), name
        assert callable(getattr(rpt.static.nn, name)), name
