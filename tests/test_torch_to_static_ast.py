"""The ``@to_static`` AST rewrite of ``if``, ``while``, ``for`` and
``break`` / ``continue`` in the port against the reference, on the CPU.

The 22 cases of ``tests/test_dygraph_to_static_cf.py``,
``test_dygraph_to_static_loop.py`` and ``test_dygraph_to_static_bc.py``
run through both packages: a tensor-test ``if`` blended by one ``where``
(one trace serves both outcomes, ``elif`` chains, gradients through the
branch taken), a Python test retraced per value, tensor-dependent
``while`` and ``for ... in range`` loops as one bounded ``while_loop``
op (no retrace when the trip count changes, gradients through the trips
that ran, the default bound's warning, a zero-trip trace input, a loop
holding a tensor ``if``), ``break`` and ``continue`` as carried flags,
and the static ``while_loop`` layer with ``grad_max_iters``. Each case
asserts the reference test's values in both packages and the port's
results equal to the reference's. Then the bounded loop's truncation:
a call past ``loop_max_iters`` warns with the same message in both.

The decorated functions are plain module-level functions (the rewrite
needs their source and no closure), wrapped by each package's
``to_static``; ``_vb`` makes a VarBase of the package whose guard is
active.
"""

import warnings

import numpy as np

import paddle_tpu as rpt
import paddle_tpu_torch as tpt
from paddle_tpu_torch.core import ir as t_ir

PKGS = {"ref": rpt, "port": tpt}


def guard(pkg):
    return pkg.dygraph.guard() if pkg is rpt else pkg.dygraph.guard("cpu")


def _vb(a, stop_gradient=True):
    """A VarBase of the package in dygraph mode now."""
    pkg = tpt if t_ir._dygraph_tracer_holder[0] is not None else rpt
    return pkg.dygraph.VarBase(np.asarray(a), stop_gradient=stop_gradient)


def _fresh(pkg):
    from importlib import import_module

    ir = import_module(pkg.__name__ + ".core.ir")
    names = import_module(pkg.__name__ + ".core.unique_name")
    ir._main_program, ir._startup_program = ir.Program(), ir.Program()
    names.switch()


def both(case, *args, **kw):
    """case(pkg, *args, **kw) in each package: {"ref": ..., "port":
    ...}."""
    out = {}
    for k, pkg in PKGS.items():
        _fresh(pkg)
        out[k] = case(pkg, *args, **kw)
    return out


def same(got, want, tol=1e-6):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w, tol)
    elif isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            same(got[k], want[k], tol)
    elif isinstance(want, (np.ndarray, float, np.floating)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=tol, atol=tol)
    else:
        assert got == want, (got, want)


# -- tests/test_dygraph_to_static_cf.py -------------------------------------

def if_blend(x):
    if x.sum() > 0:
        y = x * 2.0
    else:
        y = x - 1.0
    return y


def if_elif_augassign(x):
    acc = x * 0.0
    if x.sum() > 10.0:
        acc = acc + 100.0
    elif x.sum() > 0.0:
        acc = acc + 10.0
    else:
        acc = acc - 1.0
    acc = acc + 0.5
    return acc


def if_python_bool(x, use_double):
    if use_double:
        y = x * 2.0
    else:
        y = x
    return y


def if_grad(x):
    if x.sum() > 0:
        y = x * 3.0
    else:
        y = x * 5.0
    return y.sum()


def _one_trace_both_branches(pkg):
    f = pkg.dygraph.to_static(if_blend)
    with guard(pkg):
        pos = f(_vb(np.ones((3,), np.float32))).numpy()
        neg = f(_vb(-np.ones((3,), np.float32))).numpy()
    return pos, neg, len(f._cache)


def test_one_trace_serves_both_branches():
    r = both(_one_trace_both_branches)
    for pos, neg, n in r.values():
        np.testing.assert_allclose(pos, 2 * np.ones(3), atol=1e-6)
        np.testing.assert_allclose(neg, -2 * np.ones(3), atol=1e-6)
        assert n == 1
    same(r["port"], r["ref"])


def _elif(pkg):
    f = pkg.dygraph.to_static(if_elif_augassign)
    with guard(pkg):
        outs = [f(_vb(np.full((2,), v, np.float32))).numpy()
                for v in (10.0, 1.0, -1.0)]
    return outs, len(f._cache)


def test_elif_chain_and_augassign():
    r = both(_elif)
    for outs, n in r.values():
        for got, want in zip(outs, (100.5, 10.5, -0.5)):
            np.testing.assert_allclose(got, np.full(2, want), atol=1e-6)
        assert n == 1
    same(r["port"], r["ref"])


def _python_bool(pkg):
    f = pkg.dygraph.to_static(if_python_bool)
    with guard(pkg):
        x = _vb(np.ones((2,), np.float32))
        return f(x, True).numpy(), f(x, False).numpy(), len(f._cache)


def test_python_bool_still_retraces_per_value():
    r = both(_python_bool)
    for a, b, n in r.values():
        np.testing.assert_allclose(a, 2 * np.ones(2))
        np.testing.assert_allclose(b, np.ones(2))
        assert n == 2
    same(r["port"], r["ref"])


def _grad_branch(pkg):
    f = pkg.dygraph.to_static(if_grad)
    grads = []
    with guard(pkg):
        for sign in (1.0, -1.0):
            x = _vb(sign * np.ones((3,), np.float32), stop_gradient=False)
            f(x).backward()
            grads.append(np.asarray(x.grad.numpy()))
    return grads


def test_gradients_flow_through_selected_branch():
    r = both(_grad_branch)
    for g3, g5 in r.values():
        np.testing.assert_allclose(g3, np.full(3, 3.0), atol=1e-6)
        np.testing.assert_allclose(g5, np.full(3, 5.0), atol=1e-6)
    same(r["port"], r["ref"])


def _static_while(pkg, bound):
    """x0 [2] while sum(x) < limit: x = x * w (w a parameter, 2.0)."""
    from importlib import import_module

    layers = import_module(pkg.__name__ + ".layers")
    ParamAttr = import_module(pkg.__name__ + ".param_attr").ParamAttr
    Constant = import_module(pkg.__name__ + ".initializer").Constant
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x0 = layers.data("x0", [2], stop_gradient=True)
        if bound:
            w = layers.create_parameter(
                [1], "float32", attr=ParamAttr(
                    name="w", initializer=Constant(2.0)))

            def cond(x):
                return layers.reduce_sum(x) < 30.0

            def body(x):
                return [x * w]

            (xf,) = layers.while_loop(cond, body, [x0], grad_max_iters=8)
            loss = layers.reduce_sum(xf)
            pkg.optimizer.SGDOptimizer(0.0).minimize(loss)
            fetch = [loss, "w@GRAD"]
        else:
            def cond(x):
                return layers.reduce_sum(x) < 100.0

            def body(x):
                return [x * 2.0]

            (xf,) = layers.while_loop(cond, body, [x0])
            fetch = [layers.reduce_sum(xf)]
    feed = {"x0": np.array([1.0, 1.0], np.float32)}
    if pkg is rpt:
        exe, scope = rpt.Executor(rpt.CPUPlace()), rpt.Scope()
        exe.run(startup, scope=scope, use_compiled=False)
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    else:
        exe, scope = tpt.Executor(device="cpu"), tpt.Scope()
        exe.run(startup, scope=scope)
        out = exe.run(main, feed=feed, scope=scope,
                      fetch_list=[f if isinstance(f, str) else f.name
                                  for f in fetch])
    return [np.asarray(o, np.float32).reshape(-1) for o in out]


def test_while_loop_reverse_ad():
    """while x.sum() < 30: x = x * w from [1, 1], w = 2: four trips, out
    2 * w^4 = 32 and d out / d w = 8 w^3 = 64."""
    r = both(_static_while, True)
    for out, grad in r.values():
        np.testing.assert_allclose(out, [32.0], rtol=1e-5)
        np.testing.assert_allclose(grad, [64.0], rtol=1e-4)
    same(r["port"], r["ref"])


def test_forward_only_without_bound():
    r = both(_static_while, False)
    for (out,) in r.values():
        np.testing.assert_allclose(out, [128.0], rtol=1e-6)
    same(r["port"], r["ref"])


# -- tests/test_dygraph_to_static_loop.py -----------------------------------

W_GLOBAL = {}


def scaled_while(x, n):
    i = _vb(np.zeros((), np.int32))
    while i < n:
        x = x * 1.1 + 0.5
        i = i + 1
    return x


def count_while(x, n):
    i = _vb(np.zeros((), np.int32))
    while i < n:
        x = x + 1.0
        i = i + 1
    return x


def for_range_tensor(x, n):
    for i in range(n):
        x = x + 2.0
    return x


def for_range_python(x):
    acc = x * 0.0
    for i in range(3):
        acc = acc + x * (i + 1)
    return acc


def add_global_weight(x, n):
    i = _vb(np.zeros((), np.int32))
    while i < n:
        x = x + W_GLOBAL["w"]
        i = i + 1
    return x


def loop_with_branch(x, n):
    i = _vb(np.zeros((), np.int32))
    while i < n:
        if (i > 0).sum() > 0:
            x = x + 1.0
        else:
            x = x + 10.0
        i = i + 1
    return x


def loop_with_temp(x, n):
    i = _vb(np.zeros((), np.int32))
    while i < n:
        t = x * 2.0
        x = t + 1.0
        i = i + 1
    return x


def _loop(pkg, fn, calls, bound=8):
    """fn under to_static(loop_max_iters=bound), called on each
    (x, n) of ``calls``: the outputs and the number of traces."""
    f = pkg.dygraph.to_static(fn, loop_max_iters=bound)
    with guard(pkg):
        outs = [f(_vb(x), _vb(np.int32(n))).numpy() for x, n in calls]
    return outs, len(f._cache)


def test_runtime_trip_count_no_retrace():
    x = np.ones((3,), np.float32)
    r = both(_loop, scaled_while, [(x, k) for k in (3, 5, 0)])
    for outs, n in r.values():
        for k, got in zip((3, 5, 0), outs):
            want = x.copy()
            for _ in range(k):
                want = want * 1.1 + 0.5
            np.testing.assert_allclose(got, want, rtol=1e-5)
        assert n == 1
    same(r["port"], r["ref"])


def _loop_grads(pkg):
    f = pkg.dygraph.to_static(scaled_while, loop_max_iters=8)
    res = []
    with guard(pkg):
        for k in (2, 4):
            x = _vb(np.full((3,), 2.0, np.float32), stop_gradient=False)
            y = f(x, _vb(np.int32(k)))
            (y * y).sum().backward()
            res.append((y.numpy(), np.asarray(x.grad.numpy())))
    return res


def test_grads_flow_through_active_iterations():
    r = both(_loop_grads)
    for res in r.values():
        for k, (y, g) in zip((2, 4), res):
            np.testing.assert_allclose(g, 2.0 * y * 1.1 ** k, rtol=1e-4)
    same(r["port"], r["ref"], 1e-5)


def _default_bound(pkg):
    f = pkg.dygraph.to_static(count_while)
    with guard(pkg):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            a = f(_vb(np.zeros((2,), np.float32)), _vb(np.int32(3))).numpy()
        b = f(_vb(np.zeros((2,), np.float32)), _vb(np.int32(6))).numpy()
    msgs = [str(m.message) for m in w if "bounded at" in str(m.message)]
    return a, b, msgs


def test_default_bound_warns_and_works():
    r = both(_default_bound)
    for a, b, msgs in r.values():
        np.testing.assert_allclose(a, [3.0, 3.0])
        np.testing.assert_allclose(b, [6.0, 6.0])
        assert msgs
    same(r["port"], r["ref"])


def test_for_range_tensor_stop():
    r = both(_loop, for_range_tensor,
             [(np.zeros((2,), np.float32), k) for k in (1, 4)])
    for outs, n in r.values():
        for k, got in zip((1, 4), outs):
            np.testing.assert_allclose(got, [2.0 * k] * 2)
        assert n == 1
    same(r["port"], r["ref"])


def _python_range(pkg):
    f = pkg.dygraph.to_static(for_range_python)
    with guard(pkg):
        return f(_vb(np.ones((2,), np.float32))).numpy()


def test_python_range_keeps_python_semantics():
    r = both(_python_range)
    for out in r.values():
        np.testing.assert_allclose(out, [6.0, 6.0])
    same(r["port"], r["ref"])


def _global_weight(pkg):
    f = pkg.dygraph.to_static(add_global_weight, loop_max_iters=8)
    with guard(pkg):
        W_GLOBAL["w"] = _vb(np.full((2,), 3.0, np.float32),
                            stop_gradient=False)
        try:
            return f(_vb(np.zeros((2,), np.float32)),
                     _vb(np.int32(4))).numpy()
        finally:
            W_GLOBAL.clear()


def test_loop_reads_global_weight():
    """A tensor read inside the loop body rides along as an Ext input of
    the while_loop op."""
    r = both(_global_weight)
    for out in r.values():
        np.testing.assert_allclose(out, [12.0, 12.0])
    same(r["port"], r["ref"])


def test_loop_containing_tensor_if():
    r = both(_loop, loop_with_branch,
             [(np.zeros((2,), np.float32), 3), (np.zeros((2,), np.float32),
                                                1)])
    for outs, n in r.values():
        np.testing.assert_allclose(outs[0], [12.0, 12.0])
        np.testing.assert_allclose(outs[1], [10.0, 10.0])
        assert n == 1
    same(r["port"], r["ref"])


def test_body_local_temp():
    r = both(_loop, loop_with_temp, [(np.ones((2,), np.float32), 2)])
    for outs, _ in r.values():
        np.testing.assert_allclose(outs[0], [7.0, 7.0])
    same(r["port"], r["ref"])


def test_zero_trip_first_trace():
    r = both(_loop, for_range_tensor,
             [(np.zeros((2,), np.float32), 0), (np.zeros((2,), np.float32),
                                                3)])
    for outs, n in r.values():
        np.testing.assert_allclose(outs[0], [0.0, 0.0])
        np.testing.assert_allclose(outs[1], [6.0, 6.0])
        assert n == 1
    same(r["port"], r["ref"])


# -- tests/test_dygraph_to_static_bc.py -------------------------------------

def f_break(x, n):
    i = np.float32(0.0)            # Python state: promoted at trace
    s = x * 0.0
    while i < n:                   # a tensor-dependent trip count
        s = s + x * (i + 1.0)
        if s.sum() > 50.0:         # a tensor-dependent break
            break
        i = i + 1.0
    return s.sum()


def f_continue(x, n):
    i = x.sum() * 0.0
    s = x.sum() * 0.0
    while i < n:
        i = i + 1.0
        if i < 3.5:                # a tensor test: skip the first 3
            continue
        s = s + i
    return s


def f_for_break(x):
    s = x.sum() * 0.0
    for i in range(10):
        s = s + x.sum()
        if s > 7.5:
            break
    return s + i                    # i frozen at the break step


def g_break_grads(x, n):
    i = x.sum() * 0.0
    s = x.sum() * 0.0
    while i < n:
        s = s + x.sum() * (i + 1.0)
        if i > 1.5:
            break
        i = i + 1.0
    return s


def f_break_in_with(x):
    import contextlib

    s = x.sum() * 0.0
    i = 0
    while i < 5:
        with contextlib.nullcontext():
            if i == 3:
                break
        s = s + x.sum()
        i += 1
    return s


def _scalar(v):
    return float(np.asarray(v.numpy()).reshape(-1)[0])


def _eager_and_static(pkg, fn, args, **kw):
    """fn run eagerly and under to_static on the same inputs."""
    with guard(pkg):
        eager = _scalar(fn(*[pkg.to_tensor(a) for a in args]))
    _fresh(pkg)
    with guard(pkg):
        sfn = pkg.dygraph.to_static(fn, **kw)
        static = _scalar(sfn(*[pkg.to_tensor(a) for a in args]))
    return eager, static


def test_while_tensor_break_matches_eager():
    x = np.ones((2, 2), np.float32)
    for n in (3.0, 20.0):
        r = both(_eager_and_static, f_break, (x, np.float32(n)),
                 loop_max_iters=32)
        for eager, static in r.values():
            assert eager == static, (n, eager, static)
        same(r["port"], r["ref"])


def test_while_tensor_continue_matches_eager():
    r = both(_eager_and_static, f_continue,
             (np.ones((3,), np.float32), np.float32(7.0)), loop_max_iters=16)
    for eager, static in r.values():
        assert eager == static == 22.0      # 4 + 5 + 6 + 7
    same(r["port"], r["ref"])


def test_for_break_matches_eager():
    r = both(_eager_and_static, f_for_break,
             (np.full((2,), 1.5, np.float32),), loop_max_iters=16)
    for eager, static in r.values():
        assert eager == static == 11.0      # 9 + i (= 2)
    same(r["port"], r["ref"])


def _no_retrace(pkg, ns):
    with guard(pkg):
        sfn = pkg.dygraph.to_static(f_break, loop_max_iters=32)
        outs = [_scalar(sfn(pkg.to_tensor(np.ones((2, 2), np.float32)),
                            pkg.to_tensor(np.float32(n)))) for n in ns]
        return outs, len(sfn._cache)


def test_no_retrace_on_trip_count_change():
    r = both(_no_retrace, (3.0, 6.0))
    for (a, b), n in r.values():
        assert n == 1 and a != b
    same(r["port"], r["ref"])


def _break_grads(pkg):
    with guard(pkg):
        x = pkg.to_tensor(np.ones((2,), np.float32), stop_gradient=False)
        sfn = pkg.dygraph.to_static(g_break_grads, loop_max_iters=16)
        sfn(x, pkg.to_tensor(np.float32(10.0))).backward()
        return np.asarray(x.grad.numpy())


def test_break_with_grads():
    """Trips i = 0, 1, 2 run (the break after i = 2's body): s = x.sum()
    * (1 + 2 + 3), so d s / d x = 6."""
    r = both(_break_grads)
    for g in r.values():
        np.testing.assert_allclose(g, np.full((2,), 6.0), rtol=1e-6)
    same(r["port"], r["ref"])


def _break_in_with(pkg):
    with guard(pkg):
        out = pkg.dygraph.to_static(f_break_in_with)(
            pkg.to_tensor(np.ones((2,), np.float32)))
        return _scalar(out)


def test_break_in_with_falls_back_to_python_semantics():
    """break inside `with` (out of the rewriter's reach) keeps Python's
    semantics, and the transform ends."""
    r = both(_break_in_with)
    assert r["port"] == r["ref"] == 6.0     # 3 trips


def test_break_not_hit_at_trace_still_fires_at_runtime():
    """Traced with an input that never breaks (n = 3), then run with one
    that must (n = 20): the flag is a carried tensor although the probe
    never set it."""
    r = both(_no_retrace, (3.0, 20.0))
    for (a, b), _ in r.values():
        assert (a, b) == (24.0, 60.0)
    same(r["port"], r["ref"])


# -- the bounded loop's truncation ---------------------------------------------

def _truncated(pkg):
    f = pkg.dygraph.to_static(count_while, loop_max_iters=4)
    with guard(pkg):
        ok = f(_vb(np.zeros((2,), np.float32)), _vb(np.int32(2))).numpy()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            cut = f(_vb(np.zeros((2,), np.float32)),
                    _vb(np.int32(10))).numpy()
    return ok, cut, [str(m.message) for m in w
                     if "truncated" in str(m.message)]


def test_a_call_past_the_loop_bound_warns_with_the_reference_message():
    """count_while traced with n = 2 under loop_max_iters=4, then called
    with n = 10: the replay stops at 4 trips and warns that the bounded
    scan truncated, with the reference's message, in both packages."""
    r = both(_truncated)
    for ok, cut, msgs in r.values():
        np.testing.assert_allclose(ok, [2.0, 2.0])
        np.testing.assert_allclose(cut, [4.0, 4.0])
        assert len(msgs) == 1 and "truncated at 4 iterations" in msgs[0]
    assert r["port"][2] == r["ref"][2]
    same(r["port"][:2], r["ref"][:2])
