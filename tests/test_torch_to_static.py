"""``@to_static``, ``TracedLayer`` and ``jit.save`` / ``jit.load`` of the
port against the reference's, on the CPU.

The twins of ``tests/test_to_static.py``'s nine cases run through both
packages on the same numpy inputs and weights (the reference Layer's
``state_dict()`` carried into the port's): parity with the eager run, one
trace per signature, a Python branch frozen per trace, training through
the trace, instance isolation, ``TracedLayer`` (also of a ``@to_static``
forward), ``jit.save`` with ``jit.load`` and the refusal of closure ops.
Then: both packages' captured ``Program.to_dict()`` of the MLP, equal
with unique names mapped; a program saved by either package's
``jit.save`` loads in the other's ``jit.load`` with the same outputs; a
2-layer, d_model 64 ``bert_classifier`` under ``@to_static`` trained 3
AdamW steps in both packages; and two faults of the reference the port
copies (ROADMAP queue C): the replay runs no AMP cast, and a dropout
replays the mask of its traced seed at step 0 on every call.

Tolerances: outputs and losses within 1e-5 relative and absolute (fp32
sums in another order), the BERT losses within 2e-5 (two encoder layers
of fp32 GEMMs and softmaxes summed in different orders), masks and
integer results exactly.
"""

import json

import numpy as np
import pytest

import paddle_tpu as rpt
import paddle_tpu_torch as tpt
from paddle_tpu_torch.tools.dygraph_bert import bert_classifier, synthetic_rows

TOL = 1e-5


def guard(pkg):
    return pkg.dygraph.guard() if pkg is rpt else pkg.dygraph.guard("cpu")


def mlp_class(pkg):
    """The reference test's MLP (8 -> 16 -> relu -> 4), forward under
    ``@to_static``, built from ``pkg``."""
    nn, dygraph = pkg.nn, pkg.dygraph

    class MLP(dygraph.Layer):
        def __init__(self):
            super().__init__()
            self.l1 = nn.Linear(8, 16)
            self.l2 = nn.Linear(16, 4)

        @dygraph.to_static
        def forward(self, x):
            h = self.l1(x)
            h = nn.functional.relu(h)
            return self.l2(h)

    return MLP


def _state(net):
    return {k: v.numpy() for k, v in net.state_dict().items()}


def _twin_mlps(seed=0):
    """(reference MLP, port MLP) with the reference's weights in both:
    each must be built inside its package's guard, so this returns the
    state and the builders."""
    with guard(rpt):
        np.random.seed(seed)
        state = _state(mlp_class(rpt)())
    return state


def _port_mlp(state):
    net = mlp_class(tpt)()
    net.set_state_dict(state)
    return net


def _ref_mlp(state):
    net = mlp_class(rpt)()
    net.set_state_dict(state)
    return net


def _translator(pkg, on):
    pkg.dygraph.jit.ProgramTranslator.get_instance().enable(on)


X = np.random.RandomState(0).randn(4, 8).astype(np.float32)


# -- the nine cases of tests/test_to_static.py --------------------------------

def _parity(pkg, state):
    with guard(pkg):
        m = (_ref_mlp if pkg is rpt else _port_mlp)(state)
        x = pkg.dygraph.to_variable(X)
        static_out = m(x).numpy()
        _translator(pkg, False)
        try:
            eager_out = m(x).numpy()
        finally:
            _translator(pkg, True)
    return static_out, eager_out


def test_parity_with_eager():
    state = _twin_mlps()
    r_static, r_eager = _parity(rpt, state)
    p_static, p_eager = _parity(tpt, state)
    np.testing.assert_allclose(p_static, p_eager, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(p_static, r_static, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(p_eager, r_eager, rtol=TOL, atol=TOL)


def _trace_counts(pkg):
    calls = {"n": 0}

    @pkg.dygraph.to_static
    def f(x):
        calls["n"] += 1
        return x * 2.0 + 1.0

    seen = []
    with guard(pkg):
        a = pkg.dygraph.to_variable(np.ones((2, 3), np.float32))
        out = f(a).numpy()
        f(a)
        seen.append(calls["n"])
        f(pkg.dygraph.to_variable(np.ones((5, 3), np.float32)))
        seen.append(calls["n"])
    return seen, out


def test_trace_cached_per_signature():
    want, got = _trace_counts(rpt), _trace_counts(tpt)
    assert got[0] == want[0] == [1, 2]
    np.testing.assert_array_equal(got[1], want[1])


def _frozen_branch(pkg):
    @pkg.dygraph.to_static
    def f(x):
        if x.shape[0] > 3:
            return x * 10.0
        return x * 2.0

    with guard(pkg):
        small = pkg.dygraph.to_variable(np.ones((2, 2), np.float32))
        big = pkg.dygraph.to_variable(np.ones((4, 2), np.float32))
        return f(small).numpy(), f(big).numpy(), len(f._cache)


def test_python_branch_frozen_per_trace():
    want, got = _frozen_branch(rpt), _frozen_branch(tpt)
    np.testing.assert_array_equal(got[0], 2 * np.ones((2, 2)))
    np.testing.assert_array_equal(got[1], 10 * np.ones((4, 2)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _train(pkg, state, steps=5):
    rng = np.random.RandomState(0)
    x, y = rng.randn(8, 8).astype(np.float32), rng.randint(0, 4, (8, 1))
    with guard(pkg):
        m = (_ref_mlp if pkg is rpt else _port_mlp)(state)
        opt = pkg.optimizer.SGDOptimizer(0.1, parameter_list=m.parameters())
        xv = pkg.dygraph.to_variable(x)
        yv = pkg.dygraph.to_variable(y.astype(np.int64))
        losses = []
        for _ in range(steps):
            loss = pkg.nn.functional.softmax_with_cross_entropy(
                m(xv), yv).mean()
            loss.backward()
            opt.minimize(loss)
            m.clear_gradients()
            losses.append(float(loss.numpy().reshape(-1)[0]))
        return losses, _state(m)


def test_training_through_static():
    """The gradients flow through the captured block to the Layer's
    parameters: 5 SGD steps, the losses and the weights after them
    within 1e-5 of the reference's."""
    state = _twin_mlps()
    want, got = _train(rpt, state), _train(tpt, state)
    assert got[0][-1] < got[0][0]
    np.testing.assert_allclose(got[0], want[0], rtol=TOL, atol=TOL)
    for k in want[1]:
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=TOL,
                                   atol=TOL)


def test_jit_save_and_predict(tmp_path):
    state = _twin_mlps()
    x = np.random.RandomState(1).randn(3, 8).astype(np.float32)
    with guard(tpt):
        m = _port_mlp(state)
        want = m(tpt.dygraph.to_variable(x)).numpy()
        tpt.dygraph.jit.save(m, str(tmp_path / "m"))
    got = tpt.dygraph.jit.load(str(tmp_path / "m"), device="cpu")(x)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _closure_refusal(pkg, path):
    @pkg.dygraph.to_static
    def f(x):
        return (x * 2.0).sum()      # .sum(): an ad-hoc closure op

    with guard(pkg):
        out = f(pkg.dygraph.to_variable(np.ones((2, 2), np.float32)))
        with pytest.raises(RuntimeError, match="closure") as e:
            pkg.dygraph.jit.save(f, path)
        types = [op.type for op in f.main_program.global_block().ops]
    return str(e.value), types, out.numpy()


def test_closure_ops_block_export(tmp_path):
    want = _closure_refusal(rpt, str(tmp_path / "r"))
    got = _closure_refusal(tpt, str(tmp_path / "p"))
    assert got[0] == want[0]
    assert got[1] == want[1] == ["__jax_fn__", "__jax_fn__"]
    np.testing.assert_array_equal(got[2], want[2])


def _net_class(pkg):
    class Net(pkg.dygraph.Layer):
        def __init__(self):
            super().__init__()
            self.fc = pkg.nn.Linear(4, 2)

        def forward(self, x):
            return self.fc(x)

    return Net


def _traced(pkg, state, path):
    with guard(pkg):
        net = _net_class(pkg)()
        net.set_state_dict(state)
        x = pkg.dygraph.to_variable(np.ones((2, 4), np.float32))
        out, traced = pkg.dygraph.TracedLayer.trace(net, [x])
        again = traced(x)
        types = [op.type for op in traced.program.global_block().ops]
        traced.save_inference_model(path)
    return out.numpy(), again.numpy(), types


def test_traced_layer(tmp_path):
    with guard(rpt):
        state = _state(_net_class(rpt)())
    want = _traced(rpt, state, str(tmp_path / "r"))
    got = _traced(tpt, state, str(tmp_path / "p"))
    np.testing.assert_allclose(got[0], got[1], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[0], want[0], rtol=TOL, atol=TOL)
    assert got[2] == want[2] and "matmul_v2" in got[2]
    loaded = tpt.dygraph.jit.load(str(tmp_path / "p"), device="cpu")
    np.testing.assert_allclose(loaded(np.ones((2, 4), np.float32)), got[0],
                               rtol=TOL, atol=TOL)


def _isolation(pkg, state):
    with guard(pkg):
        x = pkg.dygraph.to_variable(np.ones((2, 8), np.float32))
        build = _ref_mlp if pkg is rpt else _port_mlp
        m1, m2 = build(state), build(state)
        o1 = m1(x).numpy()
        # m2's parameters made very different, then called through the
        # trace
        for p in m2.parameters():
            p.set_value(np.ones(p.shape, np.float32))
        o2 = m2(x).numpy()
        _translator(pkg, False)
        try:
            e2 = m2(x).numpy()
        finally:
            _translator(pkg, True)
    return o1, o2, e2


def test_instances_do_not_share_trace():
    """Two instances of one Layer class keep a trace each (each its own
    parameters)."""
    state = _twin_mlps()
    want, got = _isolation(rpt, state), _isolation(tpt, state)
    np.testing.assert_allclose(got[1], got[2], rtol=TOL, atol=TOL)
    assert not np.allclose(got[0], got[1])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def _traced_to_static(pkg, state, path):
    with guard(pkg):
        m = (_ref_mlp if pkg is rpt else _port_mlp)(state)
        x = pkg.dygraph.to_variable(np.ones((2, 8), np.float32))
        out, traced = pkg.dygraph.TracedLayer.trace(m, [x])
        types = [op.type for op in traced.program.global_block().ops]
        traced.save_inference_model(path)
    return out.numpy(), types


def test_traced_layer_on_to_static_forward(tmp_path):
    """TracedLayer.trace of a @to_static model reuses its trace
    (exportable), not one opaque closure op."""
    state = _twin_mlps()
    want = _traced_to_static(rpt, state, str(tmp_path / "r"))
    got = _traced_to_static(tpt, state, str(tmp_path / "p"))
    assert "__jax_fn__" not in got[1] and got[1] == want[1]
    loaded = tpt.dygraph.jit.load(str(tmp_path / "p"), device="cpu")
    np.testing.assert_allclose(loaded(np.ones((2, 8), np.float32)), got[0],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[0], want[0], rtol=TOL, atol=TOL)


# -- the captured program, and export across the packages ---------------------

def _canonical(doc):
    """A program's to_dict with every variable name replaced by its index
    in the order the names first appear in the ops' slots, the vars
    sorted by it."""
    names = {}

    def name(n):
        return names.setdefault(n, f"v{len(names)}")

    for blk in doc["blocks"]:
        for op in blk["ops"]:
            for io in ("inputs", "outputs"):
                for slot in sorted(op[io]):
                    for n in op[io][slot]:
                        name(n)
    out = json.loads(json.dumps(doc))
    for blk in out["blocks"]:
        blk["vars"] = sorted((dict(v, name=name(v["name"]))
                              for v in blk["vars"]),
                             key=lambda v: int(v["name"][1:]))
        for op in blk["ops"]:
            for io in ("inputs", "outputs"):
                op[io] = {s: [name(n) for n in ns]
                          for s, ns in op[io].items()}
    return out


def _mlp_program(pkg, state):
    with guard(pkg):
        m = (_ref_mlp if pkg is rpt else _port_mlp)(state)
        m(pkg.dygraph.to_variable(X))
        return m.forward._static_function.main_program.to_dict()


def test_captured_programs_are_equal_with_unique_names_mapped():
    state = _twin_mlps()
    want = _canonical(_mlp_program(rpt, state))
    got = _canonical(_mlp_program(tpt, state))
    assert got == want


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_jit_save_in_one_package_loads_in_the_other(tmp_path, direction):
    """A program saved by either package's jit.save loads in the other's
    jit.load and gives the outputs of the saving package's call."""
    state = _twin_mlps()
    x = np.random.RandomState(2).randn(5, 8).astype(np.float32)
    src, dst = (rpt, tpt) if direction == "ref_to_port" else (tpt, rpt)
    with guard(src):
        m = (_ref_mlp if src is rpt else _port_mlp)(state)
        want = m(src.dygraph.to_variable(x)).numpy()
        src.dygraph.jit.save(m, str(tmp_path / "m"))
    if dst is tpt:
        got = tpt.dygraph.jit.load(str(tmp_path / "m"), device="cpu")(x)
    else:
        got = rpt.dygraph.jit.load(str(tmp_path / "m"))(x)
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL, atol=TOL)


# -- the 2.0 BERT classifier under @to_static --------------------------------

SMALL = dict(vocab=120, max_pos=32, d_model=64, heads=4, ffn=128, layers=2,
             dropout=0.0, classes=2)


def _bert_static(pkg, state, rows, steps=3):
    with guard(pkg):
        np.random.seed(5)
        net = bert_classifier(pkg.nn, **SMALL)
        if state is not None:
            net.set_state_dict(state)
        start = _state(net)
        net.forward = pkg.dygraph.to_static(net.forward)
        opt = pkg.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=net.parameters())
        loss_fn, losses = pkg.nn.CrossEntropyLoss(), []
        b = len(rows[0]) // steps
        for i in range(steps):
            ids, pos, bias, lbl = (pkg.dygraph.to_variable(
                a[i * b:(i + 1) * b]) for a in rows)
            loss = loss_fn(net(ids, pos, bias), lbl)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        return start, losses, _state(net), len(net.forward._cache)


def test_bert_classifier_trains_under_to_static_as_the_reference():
    """2 layers, d_model 64, s32, b4, dropout 0: 3 AdamW steps under
    @to_static from the reference's weights (carried by state_dict), one
    trace for the three calls; losses within 2e-5 and the weights after
    them within 1e-5 of the reference's, but the key projections' biases:
    their gradient is 0 up to rounding (a key bias shifts a query's
    scores alike), and AdamW's g / (sqrt(v) + eps) makes that rounding
    a step of the rate's size in either package."""
    rows = synthetic_rows(12, 32, vocab=SMALL["vocab"], seed=3)
    start, want, want_state, n_ref = _bert_static(rpt, None, rows)
    _, got, got_state, n_port = _bert_static(tpt, start, rows)
    assert n_port == n_ref == 1
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    for k in want_state:
        if k.endswith("k_proj.bias"):
            continue
        np.testing.assert_allclose(got_state[k], want_state[k], rtol=TOL,
                                   atol=TOL, err_msg=k)


# -- two faults of the reference, copied ---------------------------------------

def _amp_replay(pkg, state):
    """An MLP's to_static call under auto_cast, and the same MLP eagerly
    with and without auto_cast."""
    with guard(pkg):
        m = (_ref_mlp if pkg is rpt else _port_mlp)(state)
        x = pkg.dygraph.to_variable(X)
        with pkg.amp.auto_cast():
            first, second = m(x).numpy(), m(x).numpy()
            _translator(pkg, False)
            try:
                eager_amp = m(x).numpy()
            finally:
                _translator(pkg, True)
        _translator(pkg, False)
        try:
            eager_fp32 = m(x).numpy()
        finally:
            _translator(pkg, True)
        prog = m.forward._static_function.main_program.global_block()
        mm_out = [prog.var(op.output("Out")[0]).dtype
                  for op in prog.ops if op.type == "matmul_v2"]
    return first, second, eager_amp, eager_fp32, [str(d) for d in mm_out]


def test_auto_cast_is_traced_but_not_replayed_as_in_the_reference():
    """The reference applies AMP only in trace_op; capture_op records an
    op without its casts and run_program replays with none. So the
    tracing run's matmuls are bf16 (the captured vars say so), while the
    output of every call, the first included, is the fp32 program's:
    equal to the eager fp32 run, unlike the eager auto_cast run. The port
    does the same."""
    state = _twin_mlps()
    for pkg in (rpt, tpt):
        first, second, eager_amp, eager_fp32, mm_dtypes = \
            _amp_replay(pkg, state)
        assert mm_dtypes == ["bfloat16", "bfloat16"], (pkg, mm_dtypes)
        np.testing.assert_allclose(first, eager_fp32, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(first, second)
        assert not np.allclose(first, eager_amp, rtol=1e-6, atol=1e-6)
    want, got = _amp_replay(rpt, state), _amp_replay(tpt, state)
    np.testing.assert_allclose(got[0], want[0], rtol=TOL, atol=TOL)


def _dropout_calls(pkg):
    @pkg.dygraph.to_static
    def f(x):
        return pkg.nn.functional.dropout(x, 0.5)

    x = np.ones((8, 64), np.float32)
    with guard(pkg):
        np.random.seed(7)
        calls = [f(pkg.dygraph.to_variable(x)).numpy() for _ in range(3)]
        np.random.seed(7)
        eager = pkg.nn.functional.dropout(pkg.dygraph.to_variable(x),
                                          0.5).numpy()
    return calls, eager


def test_dropout_replays_its_traced_seed_at_step_0_as_in_the_reference():
    """A captured dropout replays the seed traced into its attrs with
    step 0 folded in, every call: the same mask each call (so to_static
    equals eager only at dropout 0). The eager op drew that seed from
    numpy's RNG without a step, so even the first call's mask differs
    from the eager one of the same seed. The port's masks are the
    reference's bit for bit."""
    want, got = _dropout_calls(rpt), _dropout_calls(tpt)
    for calls, eager in (want, got):
        assert all(np.array_equal(c, calls[0]) for c in calls)
        assert not np.array_equal(calls[0], eager)
    np.testing.assert_array_equal(got[0][0], want[0][0])
    np.testing.assert_array_equal(got[1], want[1])
