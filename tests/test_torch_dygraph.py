"""The imperative mode of the port against the reference's, eagerly on
the CPU: VarBase (creation dtypes, operators, methods and their
gradients), the tracer (``trace_op``, ``trace_fn``, ``run_backward``,
``grad``), ``Layer`` (state dicts, hooks, modes, the static build of
the same Layers), ``save_dygraph`` / ``load_dygraph`` across the two
packages, ``amp.auto_cast`` and ``GradScaler``, and the 2.0 tensor
functions.

Tolerance: 1e-6 relative and absolute for elementwise results and
gradients, 1e-5 for reductions and products, bf16 results within 1e-2;
integer results and dtypes exactly.
"""

import numpy as np
import pytest

import paddle_tpu as rpt
import paddle_tpu_torch as tpt
from paddle_tpu_torch.core.ir import in_dygraph_mode

R = np.random.RandomState(0)
A = R.randn(3, 4).astype(np.float32)
B = R.randn(3, 4).astype(np.float32)
M = R.randn(4, 2).astype(np.float32)
P = (R.rand(3, 4) + 0.5).astype(np.float32)
I = R.randint(-3, 4, (3, 4)).astype(np.int64)


def guard(pkg):
    return pkg.dygraph.guard() if pkg is rpt else pkg.dygraph.guard("cpu")


def vb(pkg, a, grad=None):
    """A VarBase of ``a`` that needs a gradient when it is float."""
    if grad is None:
        grad = np.issubdtype(np.asarray(a).dtype, np.floating)
    return pkg.dygraph.VarBase(np.asarray(a), stop_gradient=not grad)


def close(got, want, tol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   equal_nan=True)
    else:
        np.testing.assert_array_equal(got, want)


# name -> (fn(pkg, *vbs) -> VarBase, inputs, tol)
VAR_OPS = {
    "add": (lambda P, x, y: x + y, [A, B], 1e-6),
    "radd_scalar": (lambda P, x: 2.5 + x, [A], 1e-6),
    "sub": (lambda P, x, y: x - y, [A, B], 1e-6),
    "rsub": (lambda P, x: 1.0 - x, [A], 1e-6),
    "mul": (lambda P, x, y: x * y, [A, B], 1e-6),
    "int_times_half": (lambda P, x: x * 0.5, [I], 1e-6),
    "int_plus_int": (lambda P, x: x + 2, [I], 0),
    "div": (lambda P, x, y: x / y, [A, P], 1e-6),
    "rdiv": (lambda P, x: 2.0 / x, [P], 1e-6),
    "int_div": (lambda P, x: x / 2, [I], 1e-6),
    "pow": (lambda P, x: x ** 2.0, [P], 1e-6),
    "matmul": (lambda P, x, y: x @ y, [A, M], 1e-5),
    "neg": (lambda P, x: -x, [A], 1e-6),
    "lt": (lambda P, x, y: x < y, [A, B], 0),
    "le_scalar": (lambda P, x: x <= 0.0, [A], 0),
    "gt_int_half": (lambda P, x: x > 0.5, [I], 0),
    "ge": (lambda P, x, y: x >= y, [A, B], 0),
    "eq": (lambda P, x: x == 1, [I], 0),
    "ne": (lambda P, x, y: x != y, [A, A], 0),
    "getitem_slice": (lambda P, x: x[1:, ::2], [A], 1e-6),
    "getitem_int_col": (lambda P, x: x[:, 0], [A], 1e-6),
    "getitem_index_array": (lambda P, x: x[np.array([2, 0, 2])], [A], 1e-6),
    "sum_all": (lambda P, x: x.sum(), [A], 1e-5),
    "sum_axis_keep": (lambda P, x: x.sum(axis=1, keepdim=True), [A], 1e-5),
    "sum_int": (lambda P, x: x.sum(axis=0), [I], 0),
    "mean": (lambda P, x: x.mean(axis=0), [A], 1e-5),
    "mean_int": (lambda P, x: x.mean(), [I], 1e-6),
    "max_axis": (lambda P, x: x.max(axis=1), [A], 1e-6),
    "min_all": (lambda P, x: x.min(), [A], 1e-6),
    "norm": (lambda P, x: x.norm(), [A], 1e-5),
    "argmax": (lambda P, x: x.argmax(axis=0), [A], 0),
    "exp": (lambda P, x: x.exp(), [A], 1e-6),
    "log": (lambda P, x: x.log(), [P], 1e-6),
    "sqrt": (lambda P, x: x.sqrt(), [P], 1e-6),
    "abs": (lambda P, x: x.abs(), [A], 1e-6),
    "tanh": (lambda P, x: x.tanh(), [A], 1e-6),
    "astype_int64": (lambda P, x: x.astype("int64"), [A], 0),
    "astype_f64_grad": (lambda P, x: x.astype("float64") * 2.0, [A], 1e-6),
    "reshape": (lambda P, x: x.reshape([2, 6]), [A], 1e-6),
    "transpose": (lambda P, x: x.transpose([1, 0]), [A], 1e-6),
    "flatten": (lambda P, x: x.flatten(), [A], 1e-6),
    "squeeze_unsqueeze": (lambda P, x: x.unsqueeze([0, 2]).squeeze(0),
                          [A], 1e-6),
    "clone": (lambda P, x: x.clone() * 3.0, [A], 1e-6),
    "detach": (lambda P, x: x.detach() * x, [A], 1e-6),
    "chain": (lambda P, x, y: ((x * y + x) / (y.abs() + 1.0)).sum(),
              [A, B], 1e-5),
}


def _run_var_op(pkg, name):
    fn, inputs, _ = VAR_OPS[name]
    with guard(pkg):
        xs = [vb(pkg, a) for a in inputs]
        out = fn(pkg, *xs)
        res = out.numpy()
        if not out.stop_gradient:
            cot = np.asarray(np.random.RandomState(1).randn(*res.shape),
                             np.float32)
            (out * pkg.dygraph.VarBase(cot)).sum().backward()
        return res, [x.gradient() for x in xs], out.stop_gradient


@pytest.mark.parametrize("name", sorted(VAR_OPS))
def test_varbase_op_and_gradient_match_the_reference(name):
    tol = VAR_OPS[name][2]
    want, wgrads, wstop = _run_var_op(rpt, name)
    got, ggrads, gstop = _run_var_op(tpt, name)
    close(got, want, tol)
    assert gstop == wstop
    for g, w in zip(ggrads, wgrads):
        if w is None:
            assert g is None
        else:
            close(g, w, max(tol, 1e-6))


def test_creation_narrows_64_bit_types_as_the_reference_does():
    """float64 -> float32 and int64 -> int32 on creation, in both (the
    port's executor narrows its feeds the same way); a bool stays
    bool."""
    for pkg in (rpt, tpt):
        with guard(pkg):
            assert pkg.dygraph.VarBase(np.zeros(2)).dtype == np.float32
            assert pkg.dygraph.VarBase(np.arange(3)).dtype == np.int32
            assert pkg.dygraph.VarBase(np.ones(2, bool)).dtype == np.bool_
            assert pkg.to_tensor([1.5, 2.0]).dtype == np.float32
            v = pkg.dygraph.to_variable(np.arange(4).reshape(2, 2))
            assert v.shape == [2, 2] and v.ndim == 2 and len(v) == 2
            assert v.stop_gradient
            assert float(pkg.dygraph.VarBase(np.array([2.5]))) == 2.5
            assert int(pkg.dygraph.VarBase(np.array([3]))) == 3
            with pytest.raises(ValueError):
                bool(pkg.dygraph.VarBase(np.zeros(2)))


def _accumulate(pkg):
    with guard(pkg):
        x = vb(pkg, A)
        (x * 2.0).sum().backward()
        (x * x).sum().backward()
        g1 = x.gradient()
        y = (x * 3.0).sum()
        y.backward()
        y.backward()            # freed: a second call does nothing
        g2 = x.gradient()
        z = (x * x * x).sum()
        z.backward(retain_graph=True)
        z.backward()            # retained: accumulates again
        g3 = x.gradient()
        x.clear_gradient()
        assert x.gradient() is None
        shared = x * x
        a, b = shared.sum(), (shared * 2.0).sum()
        a.backward()
        with pytest.raises(RuntimeError):
            b.backward()        # through the part a's backward freed
        return g1, g2, g3


def test_gradients_accumulate_and_free_as_in_the_reference():
    for w, g in zip(_accumulate(rpt), _accumulate(tpt)):
        close(g, w, 1e-5)


def _stops(pkg):
    with guard(pkg):
        x, c = vb(pkg, A), vb(pkg, B, grad=False)
        lbl = vb(pkg, (B > 0).astype(np.float32))
        with pkg.dygraph.no_grad():
            y = x * x
        assert y.stop_gradient and y._grad_node is None
        out = pkg.dygraph.trace_op(
            "sigmoid_cross_entropy_with_logits", {"X": x, "Label": lbl},
            {})["Out"][0]
        (out.sum() + (x * c).sum()).backward()
        # a cut in the middle: later ops see a leaf
        h = x * 2.0
        h.stop_gradient = True
        (h * x).sum().backward()
        return x.gradient(), c.gradient(), lbl.gradient()


def test_stop_gradient_no_grad_and_non_diff_slots():
    """A leaf that stops gradients gets none, ``no_grad`` records
    nothing, an op's non_diff_inputs slot (the Label of
    sigmoid_cross_entropy_with_logits) gets none even when it needs one,
    and a result marked stop_gradient cuts the graph there."""
    want, got = _stops(rpt), _stops(tpt)
    close(got[0], want[0], 1e-6)
    assert want[1] is None and got[1] is None
    assert want[2] is None and got[2] is None


def _grads(pkg, create_graph=False):
    with guard(pkg):
        x, y = vb(pkg, A), vb(pkg, B)
        u = vb(pkg, M)
        out = (x * x * y).sum()
        gx, gy = pkg.dygraph.grad([out], [x, y], retain_graph=True)
        seed = vb(pkg, np.full((3, 4), 0.5, np.float32), grad=False)
        (gv,) = pkg.dygraph.grad([x * y], [x], grad_outputs=[seed],
                                 retain_graph=True)
        with pytest.raises(RuntimeError):
            pkg.dygraph.grad([out], [u], retain_graph=True)
        none = pkg.dygraph.grad([out], [x, u], allow_unused=True)
        assert x.gradient() is None   # .grad untouched
        return gx.numpy(), gy.numpy(), gv.numpy(), none[0].numpy(), none[1]


def test_grad_matches_the_reference():
    want, got = _grads(rpt), _grads(tpt)
    for w, g in zip(want[:4], got[:4]):
        close(g, w, 1e-5)
    assert want[4] is None and got[4] is None


def test_grad_create_graph_differs_from_the_reference_as_stated():
    """The reference's tape raises NotImplementedError for
    create_graph=True; the port's autograd gives the gradient's own
    graph: d/dx of d(x^3)/dx is 6x."""
    with guard(rpt):
        x = vb(rpt, A)
        with pytest.raises(NotImplementedError):
            rpt.dygraph.grad([(x * x * x).sum()], [x], create_graph=True)
    with guard(tpt):
        x = vb(tpt, A)
        (g,) = tpt.dygraph.grad([(x * x * x).sum()], [x], create_graph=True)
        close(g.numpy(), 3 * A * A, 1e-5)
        g.sum().backward()
        close(x.gradient(), 6 * A, 1e-5)


def test_trace_fn_records_like_trace_op():
    import torch

    with guard(tpt):
        x = vb(tpt, A)
        y = tpt.dygraph.trace_fn(lambda a: torch.sin(a) * 2, x)
        y.sum().backward()
        close(x.gradient(), 2 * np.cos(A), 1e-6)


def test_mode_switch_and_guards():
    assert not in_dygraph_mode() and not tpt.in_dygraph_mode()
    with tpt.dygraph.guard("cpu"):
        assert in_dygraph_mode() and tpt.dygraph.enabled()
        with tpt.dygraph.guard("cpu"):
            assert tpt.dygraph.get_tracer().device.type == "cpu"
        assert in_dygraph_mode()
    assert not in_dygraph_mode()
    tpt.dygraph.enable_dygraph("cpu")
    try:
        assert in_dygraph_mode()
    finally:
        tpt.dygraph.disable_dygraph()
    assert not in_dygraph_mode()


def test_default_place_is_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("the card is there: guard() runs on it")
    with pytest.raises(RuntimeError, match="place='cpu'"):
        with tpt.dygraph.guard():
            pass


@pytest.mark.parametrize("name,item", [("ParallelStrategy", "A8"),
                                       ("prepare_context", "A8"),
                                       ("DataParallel", "A8")])
def test_not_ported_names_raise_naming_their_item(name, item):
    with pytest.raises(NotImplementedError, match=item):
        getattr(tpt.dygraph, name)


# -- Layer ------------------------------------------------------------------

class _Blocks:
    @staticmethod
    def make(P):
        class Net(P.nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc1 = P.nn.Linear(4, 6)
                self.bn = P.nn.BatchNorm1D(6)
                self.drop = P.nn.Dropout(0.5)
                self.fc2 = P.nn.Linear(6, 2)

            def forward(self, x):
                return self.fc2(self.drop(P.nn.functional.relu(
                    self.bn(self.fc1(x)))))

        return Net()


def _layer_run(pkg, state=None):
    with guard(pkg):
        net = _Blocks.make(pkg)
        if state is not None:
            assert net.set_state_dict(state) == ([], [])
        names = [n for n, _ in net.named_sublayers()]
        seen = []
        h1 = net.fc1.register_forward_pre_hook(
            lambda l, ins: (ins[0] * 2.0,))
        h2 = net.fc2.register_forward_post_hook(
            lambda l, ins, out: seen.append(out.shape) or out + 1.0)
        net.eval()
        assert not net.fc1.training and not net.drop.training
        y = net(vb(pkg, A))
        y.sum().backward()
        h1.remove()
        h2.remove()
        y2 = net(vb(pkg, A))
        grads = {n: p.gradient() for n, p in net.named_parameters()}
        net.clear_gradients()
        assert all(p.gradient() is None for p in net.parameters())
        net.train()
        return ({k: v.numpy() for k, v in net.state_dict().items()},
                names, y.numpy(), y2.numpy(), grads, seen,
                len(net.buffers()), len(net.sublayers()))


def test_layer_state_hooks_modes_and_traversal_match_the_reference():
    want = _layer_run(rpt)
    got = _layer_run(tpt, want[0])
    assert list(got[0]) == list(want[0])
    assert got[1] == want[1]
    close(got[2], want[2], 1e-5)
    close(got[3], want[3], 1e-5)
    assert sorted(got[4]) == sorted(want[4])
    for k in want[4]:
        close(got[4][k], want[4][k], 1e-5)
    assert got[5] == want[5] and got[6:] == want[6:]


def test_set_state_dict_reports_and_rejects():
    with guard(tpt):
        net = tpt.nn.Linear(2, 3)
        missing, unexpected = net.set_state_dict(
            {"weight": np.ones((2, 3), np.float32), "extra": np.zeros(1)})
        assert missing == ["bias"] and unexpected == ["extra"]
        np.testing.assert_array_equal(net.weight.numpy(), np.ones((2, 3)))
        with pytest.raises(ValueError, match="shape mismatch"):
            net.set_state_dict({"bias": np.zeros(4, np.float32)})


def test_the_same_layers_build_a_static_program():
    """Outside a guard ``create_parameter`` makes static Parameters: the
    port's Layers build the same op types as the reference's, and the
    Executor's run of the program equals the eager run with the same
    weights."""
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope

    def build(P, layers_mod):
        main, startup = P.Program(), P.Program()
        with P.program_guard(main, startup):
            x = layers_mod.data("x", [3, 4], append_batch_size=False)
            net = P.nn.Sequential(P.nn.Linear(4, 5), P.nn.GELU(),
                                  P.nn.LayerNorm(5), P.nn.Linear(5, 2))
            out = net(x)
        return main, startup, net, out

    rmain = build(rpt, rpt.layers)[0]
    main, startup, net, out = build(tpt, L)
    assert [o.type for o in main.global_block().ops] == \
        [o.type for o in rmain.global_block().ops]
    exe, scope = Executor("cpu"), Scope()
    exe.run(startup, scope=scope, use_compiled=False)
    static = exe.run(main, feed={"x": A}, fetch_list=[out], scope=scope)[0]
    state = {k: scope.find_var(p.name).numpy()
             for k, p in net.state_dict().items()}
    with guard(tpt):
        eager = tpt.nn.Sequential(tpt.nn.Linear(4, 5), tpt.nn.GELU(),
                                  tpt.nn.LayerNorm(5), tpt.nn.Linear(5, 2))
        eager.set_state_dict(state)
        close(eager(vb(tpt, A)).numpy(), static, 1e-5)


# -- save / load across the packages -----------------------------------------

def test_save_and_load_dygraph_across_the_packages(tmp_path):
    with guard(rpt):
        rnet = rpt.nn.Linear(3, 2)
        rpt.dygraph.save_dygraph(rnet.state_dict(), str(tmp_path / "ref"))
        rstate = {k: v.numpy() for k, v in rnet.state_dict().items()}
    params, opt = tpt.dygraph.load_dygraph(str(tmp_path / "ref"))
    assert opt is None and sorted(params) == sorted(rstate)
    with guard(tpt):
        pnet = tpt.nn.Linear(3, 2)
        pnet.set_state_dict(params)
        for k, v in pnet.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), rstate[k])
        sgd = tpt.optimizer.Adam(0.1, parameters=pnet.parameters())
        pnet(vb(tpt, A[:, :3])).sum().backward()
        sgd.step()
        tpt.dygraph.save_dygraph(pnet.state_dict(), str(tmp_path / "port"))
        tpt.dygraph.save_dygraph(sgd.state_dict(), str(tmp_path / "port"))
        pstate = {k: v.numpy() for k, v in pnet.state_dict().items()}
        popt = sgd.state_dict()
    assert (tmp_path / "port.pdparams").exists()
    assert (tmp_path / "port.pdopt").exists()
    rparams, ropt = rpt.dygraph.load_dygraph(str(tmp_path / "port"))
    for k, v in pstate.items():
        np.testing.assert_array_equal(rparams[k], v)
    assert sorted(ropt) == sorted(popt) and "LR#" in ropt
    for k, v in popt.items():
        np.testing.assert_array_equal(ropt[k], v)


# -- AMP ----------------------------------------------------------------------

def _amp(pkg):
    with guard(pkg):
        x, w = vb(pkg, A), vb(pkg, M)
        with pkg.amp.auto_cast():
            mm = pkg.nn.functional.linear(x, w)       # white list: bf16
            sm = pkg.nn.functional.softmax(mm)        # black list: fp32
            lin = pkg.nn.functional.linear(x, w, vb(pkg, M[0]))
        (sm.sum() + lin.sum()).backward()
        return ([t.dtype.name for t in (mm, sm, lin)],
                mm.numpy().astype(np.float32), sm.numpy(), lin.numpy(),
                x.gradient(), w.gradient())


def test_auto_cast_casts_as_the_reference_does():
    want, got = _amp(rpt), _amp(tpt)
    assert got[0] == want[0] == ["bfloat16", "float32", "float32"]
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=1e-2, atol=1e-2)


def _scaler(pkg, state=None):
    with guard(pkg):
        p = pkg.nn.Linear(2, 1)
        if state is not None:
            p.set_state_dict(state)
        start = {k: v.numpy() for k, v in p.state_dict().items()}
        opt = pkg.optimizer.SGD(0.1, parameters=p.parameters())
        sc = pkg.amp.GradScaler(init_loss_scaling=8.0, incr_every_n_steps=2,
                                decr_every_n_nan_or_inf=1)
        scales = []
        for bad in (False, False, True, False):
            x = vb(pkg, np.array([[np.inf if bad else 1.0, 2.0]],
                                 np.float32), grad=False)
            loss = p(x).sum()
            sc.scale(loss).backward()
            sc.step(opt)
            sc.update()
            opt.clear_grad()
            scales.append(sc.get_loss_scaling())
        return scales, {k: v.numpy() for k, v in p.state_dict().items()}, \
            start


def test_grad_scaler_matches_the_reference():
    want = _scaler(rpt)
    got = _scaler(tpt, want[2])
    assert got[0] == want[0] == [8.0, 16.0, 8.0, 8.0]
    for k in want[1]:
        close(got[1][k], want[1][k], 1e-6)


# -- the 2.0 tensor functions --------------------------------------------------

TENSOR_FNS = {
    "ones": (lambda P: P.tensor.ones([2, 3], "int32"), []),
    "zeros_like": (lambda P, x: P.tensor.zeros_like(x), [A]),
    "full_like": (lambda P, x: P.tensor.full_like(x, 2.5), [A]),
    "arange": (lambda P: P.tensor.arange(1, 7, 2), []),
    "arange_float": (lambda P: P.tensor.arange(0.5, 2.0, 0.5), []),
    "linspace": (lambda P: P.tensor.linspace(-1.0, 2.0, 7), []),
    "eye": (lambda P: P.tensor.eye(3, 4), []),
    "add": (lambda P, x, y: P.tensor.add(x, y), [A, B]),
    "divide": (lambda P, x, y: P.tensor.divide(x, y), [A, P]),
    "pow_scalar": (lambda P, x: P.tensor.pow(x, 3.0), [A]),
    "maximum": (lambda P, x, y: P.tensor.maximum(x, y), [A, B]),
    "matmul_t": (lambda P, x, y: P.tensor.matmul(x, y, transpose_y=True),
                 [A, B]),
    "sin": (lambda P, x: P.tensor.sin(x), [A]),
    "rsqrt": (lambda P, x: P.tensor.rsqrt(x), [P]),
    "erf": (lambda P, x: P.tensor.erf(x), [A]),
    "clip": (lambda P, x: P.tensor.clip(x, -0.5, 0.5), [A]),
    "cast": (lambda P, x: P.tensor.cast(x, "int32"), [A * 3]),
    "scale": (lambda P, x: P.tensor.scale(x, 2.0, 1.0), [A]),
    "sum_axis": (lambda P, x: P.tensor.sum(x, axis=1, keepdim=True), [A]),
    "prod": (lambda P, x: P.tensor.prod(x, axis=0), [A]),
    "argmax_flat": (lambda P, x: P.tensor.argmax(x), [A]),
    "argmin_axis": (lambda P, x: P.tensor.argmin(x, axis=1), [A]),
    "cumsum": (lambda P, x: P.tensor.cumsum(x, axis=0), [A]),
    "reshape": (lambda P, x: P.tensor.reshape(x, [4, 3]), [A]),
    "transpose": (lambda P, x: P.tensor.transpose(x, [1, 0]), [A]),
    "squeeze": (lambda P, x: P.tensor.squeeze(P.tensor.unsqueeze(x, 1), 1),
                [A]),
    "concat": (lambda P, x, y: P.tensor.concat([x, y], axis=1), [A, B]),
    "stack": (lambda P, x, y: P.tensor.stack([x, y], axis=0), [A, B]),
    "split": (lambda P, x: P.tensor.split(x, [1, 3], axis=1)[1], [A]),
    "tile": (lambda P, x: P.tensor.tile(x, [2, 1]), [A]),
    "flip": (lambda P, x: P.tensor.flip(x, [0, 1]), [A]),
    "roll": (lambda P, x: P.tensor.roll(x, 2), [A]),
    "roll_axis": (lambda P, x: P.tensor.roll(x, [-1], [1]), [A]),
    "gather": (lambda P, x: P.tensor.gather(
        x, P.dygraph.VarBase(np.array([2, 0]))), [A]),
    "index_select": (lambda P, x: P.tensor.index_select(
        x, P.dygraph.VarBase(np.array([3, 1, 1])), axis=1), [A]),
    "where": (lambda P, x, y: P.tensor.where(x > y, x, y), [A, B]),
    "topk_axis0": (lambda P, x: P.tensor.topk(x, 2, axis=0)[0], [A]),
    "topk_indices": (lambda P, x: P.tensor.topk(x, 2)[1], [A]),
    "argsort_desc": (lambda P, x: P.tensor.argsort(x, descending=True), [A]),
    "tril": (lambda P, x: P.tensor.tril(x, 1), [A]),
    "triu": (lambda P, x: P.tensor.triu(x), [A]),
    "one_hot": (lambda P, x: P.tensor.one_hot(x, 4),
                [np.array([0, 3, 1])]),
    "equal": (lambda P, x, y: P.tensor.equal(x, y), [A, A]),
    "masked_select_y": (lambda P, x: P.tensor.masked_select(x, x > 0)[0],
                        [A]),
    "masked_select_count": (lambda P, x: P.tensor.masked_select(
        x, x > 0)[1], [A]),
}


def _tensor_fn(pkg, name):
    fn, inputs = TENSOR_FNS[name]
    with guard(pkg):
        xs = [vb(pkg, a) for a in inputs]
        out = fn(pkg, *xs)
        res = out.numpy()
        if not out.stop_gradient:
            out.sum().backward()
        return res, [x.gradient() for x in xs]


@pytest.mark.parametrize("name", sorted(TENSOR_FNS))
def test_tensor_function_matches_the_reference(name):
    """Where an output depends on an input only through its shape
    (zeros_like), the reference's tape writes a zero gradient and torch's
    autograd none: the port's None stands for those zeros."""
    want, wg = _tensor_fn(rpt, name)
    got, gg = _tensor_fn(tpt, name)
    close(got, want, 1e-5)
    for g, w in zip(gg, wg):
        if w is None:
            assert g is None
        elif g is None:
            assert not np.any(w)
        else:
            close(g, w, 1e-5)
