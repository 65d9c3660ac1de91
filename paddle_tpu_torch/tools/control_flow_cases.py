"""The control-flow programs that the CPU tests build in both packages and
chip_smoke's ``control_flow_card`` runs on the card: ``cond`` with a
gradient, identity branches and a branch that would give NaN, a dynamic
and a bounded ``while_loop``, ``static_loop`` with a gradient,
``IfElse``, the rank-table and tensor-array layers, and the
``DynamicRNN`` tanh cell of the reference's ``tests/test_dynamic_rnn.py``.

A builder takes a ``Pkg`` (a package's Program / program_guard /
gradients, its layers, initializers, optimizers, ParamAttr and
unique-name module), so the same calls build the port's program and the
reference's; ``port()`` is the port's. ``FEEDS`` maps a case to its
builder and its feed."""

from __future__ import annotations

import numpy as np


class Pkg:
    """One package's build surface, so a builder runs in either."""

    def __init__(self, mod, layers, init, opt, param_attr, names):
        self.mod, self.L, self.init, self.opt = mod, layers, init, opt
        self.ParamAttr, self.names = param_attr, names



def port():
    """The port's build surface."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import initializer, layers, optimizer
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.param_attr import ParamAttr

    return Pkg(ptt, layers, initializer, optimizer, ParamAttr, unique_name)


def build(pkg, builder):
    main, startup = pkg.mod.Program(), pkg.mod.Program()
    with pkg.names.guard(), pkg.mod.program_guard(main, startup):
        fetch = builder(pkg)
    return main, startup, fetch


# -- the programs ------------------------------------------------------------

def cond_grad(P):
    L = P.L
    x = L.data("x", [4], stop_gradient=False)
    flag = L.data("flag", [1], dtype="bool", append_batch_size=False)
    out = L.cond(flag, lambda: L.scale(x, scale=3.0),
                 lambda: L.scale(x, scale=0.5))
    loss = L.mean(out)
    g, = P.mod.gradients([loss], [x])
    return [out, g]


def cond_identity(P):
    L = P.L
    x = L.data("x", [2])
    y = L.data("y", [2])
    flag = L.data("flag", [1], dtype="bool", append_batch_size=False)
    return [L.cond(flag, lambda: x, lambda: y),
            L.cond(flag, lambda: L.cast(flag, "float32"),
                   lambda: L.cast(flag, "float32") + 1.0)]


def cond_nan_branch(P):
    """The true branch takes sqrt and log of x, NaN where x < 0; the
    predicate is x > 0, so for a negative x only the false branch runs."""
    L = P.L
    x = L.data("x", [1], append_batch_size=False, stop_gradient=False)
    zero = L.fill_constant([1], "float32", 0.0)
    pos = L.greater_than(x, zero)
    out = L.cond(pos, lambda: L.sqrt(x) + L.log(x),
                 lambda: L.scale(x, scale=-2.0))
    g, = P.mod.gradients([out], [x])
    return [out, g]


def while_dynamic(P):
    L = P.L
    i = L.fill_constant([1], "int32", 0)
    acc = L.fill_constant([1], "float32", 0.0)
    limit = L.data("limit", [1], dtype="int32", append_batch_size=False)

    def c(i, acc):
        return L.less_than(i, limit)

    def b(i, acc):
        return L.increment(i, 1.0), acc + 2.0

    return list(L.while_loop(c, b, [i, acc]))


def while_bounded(P, max_iters=8):
    """x doubled while its sum stays below ``limit``: a dynamic trip count
    under a bound of ``max_iters``, differentiated."""
    L = P.L
    x = L.data("x", [3], stop_gradient=False)
    limit = L.data("limit", [1], append_batch_size=False)

    def c(v):
        return L.less_than(L.reduce_sum(v), limit)

    def b(v):
        return [L.scale(v, scale=2.0)]

    out, = L.while_loop(c, b, [x], grad_max_iters=max_iters)
    g, = P.mod.gradients([L.reduce_sum(out)], [x])
    return [out, g]


def static_loop_grad(P):
    L = P.L
    x = L.data("x", [3], stop_gradient=True)
    w = L.create_parameter([1], "float32", name="w",
                           default_initializer=P.init.Constant(1.5))

    def body(i, acc):
        return L.elementwise_mul(acc, w, axis=-1)

    out, = L.static_loop(3, body, [x])
    g, = P.mod.gradients([L.reduce_sum(out)], [w])
    return [out, g]


def if_else(P):
    L = P.L
    xv = L.static_data("x", [4, 3], "float32")
    mk = L.static_data("mk", [4, 1], "float32")
    ie = L.IfElse(mk)
    with ie.true_block():
        ie.output(ie.input(xv) * 2.0)
    with ie.false_block():
        ie.output(ie.input(xv) - 1.0)
    out, = ie()
    return [out]


def rank_table(P):
    L = P.L
    x = L.static_data("seq", [3, 4, 2], "float32")
    ln = L.static_data("ln", [3], "int64")
    table = L.lod_rank_table(ln)
    arr = L.lod_tensor_to_array(x, table)
    back = L.array_to_lod_tensor(arr, table)
    mem = L.static_data("mem", [3, 2], "float32")
    i = L.fill_constant([1], "int64", 2)
    shrunk = L.shrink_memory(mem, i, table)
    step = L.array_read(arr, i)
    written = L.array_write(L.scale(step, scale=2.0), i, arr)
    return [table[0], table[1], arr, back, shrunk, step, written]


def dynamic_rnn(P, S=6, D=3, H=5):
    """tests/test_dynamic_rnn.py's cell: tanh(fc([x_t, h])) with memories
    frozen past each length, trained by SGD; S steps of D inputs, H
    hidden (its widths by default)."""
    L = P.L
    x = L.data("x", [S, D], stop_gradient=True)
    ln = L.data("len", [], dtype="int64", stop_gradient=True)
    label = L.data("label", [H], stop_gradient=True)
    drnn = L.DynamicRNN()
    with drnn.block():
        w = drnn.step_input(x, length=ln)
        prev = drnn.memory(shape=[H])
        inp = L.concat([w, prev], axis=1)
        h = L.fc(inp, H, act="tanh",
                 param_attr=P.ParamAttr(name="rnn_w",
                                        initializer=P.init.Xavier(seed=3)),
                 bias_attr=P.ParamAttr(name="rnn_b"))
        drnn.update_memory(prev, h)
        drnn.output(h)
    seq_out = drnn()
    final = drnn.final_memories()[0]
    diff = final - label
    loss = L.mean(diff * diff)
    P.opt.SGDOptimizer(0.1).minimize(loss)
    return [seq_out, final, loss]


R = np.random.RandomState(0)
FEEDS = {
    "cond_grad[true]": (cond_grad, {"x": np.ones((2, 4), np.float32),
                                    "flag": np.array([True])}),
    "cond_grad[false]": (cond_grad, {"x": R.randn(2, 4).astype(np.float32),
                                     "flag": np.array([False])}),
    "cond_identity[false]": (cond_identity, {
        "x": np.ones((1, 2), np.float32), "y": 2 * np.ones((1, 2),
                                                        np.float32),
        "flag": np.array([False])}),
    "cond_identity[true]": (cond_identity, {
        "x": np.ones((1, 2), np.float32), "y": 2 * np.ones((1, 2),
                                                        np.float32),
        "flag": np.array([True])}),
    "cond_nan_branch[negative]": (cond_nan_branch,
                                  {"x": np.array([-4.0], np.float32)}),
    "cond_nan_branch[positive]": (cond_nan_branch,
                                  {"x": np.array([2.25], np.float32)}),
    "while_dynamic[3]": (while_dynamic, {"limit": np.array([3], np.int32)}),
    "while_dynamic[0]": (while_dynamic, {"limit": np.array([0], np.int32)}),
    "while_bounded[ran]": (while_bounded, {
        "x": R.rand(2, 3).astype(np.float32) + 0.1,
        "limit": np.array([20.0], np.float32)}),
    "static_loop_grad": (static_loop_grad,
                         {"x": R.randn(2, 3).astype(np.float32)}),
    "if_else": (if_else, {"x": R.randn(4, 3).astype(np.float32),
                          "mk": np.array([[1], [0], [0], [1]], np.float32)}),
    "rank_table": (rank_table, {
        "seq": R.randn(3, 4, 2).astype(np.float32),
        "ln": np.array([2, 4, 2], np.int64),
        "mem": R.randn(3, 2).astype(np.float32)}),
}
