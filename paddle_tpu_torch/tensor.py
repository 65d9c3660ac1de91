"""The 2.0 tensor functions (port of ``paddle_tpu/tensor.py`` :17-377).
Each runs its op type through the dual-mode helper ``nn.functional._op``:
the dygraph tracer in dygraph mode, an op appended to the current block
in static mode."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .core.ir import in_dygraph_mode
from .nn.functional import _op, _static_op


def _dtype(d):
    return str(np.dtype(d).name) if not isinstance(d, str) else d


# -- creation ----------------------------------------------------------------

def to_tensor(data, dtype=None, stop_gradient=True):
    if in_dygraph_mode():
        from .dygraph import VarBase

        arr = np.asarray(data, dtype=np.dtype(dtype) if dtype else None)
        return VarBase(arr, stop_gradient=stop_gradient)
    raise RuntimeError("to_tensor is a dygraph API; use layers.data / "
                       "assign in static mode")


def _fill(shape, value, dtype):
    return _op("fill_constant", {},
               {"shape": list(shape), "value": float(value),
                "dtype": _dtype(dtype)})


def ones(shape, dtype="float32"):
    return _fill(shape, 1.0, dtype)


def zeros(shape, dtype="float32"):
    return _fill(shape, 0.0, dtype)


def full(shape, fill_value, dtype="float32"):
    return _fill(shape, fill_value, dtype)


def ones_like(x, dtype=None):
    return _op("fill_any_like", {"X": [x]},
               {"value": 1.0, **({"dtype": _dtype(dtype)} if dtype else {})})


def zeros_like(x, dtype=None):
    return _op("fill_any_like", {"X": [x]},
               {"value": 0.0, **({"dtype": _dtype(dtype)} if dtype else {})})


def full_like(x, fill_value, dtype=None):
    return _op("fill_any_like", {"X": [x]},
               {"value": float(fill_value),
                **({"dtype": _dtype(dtype)} if dtype else {})})


def arange(start, end=None, step=1, dtype=None):
    if end is None:
        start, end = 0, start
    if dtype is None:
        # paddle semantics: float if any arg is a float, else int64
        dtype = "float32" if any(isinstance(v, float)
                                 for v in (start, end, step)) else "int64"
    return _op("range", {},
               {"start": start, "end": end, "step": step,
                "dtype": _dtype(dtype)})


def linspace(start, stop, num, dtype="float32"):
    s = full([1], start, dtype)
    e = full([1], stop, dtype)
    return _op("linspace", {"Start": [s], "Stop": [e]}, {"num": int(num)})


def eye(num_rows, num_columns=None, dtype="float32"):
    ncols = -1 if num_columns is None else int(num_columns)
    return _op("eye", {}, {"num_rows": int(num_rows),
                           "num_columns": ncols,
                           "dtype": _dtype(dtype)})


# -- elementwise binary ------------------------------------------------------

def _binary(op_type, x, y):
    return _op(op_type, {"X": [x], "Y": [y]}, {})


def add(x, y):
    return _binary("elementwise_add", x, y)


def subtract(x, y):
    return _binary("elementwise_sub", x, y)


def multiply(x, y):
    return _binary("elementwise_mul", x, y)


def divide(x, y):
    return _binary("elementwise_div", x, y)


def pow(x, y):
    if isinstance(y, (int, float)):
        return _op("pow", {"X": [x]}, {"factor": float(y)})
    return _binary("elementwise_pow", x, y)


def maximum(x, y):
    return _binary("elementwise_max", x, y)


def minimum(x, y):
    return _binary("elementwise_min", x, y)


def matmul(x, y, transpose_x=False, transpose_y=False):
    return _op("matmul_v2", {"X": [x], "Y": [y]},
               {"trans_x": transpose_x, "trans_y": transpose_y})


def bmm(x, y):
    return _op("bmm", {"X": [x], "Y": [y]}, {})


def dot(x, y):
    return _op("dot", {"X": [x], "Y": [y]}, {})


# -- elementwise unary -------------------------------------------------------

def _unary(op_type):
    def fn(x, name=None):
        return _op(op_type, {"X": [x]}, {})

    fn.__name__ = op_type
    return fn


exp = _unary("exp")
log = _unary("log")
sqrt = _unary("sqrt")
rsqrt = _unary("rsqrt")
abs = _unary("abs")
floor = _unary("floor")
ceil = _unary("ceil")
round = _unary("round")
sign = _unary("sign")
sin = _unary("sin")
cos = _unary("cos")
tanh = _unary("tanh")
erf = _unary("erf")
reciprocal = _unary("reciprocal")
square = _unary("square")


def clip(x, min=None, max=None):
    # None bounds pass straight through (float sentinels would promote
    # integer tensors to float)
    return _op("clip", {"X": [x]}, {"min": min, "max": max})


def cast(x, dtype):
    return _op("cast", {"X": [x]}, {"out_dtype": _dtype(dtype)})


def scale(x, scale=1.0, bias=0.0):
    return _op("scale", {"X": [x]}, {"scale": scale, "bias": bias})


# -- reductions --------------------------------------------------------------

def _reduce(op_type, x, axis=None, keepdim=False):
    attrs = {"keep_dim": keepdim, "reduce_all": axis is None}
    if axis is not None:
        attrs["dim"] = [axis] if isinstance(axis, int) else list(axis)
    return _op(op_type, {"X": [x]}, attrs)


def sum(x, axis=None, keepdim=False):
    return _reduce("reduce_sum", x, axis, keepdim)


def mean(x, axis=None, keepdim=False):
    return _reduce("reduce_mean", x, axis, keepdim)


def max(x, axis=None, keepdim=False):
    return _reduce("reduce_max", x, axis, keepdim)


def min(x, axis=None, keepdim=False):
    return _reduce("reduce_min", x, axis, keepdim)


def prod(x, axis=None, keepdim=False):
    return _reduce("reduce_prod", x, axis, keepdim)


def argmax(x, axis=None):
    """axis=None flattens first — paddle.argmax default semantics."""
    if axis is None:
        x = reshape(x, [-1])
        axis = 0
    return _op("arg_max", {"X": [x]}, {"axis": axis})


def argmin(x, axis=None):
    if axis is None:
        x = reshape(x, [-1])
        axis = 0
    return _op("arg_min", {"X": [x]}, {"axis": axis})


def cumsum(x, axis=-1):
    return _op("cumsum", {"X": [x]}, {"axis": axis})


# -- manipulation ------------------------------------------------------------

def reshape(x, shape):
    return _op("reshape2", {"X": [x]}, {"shape": list(shape)})


def transpose(x, perm):
    return _op("transpose2", {"X": [x]}, {"axis": list(perm)})


def squeeze(x, axis=None):
    return _op("squeeze2", {"X": [x]},
               {"axes": [axis] if isinstance(axis, int)
                else list(axis or [])})


def unsqueeze(x, axis):
    return _op("unsqueeze2", {"X": [x]},
               {"axes": [axis] if isinstance(axis, int) else list(axis)})


def concat(xs, axis=0):
    return _op("concat", {"X": list(xs)}, {"axis": axis})


def stack(xs, axis=0):
    return _op("stack", {"X": list(xs)}, {"axis": axis}, out_slot="Y")


def split(x, num_or_sections, axis=0):
    attrs = {"axis": axis}
    if isinstance(num_or_sections, int):
        attrs["num"] = num_or_sections
        n = num_or_sections
    else:
        attrs["sections"] = list(num_or_sections)
        n = len(num_or_sections)
    if in_dygraph_mode():
        from .dygraph.tracer import trace_op

        return trace_op("split", {"X": [x]}, attrs)["Out"]
    from .core import unique_name
    from .core.ir import default_main_program

    block = default_main_program().current_block()
    outs = [block.create_var(name=unique_name.generate("split.out"))
            for _ in range(n)]
    block.append_op("split", {"X": [x]}, {"Out": outs}, attrs)
    return outs


def tile(x, repeat_times):
    return _op("tile", {"X": [x]}, {"repeat_times": list(repeat_times)})


def flip(x, axis):
    return _op("flip", {"X": [x]},
               {"axis": [axis] if isinstance(axis, int) else list(axis)})


def roll(x, shifts, axis=None):
    return _op("roll", {"X": [x]},
               {"shifts": [shifts] if isinstance(shifts, int) else list(shifts),
                "axis": [axis] if isinstance(axis, int) else axis})


def gather(x, index, axis=0):
    return _op("gather", {"X": [x], "Index": [index]}, {"axis": axis})


def index_select(x, index, axis=0):
    return _op("index_select", {"X": [x], "Index": [index]}, {"dim": axis})


def where(condition, x, y):
    return _op("where", {"Condition": [condition], "X": [x], "Y": [y]}, {})


def topk(x, k, axis=-1):
    ndim = len(x.shape)
    last = axis in (-1, ndim - 1)
    if not last:
        # the op takes the last axis: move `axis` there and back
        perm = list(range(ndim))
        perm[axis], perm[-1] = perm[-1], perm[axis]
        x = transpose(x, perm)
    if in_dygraph_mode():
        from .dygraph.tracer import trace_op

        outs = trace_op("top_k_v2", {"X": [x]}, {"k": k})
        vals, idx = outs["Out"][0], outs["Indices"][0]
    else:
        vals, idx = _static_op("top_k_v2", {"X": [x]}, {"k": k},
                               out_slots=("Out", "Indices"))
    if not last:
        vals, idx = transpose(vals, perm), transpose(idx, perm)
    return vals, idx


def argsort(x, axis=-1, descending=False):
    return _op("argsort", {"X": [x]},
               {"axis": axis, "descending": descending}, out_slot="Indices")


def tril(x, diagonal=0):
    return _op("tril_triu", {"X": [x]},
               {"diagonal": diagonal, "lower": True})


def triu(x, diagonal=0):
    return _op("tril_triu", {"X": [x]},
               {"diagonal": diagonal, "lower": False})


def one_hot(x, num_classes):
    return _op("one_hot_v2", {"X": [x]}, {"depth": int(num_classes)})


# -- comparisons -------------------------------------------------------------

def equal(x, y):
    return _binary("equal", x, y)


def not_equal(x, y):
    return _binary("not_equal", x, y)


def less_than(x, y):
    return _binary("less_than", x, y)


def greater_than(x, y):
    return _binary("greater_than", x, y)


def masked_select(x, mask, name=None):
    """reference: python/paddle/tensor/search.py masked_select
    (masked_select_op.cc). Static-shape form returns (values, count):
    values padded to x.size, first `count` slots valid."""
    if in_dygraph_mode():
        from .dygraph.tracer import trace_op

        outs = trace_op("masked_select", {"X": [x], "Mask": [mask]}, {})
        return outs["Y"][0], outs["Count"][0]
    return tuple(_static_op("masked_select", {"X": [x], "Mask": [mask]},
                            {}, out_slots=("Y", "Count")))
