"""VarBase: the eager tensor of imperative (dygraph) mode.

The port of ``paddle_tpu/dygraph/varbase.py``: ``VarBase`` (:27),
``ParamBase`` (:351) and ``to_variable`` (:379). The payload is a
``torch.Tensor`` on the active tracer's device (the card unless the
guard names another); every traced op runs its op type's torch lowering
from the registry, so eager and static modes share one set of lowerings
and kernels.

Autograd is torch's: a VarBase that does not stop gradients holds a
tensor that requires grad (a leaf) or carries the ``grad_fn`` of the op
that made it, and ``backward()`` is ``torch.autograd.backward``, which
accumulates into the leaves' ``.grad`` across calls as the reference's
GradientAccumulator does.

Dtypes on creation follow the port's executor with its feeds
(``core.types.x64_off``): a float64 or int64 array becomes float32 or
int32, as the reference's arrays do with 64-bit types off.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import unique_name
from ..core.types import convert_dtype, to_torch_dtype, x64_off


def _device():
    """The active tracer's device, or the card outside a guard."""
    from ..core.ir import _dygraph_tracer_holder

    tracer = _dygraph_tracer_holder[0]
    if tracer is not None:
        return tracer.device
    from .tracer import resolve_device

    return resolve_device(None)


def as_tensor(value, device=None) -> torch.Tensor:
    """``value`` (a VarBase, tensor, numpy array or Python value) as a
    tensor: numpy and Python values on ``device`` (default the tracer's)
    with 64-bit types narrowed; a tensor on ``device`` if one is named,
    else as it is."""
    if isinstance(value, VarBase):
        value = value._tensor
    if isinstance(value, torch.Tensor):
        return value if device is None else value.to(device)
    arr = np.asarray(value)
    # np.ascontiguousarray would give a 0-d value one dimension: copy
    # with np.array, which keeps the shape
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(arr.view(np.int16), order="C")
                             ).view(torch.bfloat16)
    else:
        if not (arr.flags.c_contiguous and arr.flags.writeable):
            arr = np.array(arr, order="C")
        t = torch.from_numpy(arr)
        t = t.to(x64_off(t.dtype))
    return t.to(device if device is not None else _device())


def _scalar_operand(x: "VarBase", other) -> torch.Tensor:
    """A Python or numpy operand of a binary op, with numpy's promotion
    against x's dtype (an int tensor times 0.5 stays a float), as the
    reference's ``_binary`` builds it; beside a bf16 tensor a Python
    number stays bf16."""
    dev = x._tensor.device
    if np.isscalar(other):
        if x._tensor.dtype == torch.bfloat16:
            return torch.tensor(other, dtype=torch.bfloat16, device=dev)
        dt = np.result_type(np.dtype(x.dtype), other)
        return as_tensor(np.asarray(other, dtype=dt), dev)
    return as_tensor(other, dev)


class VarBase:
    """Eager tensor with autograd metadata (reference: imperative
    layer.h:65 VarBase). ``grad`` is the accumulated gradient of a leaf
    (a VarBase, or None)."""

    __slots__ = ("_tensor", "name", "_stop_gradient", "persistable",
                 "_freed", "__weakref__")

    def __init__(self, value, name: Optional[str] = None,
                 stop_gradient: bool = True, persistable: bool = False):
        from ..core.ir import _dygraph_tracer_holder

        tracer = _dygraph_tracer_holder[0]
        t = as_tensor(value, tracer.device if tracer is not None else None)
        if isinstance(value, (VarBase, torch.Tensor)):
            t = t.detach()
        self._tensor = t
        self.name = name or unique_name.generate("eager_tmp")
        self._stop_gradient = True
        self.persistable = persistable
        self._freed = False
        self.stop_gradient = stop_gradient

    @classmethod
    def _wrap(cls, t: torch.Tensor, name=None) -> "VarBase":
        """A VarBase over an op's output tensor, as it came out (its
        autograd link kept): it stops gradients iff nothing upstream
        needs them."""
        vb = cls.__new__(cls)
        vb._tensor = t
        vb.name = name or unique_name.generate("eager_tmp")
        vb._stop_gradient = not t.requires_grad
        vb.persistable = False
        vb._freed = False
        return vb

    # -- autograd flags ------------------------------------------------------
    @property
    def stop_gradient(self) -> bool:
        return self._stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, value: bool):
        value = bool(value)
        t = self._tensor
        if t.grad_fn is not None:
            if value:
                # a traced result cut off here: later ops see a leaf
                self._tensor = t.detach()
        elif t.is_floating_point() or t.is_complex():
            t.requires_grad_(not value)
        self._stop_gradient = value

    @property
    def _grad_node(self):
        """The autograd node that made this tensor (None for a leaf)."""
        return self._tensor.grad_fn

    @property
    def grad(self) -> Optional["VarBase"]:
        g = self._tensor.grad
        return None if g is None else VarBase._wrap(g, self.name + "@GRAD")

    @grad.setter
    def grad(self, value):
        self._tensor.grad = None if value is None else as_tensor(value)

    # -- metadata ------------------------------------------------------------
    @property
    def shape(self):
        return list(self._tensor.shape)

    @property
    def dtype(self):
        return convert_dtype(self._tensor.dtype)

    @property
    def ndim(self):
        return self._tensor.dim()

    @property
    def place(self):
        return self._tensor.device

    def numpy(self) -> np.ndarray:
        from ..core.executor import _to_numpy

        return _to_numpy(self._tensor)

    # numpy must defer mixed ops to the dunders below
    __array_priority__ = 100

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        arr = self.numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def item(self):
        if self._tensor.numel() != 1:
            raise ValueError(
                f"only one-element tensors can be converted to Python "
                f"scalars; got shape {self.shape}")
        return self._tensor.reshape(-1)[0].item()

    def __len__(self):
        return int(self._tensor.shape[0])

    def __float__(self):
        return float(self.item())

    def __int__(self):
        return int(self.item())

    def __bool__(self):
        if self._tensor.numel() != 1:
            raise ValueError(
                f"the truth value of a tensor with {self._tensor.numel()} "
                f"elements is ambiguous — use .any()/.all() or compare "
                f"reductions")
        from .jit import _capture_stack

        if _capture_stack:
            import warnings

            warnings.warn(
                "bool(tensor) inside a @to_static trace freezes this "
                "branch into the captured program (the if was not "
                "rewritable — e.g. it contains return/break, or the "
                "condition is consumed outside an if). Data-dependent "
                "branches need a rewritable `if` or an explicit "
                "layers.cond.", stacklevel=2)
        return bool(self._tensor.reshape(-1)[0].item())

    # -- autograd ------------------------------------------------------------
    def backward(self, grad=None, retain_graph: bool = False):
        from .tracer import run_backward

        run_backward(self, grad, retain_graph=retain_graph)

    def gradient(self) -> Optional[np.ndarray]:
        g = self.grad
        return None if g is None else g.numpy()

    def clear_gradient(self):
        self._tensor.grad = None

    clear_grad = clear_gradient

    def detach(self) -> "VarBase":
        return VarBase._wrap(self._tensor.detach(), self.name + ".detach")

    def clone(self) -> "VarBase":
        from .tracer import trace_fn

        return trace_fn(lambda x: x + 0, self)

    # -- conversion / reshaping ---------------------------------------------
    def astype(self, dtype) -> "VarBase":
        from .tracer import trace_fn

        dt = x64_off(to_torch_dtype(dtype))
        return trace_fn(lambda x: x.to(dt), self)

    def cast(self, dtype) -> "VarBase":
        return self.astype(dtype)

    def reshape(self, shape) -> "VarBase":
        from .tracer import trace_fn

        shape = tuple(int(s) for s in shape)
        return trace_fn(lambda x: x.reshape(shape), self)

    def transpose(self, perm) -> "VarBase":
        from .tracer import trace_fn

        perm = tuple(int(p) for p in perm)
        return trace_fn(lambda x: x.permute(perm), self)

    def flatten(self) -> "VarBase":
        from .tracer import trace_fn

        return trace_fn(lambda x: x.reshape(-1), self)

    def squeeze(self, axis=None) -> "VarBase":
        from .tracer import trace_fn

        if axis is None:
            return trace_fn(torch.squeeze, self)
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        return trace_fn(lambda x: x.squeeze(axes), self)

    def unsqueeze(self, axis) -> "VarBase":
        from .tracer import trace_fn

        axes = [axis] if isinstance(axis, int) else list(axis)

        def f(x):
            nd = x.dim() + len(axes)
            for a in sorted(a % nd for a in axes):
                x = x.unsqueeze(a)
            return x

        return trace_fn(f, self)

    # -- reductions ----------------------------------------------------------
    def _reduce(self, fn, axis=None, keepdim=False, keep_int=False):
        """fn over ``axis`` (None: every dim), with jnp's result dtypes:
        an integer sum keeps its type (bool gives int32), a mean of
        integers is float32."""
        from .tracer import trace_fn

        def f(x):
            src = x.dtype
            if fn is torch.mean and not (src.is_floating_point
                                         or src.is_complex):
                x = x.to(torch.float32)
            dims = tuple(range(x.dim())) if axis is None else \
                ((axis,) if isinstance(axis, int) else tuple(axis))
            out = fn(x, dim=dims, keepdim=keepdim) if dims else x
            if keep_int and not (src.is_floating_point or src.is_complex):
                out = out.to(torch.int32 if src == torch.bool else src)
            return out

        return trace_fn(f, self)

    def sum(self, axis=None, keepdim=False):
        return self._reduce(torch.sum, axis, keepdim, keep_int=True)

    def mean(self, axis=None, keepdim=False):
        return self._reduce(torch.mean, axis, keepdim)

    def max(self, axis=None, keepdim=False):
        return self._reduce(torch.amax, axis, keepdim)

    def min(self, axis=None, keepdim=False):
        return self._reduce(torch.amin, axis, keepdim)

    def any(self):
        return VarBase._wrap(torch.any(self._tensor.detach()))

    def all(self):
        return VarBase._wrap(torch.all(self._tensor.detach()))

    def norm(self):
        from .tracer import trace_fn

        return trace_fn(lambda x: torch.sqrt(torch.sum(x * x)), self)

    def argmax(self, axis=-1):
        from .tracer import trace_fn

        return trace_fn(lambda x: torch.argmax(x, dim=axis)
                        .to(torch.int32), self)

    def exp(self):
        from .tracer import trace_fn

        return trace_fn(torch.exp, self)

    def log(self):
        from .tracer import trace_fn

        return trace_fn(torch.log, self)

    def sqrt(self):
        from .tracer import trace_fn

        return trace_fn(torch.sqrt, self)

    def abs(self):
        from .tracer import trace_fn

        return trace_fn(torch.abs, self)

    def tanh(self):
        from .tracer import trace_fn

        return trace_fn(torch.tanh, self)

    # -- arithmetic ----------------------------------------------------------
    def _binary(self, other, fn, reverse=False):
        from .tracer import trace_fn

        if not isinstance(other, VarBase):
            other = VarBase._wrap(_scalar_operand(self, other))
        a, b = (other, self) if reverse else (self, other)
        return trace_fn(fn, a, b)

    def __add__(self, other):
        return self._binary(other, torch.add)

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, torch.sub)

    def __rsub__(self, other):
        return self._binary(other, torch.sub, reverse=True)

    def __mul__(self, other):
        return self._binary(other, torch.mul)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, torch.true_divide)

    def __rtruediv__(self, other):
        return self._binary(other, torch.true_divide, reverse=True)

    def __pow__(self, other):
        return self._binary(other, torch.pow)

    def __matmul__(self, other):
        return self._binary(other, torch.matmul)

    def __neg__(self):
        from .tracer import trace_fn

        return trace_fn(torch.neg, self)

    def _cmp(self, other, op_type):
        """Comparisons run their op type through ``trace_op``, as the
        reference's do."""
        from .tracer import trace_op

        o = other if isinstance(other, VarBase) else \
            VarBase._wrap(_scalar_operand(self, other))
        return trace_op(op_type, {"X": self, "Y": o}, {})["Out"][0]

    def __lt__(self, other):
        return self._cmp(other, "less_than")

    def __le__(self, other):
        return self._cmp(other, "less_equal")

    def __gt__(self, other):
        return self._cmp(other, "greater_than")

    def __ge__(self, other):
        return self._cmp(other, "greater_equal")

    def __eq__(self, other):  # elementwise, as the reference's VarBase
        if other is None or not isinstance(
                other, (VarBase, int, float, bool, np.ndarray, list, tuple)):
            return NotImplemented
        return self._cmp(other, "equal")

    def __ne__(self, other):
        if other is None or not isinstance(
                other, (VarBase, int, float, bool, np.ndarray, list, tuple)):
            return NotImplemented
        return self._cmp(other, "not_equal")

    __hash__ = object.__hash__

    def __getitem__(self, idx) -> "VarBase":
        from .tracer import trace_fn

        dev = self._tensor.device

        def conv(i):
            if isinstance(i, VarBase):
                i = i._tensor
            if isinstance(i, np.ndarray):
                i = torch.as_tensor(i, device=dev)
            if isinstance(i, torch.Tensor) and not i.dtype == torch.bool:
                i = i.long()
            return i

        idx = tuple(conv(i) for i in idx) if isinstance(idx, tuple) \
            else conv(idx)
        return trace_fn(lambda x: x[idx], self)

    def __repr__(self):
        return (f"VarBase(name={self.name}, shape={self.shape}, "
                f"dtype={self.dtype.name}, stop_gradient="
                f"{self.stop_gradient})\n{self.numpy()}")

    __str__ = __repr__


class ParamBase(VarBase):
    """Trainable eager parameter (reference: framework.py ParamBase):
    a leaf tensor that requires grad while ``trainable``."""

    __slots__ = ("trainable", "optimize_attr", "regularizer", "is_bias")

    def __init__(self, value, name: Optional[str] = None,
                 trainable: bool = True, is_bias: bool = False):
        super().__init__(value, name=name or unique_name.generate("param"),
                         stop_gradient=not trainable, persistable=True)
        self.trainable = trainable
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.is_bias = is_bias

    def set_value(self, value):
        """Overwrite the values in place (shape and dtype kept), so an
        optimizer's scope and any graph holding the tensor see them."""
        src = as_tensor(value, self._tensor.device)
        with torch.no_grad():
            self._tensor.copy_(src.reshape(self._tensor.shape))

    def __repr__(self):
        return (f"ParamBase(name={self.name}, shape={self.shape}, "
                f"dtype={self.dtype.name}, trainable={self.trainable})")

    __str__ = __repr__


def to_variable(value, name: Optional[str] = None, zero_copy=None) -> VarBase:
    """numpy -> eager tensor (reference: dygraph/base.py to_variable)."""
    if isinstance(value, VarBase):
        return value
    return VarBase(value, name=name)
