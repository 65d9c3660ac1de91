"""paddle.static: the 2.0 static-graph namespace.

The port of ``paddle_tpu/static/__init__.py``: the fluid static-graph
surface under its 2.0 name (Program, program_guard, Executor, data,
``nn``, the save / load and inference-model functions), ``InputSpec``,
and ``enable_static`` / ``disable_static``, which leave and enter
dygraph mode (the framework is static-first).
"""

from __future__ import annotations

import torch

from .. import io as _io
from ..core.compiler import (BuildStrategy, CompiledProgram,  # noqa: F401
                             ExecutionStrategy)
from ..core.executor import Executor  # noqa: F401
from ..core.ir import (Program, Variable, default_main_program,  # noqa: F401
                       default_startup_program, device_guard,
                       in_dygraph_mode, program_guard)
from ..core.scope import Scope  # noqa: F401
from ..layers import static_data  # noqa: F401
from . import nn  # noqa: F401

save_inference_model = _io.save_inference_model
load_inference_model = _io.load_inference_model
save = _io.save
load = _io.load


def data(name, shape, dtype="float32", lod_level=0):
    """paddle.static.data: unlike fluid's layers.data, ``shape`` holds
    the batch dim (None or -1 for a dim fed at run time)."""
    shape = [(-1 if d is None else int(d)) for d in shape]
    return static_data(name, shape, dtype, lod_level=lod_level)


def enable_static():
    """paddle.enable_static: leave dygraph mode (static is the default
    mode here)."""
    from ..dygraph import disable_dygraph

    disable_dygraph()


def disable_static(place=None):
    """paddle.disable_static: enter dygraph mode on ``place`` (None: the
    card, as a guard)."""
    from ..dygraph import enable_dygraph

    enable_dygraph(place)


def cpu_places(device_count=None):
    """The CPU as a place list (the port's places are torch devices)."""
    return [torch.device("cpu")] * (device_count or 1)


def global_scope():
    from ..core.scope import global_scope as _gs

    return _gs()


def scope_guard(scope):
    from ..core.scope import scope_guard as _sg

    return _sg(scope)


class InputSpec:
    """paddle.static.InputSpec (reference: python/paddle/static/input.py):
    a shape, dtype and name signature for to_static, jit.save and hapi
    Model inputs; -1 (or None) marks a dim fed at run time."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(-1 if d is None else int(d) for d in shape)
        self.dtype = str(dtype)
        self.name = name

    @classmethod
    def from_tensor(cls, tensor, name=None):
        from ..core.types import dtype_name

        return cls(tuple(tensor.shape), dtype_name(tensor.dtype),
                   name or getattr(tensor, "name", None))

    @classmethod
    def from_numpy(cls, ndarray, name=None):
        return cls(ndarray.shape, str(ndarray.dtype), name)

    def batch(self, batch_size):
        """Prepend a batch dim in place and return self (the reference's
        static/input.py mutates the spec: ported code calls it as a
        statement)."""
        self.shape = (int(batch_size),) + self.shape
        return self

    def unbatch(self):
        if not self.shape:
            raise ValueError("unbatch: spec has no dims")
        self.shape = self.shape[1:]
        return self

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype!r}, "
                f"name={self.name!r})")
