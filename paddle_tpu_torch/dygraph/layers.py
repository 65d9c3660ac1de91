"""Layer: the dygraph module base class.

The port of ``paddle_tpu/dygraph/layers.py`` (``Layer`` :36):
parameters, sub-layers and buffers registered through ``__setattr__``,
``state_dict`` / ``set_state_dict`` keyed by structured names, ``train``
/ ``eval``, forward hooks. Dual-mode: in dygraph mode a parameter is an
eager ``ParamBase`` on the tracer's device, made by the initializer's own
op run once; in static mode (no tracer, inside ``program_guard``) it is a
Parameter of the main program with its init op in the startup program,
so the same ``Layer`` builds a Program.
"""

from __future__ import annotations

import collections
import copy
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core import unique_name
from .varbase import ParamBase, VarBase, as_tensor

# the program that holds the init op of every eager parameter: its seed
# counter gives each parameter a seed of its own, in creation order (the
# reference's throwaway Program per parameter gives every one the same)
_INIT_PROGRAM = []


def _eager_initialize(initializer, shape, dtype, device) -> torch.Tensor:
    """Run an initializer's op on ``device`` (the same lowerings as a
    static startup program's)."""
    from ..core import registry
    from ..core.executor import run_op
    from ..core.ir import Program

    if not _INIT_PROGRAM:
        _INIT_PROGRAM.append(Program())
    blk = _INIT_PROGRAM[0].global_block()
    var = blk.create_var(name=unique_name.generate("eager_init"),
                         shape=tuple(shape), dtype=dtype)
    start = len(blk.ops)
    initializer(var, blk)
    env: Dict[str, Any] = {}
    with registry.creating_on(device):
        for op in blk.ops[start:]:
            run_op(op, env)
    del blk.ops[start:]
    blk.vars.pop(var.name, None)
    return env[var.name].to(device)


class Layer:
    """Dygraph module (reference: dygraph/layers.py Layer)."""

    def __init__(self, name_scope: Optional[str] = None, dtype="float32"):
        self._full_name = unique_name.generate(
            name_scope or type(self).__name__.lower())
        self._dtype = dtype
        self.training = True
        self._parameters: "collections.OrderedDict[str, Any]" = \
            collections.OrderedDict()
        self._sub_layers: "collections.OrderedDict[str, Layer]" = \
            collections.OrderedDict()
        self._buffers: "collections.OrderedDict[str, Any]" = \
            collections.OrderedDict()
        self._forward_pre_hooks = collections.OrderedDict()
        self._forward_post_hooks = collections.OrderedDict()

    def full_name(self) -> str:
        return self._full_name

    # -- parameter creation ---------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """An eager ParamBase in dygraph mode; in static mode a Parameter
        of the main program with its init op in the startup program."""
        from .. import initializer as I
        from ..core.ir import _dygraph_tracer_holder, in_dygraph_mode
        from ..param_attr import ParamAttr

        dtype = dtype or self._dtype
        attr = ParamAttr._to_attr(attr)
        if attr is None:  # attr=False: no parameter (bias_attr=False)
            return None
        init = attr.initializer or default_initializer
        if init is None:
            init = I.Constant(0.0) if is_bias \
                else I._default_weight_initializer()

        if not in_dygraph_mode():
            from ..layer_helper import LayerHelper

            a = attr
            if a.initializer is None:
                a = copy.copy(attr)
                a.initializer = init
            return LayerHelper(self._full_name).create_parameter(
                a, list(shape), dtype=dtype, is_bias=is_bias)

        device = _dygraph_tracer_holder[0].device
        p = ParamBase(_eager_initialize(init, shape, dtype, device),
                      name=attr.name or None, is_bias=is_bias)
        p.regularizer = getattr(attr, "regularizer", None)
        lr = getattr(attr, "learning_rate", None)
        if lr is not None:
            p.optimize_attr["learning_rate"] = lr
        if attr.trainable is False:
            p.trainable = False
            p.stop_gradient = True
        return p

    # -- registration ---------------------------------------------------------
    def add_parameter(self, name: str, parameter):
        self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name: str, sublayer: "Layer"):
        self._sub_layers[name] = sublayer
        return sublayer

    def register_buffer(self, name: str, tensor, persistable: bool = True):
        """Dual-mode like create_parameter: in static mode a persistable
        var of the main program initialised from the value in the startup
        program (BatchNorm's running statistics)."""
        from ..core.ir import (default_main_program,
                               default_startup_program, in_dygraph_mode)
        from ..initializer import NumpyArrayInitializer

        if tensor is not None and not in_dygraph_mode() \
                and not isinstance(tensor, VarBase):
            value = np.asarray(tensor)
            vname = unique_name.generate(f"{self._full_name}.{name}")
            var = default_main_program().global_block().create_var(
                name=vname, shape=tuple(value.shape), dtype=str(value.dtype),
                persistable=persistable)
            var.stop_gradient = True
            sblock = default_startup_program().global_block()
            svar = sblock.create_var(name=vname, shape=tuple(value.shape),
                                     dtype=str(value.dtype),
                                     persistable=persistable)
            NumpyArrayInitializer(value)(svar, sblock)
            self._buffers[name] = var
            return var
        if tensor is not None and not isinstance(tensor, VarBase):
            tensor = VarBase(tensor)
        if tensor is not None:
            tensor.persistable = persistable
        self._buffers[name] = tensor
        return tensor

    def __setattr__(self, name: str, value):
        from ..core.ir import Parameter as _StaticParameter
        from ..core.ir import Variable as _StaticVariable

        params = self.__dict__.get("_parameters")
        layers = self.__dict__.get("_sub_layers")
        buffers = self.__dict__.get("_buffers")
        if isinstance(value, (ParamBase, _StaticParameter)) and \
                params is not None:
            if layers is not None:
                layers.pop(name, None)
            params[name] = value
        elif isinstance(value, Layer) and layers is not None:
            if params is not None:
                params.pop(name, None)
            layers[name] = value
        elif buffers is not None and name in buffers:
            ok = value is None or isinstance(value, (VarBase,
                                                     _StaticVariable))
            buffers[name] = value if ok else VarBase(value)
        else:
            # a plain value over a registered parameter or sub-layer
            # deregisters it, so parameters() / state_dict() stay right
            for store in (params, layers):
                if store is not None:
                    store.pop(name, None)
            object.__setattr__(self, name, value)

    def __getattr__(self, name: str):
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                return d[name]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{name}'")

    def __delattr__(self, name):
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                del d[name]
                return
        object.__delattr__(self, name)

    # -- traversal ------------------------------------------------------------
    def parameters(self, include_sublayers: bool = True) -> List[ParamBase]:
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_parameters(self, prefix: str = "",
                         include_sublayers: bool = True
                         ) -> Iterator[Tuple[str, ParamBase]]:
        seen = set()
        for name, p in self._parameters.items():
            if p is not None and id(p) not in seen:
                seen.add(id(p))
                yield (f"{prefix}.{name}" if prefix else name), p
        if include_sublayers:
            for lname, layer in self._sub_layers.items():
                if layer is None:
                    continue
                sub = f"{prefix}.{lname}" if prefix else lname
                for n, p in layer.named_parameters(sub, True):
                    if id(p) not in seen:
                        seen.add(id(p))
                        yield n, p

    def sublayers(self, include_self: bool = False) -> List["Layer"]:
        out = [self] if include_self else []
        for layer in self._sub_layers.values():
            if layer is not None:
                out.extend(layer.sublayers(include_self=True))
        return out

    def named_sublayers(self, prefix: str = "", include_self: bool = False
                        ) -> Iterator[Tuple[str, "Layer"]]:
        if include_self:
            yield prefix, self
        for name, layer in self._sub_layers.items():
            if layer is None:
                continue
            sub = f"{prefix}.{name}" if prefix else name
            yield from layer.named_sublayers(sub, include_self=True)

    def buffers(self, include_sublayers: bool = True) -> List[VarBase]:
        out = [b for b in self._buffers.values() if b is not None]
        if include_sublayers:
            for layer in self._sub_layers.values():
                if layer is not None:
                    out.extend(layer.buffers(True))
        return out

    def apply(self, fn):
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    # -- mode -----------------------------------------------------------------
    def train(self):
        for layer in self.sublayers(include_self=True):
            layer.training = True
        return self

    def eval(self):
        for layer in self.sublayers(include_self=True):
            layer.training = False
        return self

    # -- state dict -----------------------------------------------------------
    def state_dict(self, include_sublayers: bool = True,
                   structured_name_prefix: str = "") -> Dict[str, VarBase]:
        out: "collections.OrderedDict[str, VarBase]" = \
            collections.OrderedDict()
        for name, p in self._parameters.items():
            if p is not None:
                out[structured_name_prefix + name] = p
        for name, b in self._buffers.items():
            if b is not None and b.persistable:
                out[structured_name_prefix + name] = b
        if include_sublayers:
            for lname, layer in self._sub_layers.items():
                if layer is not None:
                    out.update(layer.state_dict(
                        True, structured_name_prefix + lname + "."))
        return out

    def set_state_dict(self, state_dict: Dict[str, Any],
                       use_structured_name=True):
        """Load values by structured name, in place (each tensor keeps its
        dtype and device): VarBases, tensors or numpy arrays, e.g. a
        reference ``Layer``'s ``state_dict()`` as numpy. Returns
        (missing keys, unexpected keys); a shape mismatch raises."""
        own = self.state_dict()
        missing, unexpected = [], []
        for k, v in state_dict.items():
            if k not in own:
                unexpected.append(k)
                continue
            target = own[k]
            src = v._tensor if isinstance(v, VarBase) else \
                as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                          else v, target._tensor.device)
            if tuple(src.shape) != tuple(target.shape):
                raise ValueError(
                    f"shape mismatch for '{k}': checkpoint "
                    f"{tuple(src.shape)} vs model {tuple(target.shape)}")
            with torch.no_grad():
                target._tensor.copy_(src.to(target._tensor.device))
        for k in own:
            if k not in state_dict:
                missing.append(k)
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_gradient()

    # -- hooks ----------------------------------------------------------------
    def register_forward_post_hook(self, hook):
        return _HookHandle(self._forward_post_hooks, hook)

    def register_forward_pre_hook(self, hook):
        return _HookHandle(self._forward_pre_hooks, hook)

    # -- call -----------------------------------------------------------------
    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def __call__(self, *inputs, **kwargs):
        for hook in self._forward_pre_hooks.values():
            res = hook(self, inputs)
            if res is not None:
                inputs = res if isinstance(res, tuple) else (res,)
        out = self.forward(*inputs, **kwargs)
        for hook in self._forward_post_hooks.values():
            res = hook(self, inputs, out)
            if res is not None:
                out = res
        return out

    def __repr__(self):
        extra = ", ".join(f"{n}: {type(l).__name__}"
                          for n, l in self._sub_layers.items())
        return f"{type(self).__name__}({extra})"


class _HookHandle:
    _counter = [0]

    def __init__(self, store, hook):
        self._store = store
        self._id = self._counter[0]
        self._counter[0] += 1
        store[self._id] = hook

    def remove(self):
        self._store.pop(self._id, None)
