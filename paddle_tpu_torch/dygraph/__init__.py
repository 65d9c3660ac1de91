"""Imperative (dygraph) mode.

The port of ``paddle_tpu/dygraph/__init__.py``: eager tensors
(``VarBase``), autograd (``tracer``), the ``Layer`` system, the
``guard`` / ``enable_dygraph`` switches, ``no_grad``, ``grad``, and
``save_dygraph`` / ``load_dygraph`` in the reference's file format (a
JSON manifest at ``<path>.pdparams`` or ``.pdopt`` and the arrays in
``<path>.pdparams.npz``), so each package loads the other's files.

A guard takes its device as the executor does: ``guard()`` runs on the
card, ``guard("cpu")`` on the CPU. ``@to_static``, ``TracedLayer`` and
``jit.save`` / ``jit.load`` are ``jit.py``.

Not ported yet (ROADMAP A8): ``DataParallel`` (``dygraph/parallel.py``);
its names raise ``NotImplementedError`` naming the item.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os

import numpy as np
import torch

from ..core.ir import _dygraph_tracer_holder, in_dygraph_mode
from .layers import Layer
from .tracer import Tracer, get_tracer, grad, trace_fn, trace_op
from .varbase import ParamBase, VarBase, to_variable
from . import jit  # noqa: F401
from .jit import (ProgramTranslator, TracedLayer, declarative,  # noqa: F401
                  to_static)

__all__ = [
    "Layer", "Tracer", "VarBase", "ParamBase", "to_variable", "guard",
    "enable_dygraph", "disable_dygraph", "enabled", "no_grad", "grad",
    "trace_op", "trace_fn", "save_dygraph", "load_dygraph", "jit",
    "to_static", "declarative", "TracedLayer", "ProgramTranslator",
]


def enabled() -> bool:
    return in_dygraph_mode()


def enable_dygraph(place=None):
    if _dygraph_tracer_holder[0] is None:
        _dygraph_tracer_holder[0] = Tracer(place)


def disable_dygraph():
    _dygraph_tracer_holder[0] = None


@contextlib.contextmanager
def guard(place=None):
    """Enter dygraph mode on ``place`` (None: the card)."""
    old = _dygraph_tracer_holder[0]
    _dygraph_tracer_holder[0] = Tracer(place)
    try:
        yield
    finally:
        _dygraph_tracer_holder[0] = old


class no_grad:
    """Context manager and decorator that records no gradients
    (reference: dygraph/base.py no_grad)."""

    def __enter__(self):
        self._tracer = get_tracer()
        if self._tracer is not None:
            self._old = self._tracer.has_grad
            self._tracer.has_grad = False
        return self

    def __exit__(self, *exc):
        if self._tracer is not None:
            self._tracer.has_grad = self._old
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with no_grad():
                return fn(*args, **kwargs)

        return wrapper


def _host(v) -> np.ndarray:
    if isinstance(v, VarBase):
        return v.numpy()
    if isinstance(v, torch.Tensor):
        from ..core.executor import _to_numpy

        return _to_numpy(v)
    return np.asarray(v)


def save_dygraph(state_dict, model_path: str):
    """Write a state dict as the reference does: optimizer state (its
    marker, or keys that all hold '#' or start with 'LR_', or a
    non-tensor entry) to '.pdopt', parameters to '.pdparams'; the arrays
    in one npz beside a JSON manifest written last, so a torn save has no
    manifest."""
    from ..io import atomic_savez, atomic_write_json

    arrays, meta = {}, {}
    is_opt = bool(getattr(state_dict, "_is_optimizer_state", False)) or (
        bool(state_dict) and all("#" in k or k.startswith("LR_")
                                 for k in state_dict))
    for k, v in state_dict.items():
        if isinstance(v, (VarBase, torch.Tensor, np.ndarray)) or \
                hasattr(v, "shape"):
            arrays[k] = _host(v)
        else:
            meta[k] = v
            is_opt = True
    suffix = ".pdopt" if is_opt else ".pdparams"
    path = model_path if model_path.endswith((".pdparams", ".pdopt")) \
        else model_path + suffix
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    atomic_savez(path + ".npz", **arrays)
    atomic_write_json(path, {"keys": sorted(arrays), "meta": meta})


def load_dygraph(model_path: str):
    """(parameter state dict or None, optimizer state dict or None), as
    numpy arrays on the host."""
    params, opt = None, None
    for suffix in (".pdparams", ".pdopt"):
        path = model_path if model_path.endswith(suffix) \
            else model_path + suffix
        if not os.path.exists(path):
            continue
        with open(path) as f:
            manifest = json.load(f)
        with np.load(path + ".npz") as data:
            state = {k: data[k] for k in data.files}
        state.update(manifest.get("meta", {}))
        if suffix == ".pdparams":
            params = state
        else:
            opt = state
    return params, opt


# the reference re-exports its nn Layer classes under fluid.dygraph
_NN_ALIASES = ("BatchNorm", "Conv2D", "Conv2DTranspose", "Dropout",
               "Embedding", "Flatten", "GroupNorm", "GRUCell",
               "LayerList", "LayerNorm", "Linear", "LSTMCell",
               "ParameterList", "Sequential")
_NOT_PORTED = {"DataParallel": "A8", "ParallelStrategy": "A8",
               "prepare_context": "A8"}


def __getattr__(name):
    if name in _NN_ALIASES:
        from .. import nn as _nn

        return getattr(_nn, name)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"dygraph.{name} is not in the port yet (ROADMAP "
            f"{_NOT_PORTED[name]})")
    raise AttributeError(f"module 'paddle_tpu_torch.dygraph' has no "
                         f"attribute {name!r}")
