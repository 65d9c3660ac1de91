"""Scope: hierarchical name -> value store.

The port of ``paddle_tpu/core/scope.py``. Values are torch tensors on
the executor's device (parameters, optimizer state) or small numpy
scalars (the ``@STEP_COUNTER@``).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

# the executor's step counter: a host integer, not a tensor
STEP_COUNTER = "@STEP_COUNTER@"


class Scope:
    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, Any] = {}
        self.parent = parent

    def new_scope(self) -> "Scope":
        return Scope(self)

    def set(self, name: str, value: Any):
        self._vars[name] = value

    def find_var(self, name: str) -> Any:
        """Recursive lookup (reference: Scope::FindVar). Returns None if absent."""
        s: Optional[Scope] = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        return None

    def has_var(self, name: str) -> bool:
        return self.find_var(name) is not None

    def items(self) -> Iterator[tuple[str, Any]]:
        return iter(self._vars.items())

    def local_var_names(self) -> list:
        return list(self._vars)

    def __contains__(self, name: str) -> bool:
        return self.has_var(name)

    def __bool__(self):
        # an empty Scope is still a scope — never falsy (guards against
        # `scope or global_scope()` silently swapping in the global scope)
        return True


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope: Scope):
    """Swap the global scope for a `with` region (reference:
    fluid.executor.scope_guard / paddle.static.scope_guard)."""
    global _global_scope
    old = _global_scope
    _global_scope = scope
    try:
        yield scope
    finally:
        _global_scope = old


def scope_from_numpy(arrays, device) -> Scope:
    """A Scope on ``device`` holding the given state: the function that
    carries training state across packages or devices. ``arrays`` maps
    var names to numpy arrays (params, moments, beta pows, the learning
    rate; a ``@STEP_COUNTER@`` entry stays a host integer). A bfloat16
    tensor arrives either as an array of ``ml_dtypes.bfloat16`` (what
    ``np.asarray`` of a bf16 jax array gives) or, where that package is
    absent, as a ``(uint16 bits, "bfloat16")`` pair; both are
    reinterpreted bit for bit. Every tensor is copied, so runs from one
    state dict do not share storage."""
    scope = Scope()
    for name, val in arrays.items():
        if name == STEP_COUNTER:
            scope.set(name, np.int32(int(np.asarray(val))))
            continue
        is_bf16 = False
        if isinstance(val, tuple):
            val, tag = val
            is_bf16 = tag == "bfloat16"
        val = np.asarray(val)
        if val.dtype.name == "bfloat16":
            val, is_bf16 = val.view(np.uint16), True
        if is_bf16:
            t = torch.from_numpy(val.astype(np.uint16).view(np.int16).copy())
            t = t.view(torch.bfloat16)
        else:
            t = torch.from_numpy(val.copy())
        scope.set(name, t.to(device))
    return scope
