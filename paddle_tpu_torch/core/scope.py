"""Scope: hierarchical name -> value store.

The port of ``paddle_tpu/core/scope.py``. Values are torch tensors on
the executor's device (parameters, optimizer state) or small numpy
scalars (the ``@STEP_COUNTER@``).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, Optional


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
