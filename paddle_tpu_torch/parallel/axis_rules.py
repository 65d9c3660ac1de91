"""Logical-axis rules: one ordered table maps logical axis names to mesh
axes (port of ``paddle_tpu/parallel/axis_rules.py``).

Program variables carry logical axis names (``("embed", "mlp")`` for an
FFN weight, ``("batch",)`` for a feed) and the ordered table maps them
to mesh axes. The active table is process-global (``get_rules`` /
``set_rules`` / the ``axis_rules`` context manager) and ``fingerprint()``
hashes it. The port has no mesh yet (ROADMAP A8), so the reference's
spec resolution (``AxisRules.resolve``, ``batch_mesh_axis``) is not
ported; the autotuner's profiles carry the table and its fingerprint
(``core/tuner.py``).
"""

from __future__ import annotations

import hashlib
import json
from contextlib import contextmanager
from typing import Iterable, Optional, Tuple


class AxisRules(tuple):
    """Immutable ordered table of (logical_axis, mesh_axis | None) pairs.
    Multiple rules may name the same logical axis (fallback chain)."""

    def __new__(cls, rules: Iterable[Tuple[str, Optional[str]]]):
        norm = []
        for entry in rules:
            if len(entry) != 2:
                raise ValueError(
                    f"axis rule {entry!r} is not a (logical, mesh) pair")
            logical, target = entry
            if not isinstance(logical, str):
                raise ValueError(
                    f"logical axis name {logical!r} must be a string")
            if target is not None and not isinstance(target, str):
                raise ValueError(
                    f"mesh axis {target!r} must be a string or None")
            norm.append((logical, target))
        return super().__new__(cls, norm)

    def fingerprint(self) -> str:
        """Stable content hash of the table (a tuned profile's
        fingerprint)."""
        payload = json.dumps(list(self), separators=(",", ":"))
        return hashlib.sha1(payload.encode()).hexdigest()[:12]


# the default table: the T5X-ish mapping for this repo's conventional mesh
# axis names (dp data / mp megatron tensor / sp sequence / pp pipeline /
# ep expert)
DEFAULT_RULES = AxisRules((
    ("batch", "dp"),
    ("sequence", "sp"),
    ("vocab", "mp"),
    ("heads", "mp"),
    ("mlp", "mp"),
    ("kv", None),
    ("embed", None),
    ("expert", "ep"),
))

_active_rules: Optional[AxisRules] = DEFAULT_RULES


def get_rules() -> Optional[AxisRules]:
    return _active_rules


def set_rules(rules) -> Optional[AxisRules]:
    """Install `rules` (an AxisRules / iterable of pairs / None) as the
    process-global table; returns the previous table."""
    global _active_rules
    prev = _active_rules
    if rules is not None and not isinstance(rules, AxisRules):
        rules = AxisRules(rules)
    _active_rules = rules
    return prev


@contextmanager
def axis_rules(rules):
    """Scoped rule-table override: `with axis_rules([("batch", "dp")]): ...`"""
    prev = set_rules(rules)
    try:
        yield get_rules()
    finally:
        set_rules(prev)


def fingerprint() -> Optional[str]:
    """Fingerprint of the ACTIVE table (None when rules are disabled)."""
    return _active_rules.fingerprint() if _active_rules is not None else None
