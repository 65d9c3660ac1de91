"""Sharding annotations on program variables.

The annotation half of ``paddle_tpu/parallel/api.py`` (:93-122):
``shard_tensor`` and ``set_logical_axes`` record a partition spec or
logical axis names in the var's attrs. ``models/bert.py`` and
``layers.fc`` call them and the attrs are part of the program's JSON, so
the port records them too. There is no mesh and no rule table here: nothing reads the
annotations, and a program runs on one device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

SHARDING_ATTR = "sharding_spec"
LOGICAL_AXES_ATTR = "logical_axes"


def _var_desc(var):
    return var.desc if hasattr(var, "desc") else var


def shard_tensor(var, spec: Sequence[Optional[Union[str, tuple]]]):
    """Annotate a program variable with a partition spec, e.g.
    ``shard_tensor(w, [None, "mp"])`` for a column-parallel weight."""
    _var_desc(var).attrs[SHARDING_ATTR] = tuple(spec)
    return var


def get_sharding_spec(var):
    return _var_desc(var).attrs.get(SHARDING_ATTR)


def set_logical_axes(var, axes: Sequence[Optional[str]]):
    """Attach logical axis names (one per dim, None = never sharded)."""
    _var_desc(var).attrs[LOGICAL_AXES_ATTR] = tuple(axes)
    return var


def get_logical_axes(var):
    return _var_desc(var).attrs.get(LOGICAL_AXES_ATTR)
