"""Lowerings the reference keeps in ``paddle_tpu/ops/extra_ops.py``:
take_along_axis :251."""

from __future__ import annotations

import torch

from ..core.registry import register_op
from .tensor_ops import take_fill


@register_op("take_along_axis", non_diff_inputs=("Index",))
def take_along_axis(ins, attrs):
    """Batched gather along ``Axis`` with numpy semantics: input and
    index broadcast against each other on every other dim. Indices work
    as in ``jnp.take_along_axis``: a negative one in [-n, 0) wraps, and
    one outside [-n, n) takes the fill (NaN for a floating X, the least
    value of a signed integer X). The checks are tensor ops, with no
    host read."""
    x, idx = ins["Input"][0], ins["Index"][0]
    axis = int(attrs.get("Axis", 0)) % x.dim()
    xs, js = list(x.shape), list(idx.shape)
    xs[axis] = js[axis] = 1
    common = list(torch.broadcast_shapes(xs, js))
    xs, js = list(common), list(common)
    xs[axis], js[axis] = x.shape[axis], idx.shape[axis]
    n = x.shape[axis]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    out = torch.gather(x.expand(xs), axis,
                       idx.clamp(0, max(n - 1, 0)).expand(js))
    return {"Result": torch.where(valid.expand(js), out,
                                  take_fill(out.dtype))}
