"""Lowerings the reference keeps in ``paddle_tpu/ops/extra_ops.py``:
take_along_axis :251."""

from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("take_along_axis", non_diff_inputs=("Index",))
def take_along_axis(ins, attrs):
    """Batched gather along ``Axis`` with numpy semantics: input and
    index broadcast against each other on every other dim."""
    x, idx = ins["Input"][0], ins["Index"][0]
    axis = int(attrs.get("Axis", 0)) % x.dim()
    xs, js = list(x.shape), list(idx.shape)
    xs[axis] = js[axis] = 1
    common = list(torch.broadcast_shapes(xs, js))
    xs, js = list(common), list(common)
    xs[axis], js[axis] = x.shape[axis], idx.shape[axis]
    return {"Result": torch.gather(x.expand(xs), axis,
                                   idx.long().expand(js))}
