"""Lowerings the reference keeps in ``paddle_tpu/ops/extra_ops4.py``:
masked_select :22."""

from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("masked_select", non_diff_inputs=("Mask",))
def masked_select(ins, attrs):
    """Y = X[Mask] flattened, in the reference's static form: Y has X's
    size, the first Count slots hold the selected elements in row-major
    order and the rest are 0; Count is an int32 scalar. A stable sort of
    ~Mask puts the selected positions first, with no host read."""
    x = ins["X"][0].reshape(-1)
    mask = ins["Mask"][0].reshape(-1) != 0
    order = torch.sort((~mask).to(torch.int8), stable=True).indices
    cnt = mask.sum(dtype=torch.int32)
    pos = torch.arange(x.shape[0], device=x.device)
    y = torch.where(pos < cnt, x[order], torch.zeros_like(x))
    return {"Y": y, "Count": cnt}
