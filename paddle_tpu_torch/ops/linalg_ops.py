"""Lowerings the reference keeps in ``paddle_tpu/ops/linalg_ops.py``:
bilinear_tensor_product :186."""

from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("bilinear_tensor_product")
def bilinear_tensor_product(ins, attrs):
    """Out[b, k] = x[b] @ W[k] @ y[b] (+ Bias)."""
    x, y, w = ins["X"][0], ins["Y"][0], ins["Weight"][0]
    out = torch.einsum("bi,kij,bj->bk", x, w, y)
    if ins.get("Bias") and ins["Bias"][0] is not None:
        out = out + ins["Bias"][0]
    return {"Out": out}
