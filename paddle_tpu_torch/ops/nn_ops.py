"""Neural-net lowerings (port of ``paddle_tpu/ops/nn_ops.py``:
layer_norm :401, dropout :453)."""

from __future__ import annotations

import torch

from ..core import rng
from ..core.registry import register_op


@register_op("layer_norm")
def layer_norm(ins, attrs):
    """Normalise the trailing dims from begin_norm_axis, in fp32, then
    scale and bias. One ``torch.native_layer_norm`` call, which also
    returns the mean and 1/sqrt(var + eps); Variance is recovered from
    the latter, as the reference's fused_layer_norm op does."""
    x = ins["X"][0]
    scale = ins["Scale"][0] if ins.get("Scale") else None
    bias = ins["Bias"][0] if ins.get("Bias") else None
    eps = attrs.get("epsilon", 1e-5)
    axis = int(attrs.get("begin_norm_axis", 1))
    norm_shape = tuple(x.shape[axis:])
    lead = tuple(x.shape[:axis])
    y, mean, rstd = torch.native_layer_norm(
        x.float(), norm_shape,
        None if scale is None else scale.reshape(norm_shape).float(),
        None if bias is None else bias.reshape(norm_shape).float(), eps)
    return {"Y": y.to(x.dtype), "Mean": mean.reshape(lead),
            "Variance": (1.0 / (rstd * rstd) - eps).reshape(lead)}


@register_op("dropout")
def dropout(ins, attrs):
    """Seed assigned at build; the run folds in the global step, so masks
    differ per step but stay reproducible. The keep mask is the
    reference's splitmix32 hash over the element lattice
    (``core/rng.dropout_keep``), bit for bit. upscale_in_train divides
    the kept values by 1 - p in x's dtype."""
    x = ins["X"][0]
    p = float(attrs.get("dropout_prob", 0.5))
    impl = attrs.get("dropout_implementation", "upscale_in_train")
    if bool(attrs.get("is_test", False)) or p == 0.0:
        out = x if impl == "upscale_in_train" else x * (1.0 - p)
        return {"Out": out, "Mask": torch.ones(x.shape, dtype=torch.uint8,
                                               device=x.device)}
    if x.device.type == "meta":
        keep = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    else:
        keep = rng.dropout_keep(x.shape, rng.op_seed(attrs), p, x.device)
    kept = x / (1.0 - p) if impl == "upscale_in_train" else x
    return {"Out": torch.where(keep, kept, torch.zeros_like(kept)),
            "Mask": keep.to(torch.uint8)}
