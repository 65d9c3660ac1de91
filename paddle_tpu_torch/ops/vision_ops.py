"""Lowerings the reference keeps in ``paddle_tpu/ops/vision_ops.py``:
pixel_shuffle :17 and lrn :103 (NCHW)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register_op


@register_op("pixel_shuffle")
def pixel_shuffle(ins, attrs):
    """[N, C*r^2, H, W] -> [N, C, H*r, W*r]."""
    r = int(attrs.get("upscale_factor", 1))
    x = ins["X"][0]
    n, c, h, w = x.shape
    oc = c // (r * r)
    y = x.reshape(n, oc, r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return {"Out": y.reshape(n, oc, h * r, w * r)}


@register_op("lrn")
def lrn(ins, attrs):
    """Local response normalisation across channels: Out = x / MidOut^beta,
    MidOut = k + alpha * (the sum of x^2 over the n channels around each,
    n // 2 before it)."""
    x = ins["X"][0]
    n = int(attrs.get("n", 5))
    alpha = float(attrs.get("alpha", 1e-4))
    beta = float(attrs.get("beta", 0.75))
    k = float(attrs.get("k", 1.0))
    half = n // 2
    sq = F.pad(torch.square(x), (0, 0, 0, 0, half, n - 1 - half))
    acc = sq[:, 0:x.shape[1]]
    for i in range(1, n):
        acc = acc + sq[:, i:i + x.shape[1]]
    mid = k + alpha * acc
    return {"Out": x / torch.pow(mid, beta), "MidOut": mid}
