"""Lowerings the reference keeps in ``paddle_tpu/ops/extra_ops.py``:
take_along_axis :251, and the 2.0 API's tail: sin :30, selu :56, brelu
:77, thresholded_relu :86, tanh_shrink :95, softshrink :103, hard_shrink
:113, eye :133, linspace :145, index_select :183, flip :200, roll :208,
bce_loss :325, margin_rank_loss :355, instance_norm :386 and
broadcast_to :220 (with its alias expand_as_v2)."""

from __future__ import annotations

import torch

from ..core.registry import creation_device, register_op
from ..core.types import to_torch_dtype, x64_off
from .math_ops import tie_clip
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


# -- the activation tail (reference :20-118) ---------------------------------

@register_op("sin")
def sin(ins, attrs):
    return {"Out": torch.sin(ins["X"][0])}


@register_op("selu")
def selu(ins, attrs):
    """scale * (x if x > 0 else alpha * (e^x - 1)) (reference :54)."""
    x = ins["X"][0]
    scale = float(attrs.get("scale", 1.0507009873554805))
    alpha = float(attrs.get("alpha", 1.6732632423543772))
    return {"Out": scale * torch.where(x > 0, x,
                                       alpha * (torch.exp(x) - 1.0))}


@register_op("brelu")
def brelu(ins, attrs):
    """clip(x, t_min, t_max) (reference :75), with ``jnp.clip``'s
    gradient: half at a bound."""
    x = ins["X"][0]
    return {"Out": tie_clip(x, float(attrs.get("t_min", 0.0)),
                            float(attrs.get("t_max", 24.0)))}


@register_op("thresholded_relu")
def thresholded_relu(ins, attrs):
    x = ins["X"][0]
    th = float(attrs.get("threshold", 1.0))
    return {"Out": torch.where(x > th, x, torch.zeros_like(x))}


@register_op("tanh_shrink")
def tanh_shrink(ins, attrs):
    x = ins["X"][0]
    return {"Out": x - torch.tanh(x)}


@register_op("softshrink")
def softshrink(ins, attrs):
    x = ins["X"][0]
    lam = float(attrs.get("lambda", 0.5))
    return {"Out": torch.where(x > lam, x - lam,
                               torch.where(x < -lam, x + lam,
                                           torch.zeros_like(x)))}


@register_op("hard_shrink")
def hard_shrink(ins, attrs):
    x = ins["X"][0]
    th = float(attrs.get("threshold", 0.5))
    return {"Out": torch.where(torch.abs(x) > th, x, torch.zeros_like(x))}


# -- tensor factories and manipulation (reference :131-230) ------------------

@register_op("eye")
def eye(ins, attrs):
    """An n x m identity in ``dtype`` (64-bit types narrowed, as the
    reference's arrays are), on the creation device."""
    n = int(attrs["num_rows"])
    m = int(attrs.get("num_columns", -1))
    dtype = x64_off(to_torch_dtype(attrs.get("dtype", "float32")))
    return {"Out": torch.eye(n, n if m < 0 else m, dtype=dtype,
                             device=creation_device())}


@register_op("linspace", non_diff_inputs=("Start", "Stop", "Num"))
def linspace(ins, attrs):
    """``num`` points from Start to Stop, both ends included, with
    ``jnp.linspace``'s arithmetic: start * (1 - t) + stop * t for
    t = i / (num - 1), the last point Stop itself. ``num`` is a static
    attr, as in the reference; the bounds stay on the device."""
    start = ins["Start"][0].reshape(())
    stop = ins["Stop"][0].reshape(())
    num = attrs.get("num")
    if num is None:
        raise ValueError("linspace needs a static `num` attr (a Num "
                         "tensor would be a dynamic output shape)")
    num = int(num)
    dtype = torch.promote_types(start.dtype, stop.dtype)
    if not dtype.is_floating_point:
        dtype = torch.float32
    start, stop = start.to(dtype), stop.to(dtype)
    if num <= 1:
        return {"Out": start.reshape(1)[:num]}
    div = num - 1
    t = torch.arange(div, dtype=dtype, device=start.device) / div
    out = start * (1 - t) + stop * t
    return {"Out": torch.cat([out, stop.reshape(1)])}


@register_op("index_select", non_diff_inputs=("Index",))
def index_select(ins, attrs):
    """``jnp.take`` along ``dim``: a negative index in [-n, 0) wraps, one
    outside [-n, n) takes ``take_fill``."""
    x, idx = ins["X"][0], ins["Index"][0]
    axis = int(attrs.get("dim", 0)) % x.dim()
    n = x.shape[axis]
    idx = idx.long().reshape(-1)
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    out = x.index_select(axis, idx.clamp(0, max(n - 1, 0)))
    shape = [1] * out.dim()
    shape[axis] = -1
    return {"Out": torch.where(valid.reshape(shape), out,
                               take_fill(out.dtype))}


@register_op("flip")
def flip(ins, attrs):
    axes = attrs.get("axis", [0])
    if not isinstance(axes, (list, tuple)):
        axes = [axes]
    return {"Out": torch.flip(ins["X"][0], dims=[int(a) for a in axes])}


@register_op("roll")
def roll(ins, attrs):
    """Roll along ``axis``; without one, the flattened tensor by the first
    shift (reference :206)."""
    shifts = [int(s) for s in attrs.get("shifts", [0])]
    axes = attrs.get("axis", None)
    x = ins["X"][0]
    if axes in (None, []):
        return {"Out": torch.roll(x.reshape(-1), shifts[0]).reshape(x.shape)}
    if not isinstance(axes, (list, tuple)):
        axes = [axes]
    return {"Out": torch.roll(x, shifts, dims=[int(a) for a in axes])}


# -- losses and norms (reference :323-410) ------------------------------------

@register_op("bce_loss", non_diff_inputs=("Label",))
def bce_loss(ins, attrs):
    """-(l log x + (1 - l) log(1 - x)) on x clipped to [1e-12, 1 - 1e-7]
    in fp32, cast back to x's dtype."""
    x, label = ins["X"][0], ins["Label"][0]
    xf = tie_clip(x.float(), 1e-12, 1.0 - 1e-7)
    out = -(label * torch.log(xf) + (1.0 - label) * torch.log(1.0 - xf))
    return {"Out": out.to(x.dtype)}


@register_op("margin_rank_loss", non_diff_inputs=("Label",))
def margin_rank_loss(ins, attrs):
    """max(0, -label * (x1 - x2) + margin), and Activated = out > 0."""
    label, x1, x2 = ins["Label"][0], ins["X1"][0], ins["X2"][0]
    out = tie_clip(-label * (x1 - x2) + float(attrs.get("margin", 0.0)),
                   0.0)
    return {"Out": out, "Activated": (out > 0).to(x1.dtype)}


@register_op("instance_norm")
def instance_norm(ins, attrs):
    """Per-(N, C) normalisation over the spatial dims in fp32 (reference
    :386); SavedMean [N, C] and SavedVariance [N, C] the reciprocal
    standard deviation."""
    x = ins["X"][0]
    scale = ins["Scale"][0] if ins.get("Scale") else None
    bias = ins["Bias"][0] if ins.get("Bias") else None
    eps = float(attrs.get("epsilon", 1e-5))
    axes = tuple(range(2, x.dim()))
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=axes, keepdim=True)
    rstd = 1.0 / torch.sqrt(var + eps)
    y = (xf - mean) * rstd
    bshape = (1, x.shape[1]) + (1,) * (x.dim() - 2)
    if scale is not None:
        y = y * scale.reshape(bshape)
    if bias is not None:
        y = y + bias.reshape(bshape)
    n, c = x.shape[0], x.shape[1]
    return {"Y": y.to(x.dtype), "SavedMean": mean.reshape(n, c),
            "SavedVariance": rstd.reshape(n, c)}


@register_op("broadcast_to")
@register_op("expand_as_v2")
def broadcast_to(ins, attrs):
    """X broadcast to the ``shape`` (or ``target_shape``) attr, or to Y's
    shape (reference :220); the Bilinear initializer's broadcast."""
    x = ins["X"][0]
    shape = attrs.get("shape") or attrs.get("target_shape")
    if shape is None and ins.get("Y"):
        shape = ins["Y"][0].shape
    return {"Out": torch.broadcast_to(x, tuple(int(s) for s in shape))
            .contiguous()}
