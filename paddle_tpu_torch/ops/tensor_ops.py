"""Tensor creation and manipulation lowerings (port of
``paddle_tpu/ops/tensor_ops.py``: fill_constant :57, uniform_random :75,
gaussian_random :87, truncated_gaussian_random :99, scale :146, reshape2
:156, squeeze2 :233, unsqueeze2 :244, slice :283, gather :314,
lookup_table_v2 :337, sum :423).

The random initializers draw from a ``torch.Generator`` seeded with the
op's seed as ``core/rng.op_seed`` derives it: the same distributions as
the reference, reproducible per seed, not the reference's bits."""

from __future__ import annotations

import math

import torch

from ..core import rng
from ..core.registry import creation_device, register_op
from ..core.types import to_torch_dtype


def _shape_of(attrs):
    return tuple(int(d) for d in attrs["shape"])


@register_op("fill_constant")
def fill_constant(ins, attrs):
    return {"Out": torch.full(
        _shape_of(attrs), attrs.get("value", 0.0),
        dtype=to_torch_dtype(attrs.get("dtype", "float32")),
        device=creation_device())}


def _uniform01(attrs):
    """fp32 uniform [0, 1) numbers of the op's shape, from its seed."""
    dev = creation_device()
    if dev.type == "meta":
        return torch.empty(_shape_of(attrs), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(rng.op_seed(attrs))
    return torch.rand(_shape_of(attrs), generator=gen, device=dev)


def _std_normal(u, lo=0.0, hi=1.0):
    """Inverse normal CDF of uniforms rescaled to the CDF range [lo, hi]."""
    u = (lo + (hi - lo) * u).clamp(1e-7, 1.0 - 1e-7)
    return math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)


@register_op("uniform_random")
def uniform_random(ins, attrs):
    lo, hi = float(attrs.get("min", -1.0)), float(attrs.get("max", 1.0))
    out = lo + (hi - lo) * _uniform01(attrs)
    return {"Out": out.to(to_torch_dtype(attrs.get("dtype", "float32")))}


@register_op("gaussian_random")
def gaussian_random(ins, attrs):
    x = _std_normal(_uniform01(attrs))
    out = x * float(attrs.get("std", 1.0)) + float(attrs.get("mean", 0.0))
    return {"Out": out.to(to_torch_dtype(attrs.get("dtype", "float32")))}


@register_op("truncated_gaussian_random")
def truncated_gaussian_random(ins, attrs):
    """Normal(mean, std) truncated at two standard deviations, by the
    inverse CDF over [cdf(-2), cdf(2)]."""
    c = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    x = _std_normal(_uniform01(attrs), c, 1.0 - c).clamp(-2.0, 2.0)
    out = x * float(attrs.get("std", 1.0)) + float(attrs.get("mean", 0.0))
    return {"Out": out.to(to_torch_dtype(attrs.get("dtype", "float32")))}


@register_op("scale")
def scale(ins, attrs):
    x = ins["X"][0]
    s = attrs.get("scale", 1.0)
    b = attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return {"Out": x * s + b}
    return {"Out": (x + b) * s}


def _xshape(x):
    return x.new_zeros((0,) + tuple(x.shape))


@register_op("reshape2")
def reshape2(ins, attrs):
    """0 copies the input dim at that position; -1 is inferred."""
    x = ins["X"][0]
    shape = [x.shape[i] if d == 0 else d
             for i, d in enumerate(attrs["shape"])]
    return {"Out": x.reshape(shape), "XShape": _xshape(x)}


@register_op("squeeze2")
def squeeze2(ins, attrs):
    x = ins["X"][0]
    axes = attrs.get("axes") or [i for i, d in enumerate(x.shape) if d == 1]
    axes = [a for a in axes if x.shape[a] == 1]
    out = x.squeeze(tuple(axes)) if axes else x
    return {"Out": out, "XShape": _xshape(x)}


@register_op("unsqueeze2")
def unsqueeze2(ins, attrs):
    x = ins["X"][0]
    out = x
    for a in sorted(attrs["axes"]):
        out = out.unsqueeze(a)
    return {"Out": out, "XShape": _xshape(x)}


@register_op("slice")
def slice_op(ins, attrs):
    x = ins["Input"][0]
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    out = x[tuple(idx)]
    decrease = attrs.get("decrease_axis") or []
    if decrease:
        out = out.squeeze(tuple(decrease))
    return {"Out": out}


@register_op("gather", non_diff_inputs=("Index",))
def gather(ins, attrs):
    """jnp.take(x, index, axis): out shape is x.shape[:axis] +
    index.shape + x.shape[axis+1:]. Index arrives int32 and is widened
    for torch's indexing."""
    x, index = ins["X"][0], ins["Index"][0]
    axis = int(attrs.get("axis", 0)) % x.dim()
    flat = torch.index_select(x, axis, index.reshape(-1).long())
    return {"Out": flat.reshape(tuple(x.shape[:axis]) + tuple(index.shape)
                                + tuple(x.shape[axis + 1:]))}


@register_op("lookup_table_v2", non_diff_inputs=("Ids",))
def lookup_table_v2(ins, attrs):
    """Embedding lookup; rows of padding_idx come out as zeros. The
    gradient is the scatter-add that autograd derives from the gather."""
    w, ids = ins["W"][0], ins["Ids"][0]
    out = torch.index_select(w, 0, ids.reshape(-1).long()).reshape(
        tuple(ids.shape) + tuple(w.shape[1:]))
    pad = int(attrs.get("padding_idx", -1))
    if pad >= 0:
        out = out * (ids != pad)[..., None].to(out.dtype)
    return {"Out": out}


@register_op("sum")
def sum_op(ins, attrs):
    """Multi-input add: the gradient-accumulation op."""
    xs = [x for x in ins["X"] if x is not None]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": out}
