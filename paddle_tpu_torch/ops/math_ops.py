"""Math lowerings (port of ``paddle_tpu/ops/math_ops.py``: elementwise
:38-46, relu :90, tanh :93, sigmoid :92, sqrt, square and sign :97-111,
clip :190, isfinite :511, gelu :141, reduce_sum and
reduce_mean :231, mean :238, matmul
:267, matmul_v2 :285, mul :297, softmax :329, cross_entropy :343,
softmax_with_cross_entropy :361, accuracy :448, top_k :466, fc :525).

The matrix products stay ``torch.matmul``, as the JAX package left them
to XLA; fp32 products run in full fp32 on the card (TF32 off), bf16
products accumulate in fp32."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.registry import register_op


def _bcast_y(x, y, axis: int):
    """Paddle elementwise broadcast: align y's dims starting at ``axis``
    of x (reference: elementwise_op_function.h); -1 = trailing align."""
    if x.dim() == y.dim() or y.dim() == 0:
        return y
    if axis == -1 or axis is None:
        axis = x.dim() - y.dim()
    return y.reshape([1] * axis + list(y.shape)
                     + [1] * (x.dim() - axis - y.dim()))


def _ew(fn):
    def lowering(ins, attrs):
        x, y = ins["X"][0], ins["Y"][0]
        return {"Out": fn(x, _bcast_y(x, y, int(attrs.get("axis", -1))))}

    return lowering


register_op("elementwise_add")(_ew(torch.add))
register_op("elementwise_mul")(_ew(torch.mul))
register_op("elementwise_div")(_ew(torch.div))
# the denominator of the norm clips (reference :46, ``jnp.maximum``; a tie
# splits the gradient in halves in both)
register_op("elementwise_max")(_ew(torch.maximum))


def _unary(fn):
    def lowering(ins, attrs):
        return {"Out": fn(ins["X"][0])}

    return lowering


# the activations the clips and the L1 regularizer emit (reference
# :97-111, ``_register_activations``)
register_op("sqrt")(_unary(torch.sqrt))
register_op("square")(_unary(torch.square))


@register_op("sign")
def sign(ins, attrs):
    """``jnp.sign``: NaN stays NaN and a zero keeps its sign, where
    ``torch.sign`` gives +0 for both. The kept NaN and zero carry no
    gradient, as sign's derivative is 0 everywhere."""
    x = ins["X"][0]
    if not x.is_floating_point():
        return {"Out": torch.sign(x)}
    keep = (x == 0) | torch.isnan(x)
    return {"Out": torch.where(keep, x.detach(), torch.sign(x))}


@register_op("clip")
def clip(ins, attrs):
    """X clamped to [min, max] (reference :190, ``jnp.clip``); with
    neither bound, X itself."""
    lo, hi = attrs.get("min"), attrs.get("max")
    if lo is None and hi is None:
        return {"Out": ins["X"][0]}
    return {"Out": torch.clamp(ins["X"][0], lo, hi)}


@register_op("isfinite", non_diff_inputs=("X",))
def isfinite(ins, attrs):
    """[1] bool: whether every element of X is finite (reference :511)."""
    return {"Out": torch.isfinite(ins["X"][0]).all().reshape(1)}


@register_op("relu")
def relu(ins, attrs):
    return {"Out": torch.relu(ins["X"][0])}


@register_op("tanh")
def tanh(ins, attrs):
    return {"Out": torch.tanh(ins["X"][0])}


@register_op("sigmoid")
def sigmoid(ins, attrs):
    return {"Out": torch.sigmoid(ins["X"][0])}


@register_op("gelu")
def gelu(ins, attrs):
    """Exact (erf) gelu, or the tanh approximation with approximate."""
    approx = "tanh" if attrs.get("approximate", False) else "none"
    return {"Out": F.gelu(ins["X"][0], approximate=approx)}


@register_op("mean")
def mean(ins, attrs):
    """Mean of every element; an integer or bool X averages in float32,
    as ``jnp.mean`` does (int32 [0..4] gives 2.0)."""
    x = ins["X"][0]
    if not x.is_floating_point():
        x = x.to(torch.float32)
    return {"Out": torch.mean(x)}


@register_op("reduce_sum")
def reduce_sum(ins, attrs):
    x = ins["X"][0]
    keep = bool(attrs.get("keep_dim", False))
    dims = attrs.get("dim")
    if attrs.get("reduce_all", False) or dims is None:
        dims = list(range(x.dim()))
    if x.dtype == torch.bool:   # jnp.sum of bool is int32 on any axes
        x = x.to(torch.int32)
    if len(dims):
        out = torch.sum(x, dim=tuple(dims), keepdim=keep)
    else:   # dim=[] reduces no axis, as jnp.sum(axis=()); torch.sum
        # would read it as every axis
        out = x.clone()
    if not x.is_floating_point():
        out = out.to(x.dtype)   # jnp.sum keeps int32 (x64 off)
    return {"Out": out}


@register_op("reduce_mean")
def reduce_mean(ins, attrs):
    """Mean over ``dim`` (every axis with reduce_all or no dim); an
    integer or bool X averages in float32, as ``jnp.mean`` does."""
    x = ins["X"][0]
    keep = bool(attrs.get("keep_dim", False))
    dims = attrs.get("dim")
    if attrs.get("reduce_all", False) or dims is None:
        dims = list(range(x.dim()))
    if not x.is_floating_point():
        x = x.to(torch.float32)
    if not len(dims):
        return {"Out": x.clone()}
    return {"Out": torch.mean(x, dim=tuple(dims), keepdim=keep)}


@register_op("matmul")
def matmul(ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    if attrs.get("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": out}


@register_op("matmul_v2")
def matmul_v2(ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    if attrs.get("trans_x", False):
        x = x.transpose(-1, -2)
    if attrs.get("trans_y", False):
        y = y.transpose(-1, -2)
    return {"Out": torch.matmul(x, y)}


@register_op("mul")
def mul(ins, attrs):
    """x flattened to 2-D at x_num_col_dims, y at y_num_col_dims."""
    x, y = ins["X"][0], ins["Y"][0]
    xd = int(attrs.get("x_num_col_dims", 1))
    yd = int(attrs.get("y_num_col_dims", 1))
    x2 = x.reshape(math.prod(x.shape[:xd]), -1)
    y2 = y.reshape(math.prod(y.shape[:yd]), -1)
    return {"Out": torch.matmul(x2, y2).reshape(
        tuple(x.shape[:xd]) + tuple(y.shape[yd:]))}


@register_op("fc")
def fc(ins, attrs):
    """Input @ W + Bias, the op ``fc_fuse_pass`` emits (reference:
    ``ops/math_ops.py:525``); in_num_col_dims flattens the leading dims
    as ``mul`` does. Bias is optional."""
    x, w = ins["Input"][0], ins["W"][0]
    bias = ins["Bias"][0] if ins.get("Bias") else None
    ncol = int(attrs.get("in_num_col_dims", 1))
    lead = tuple(x.shape[:ncol])
    out = torch.matmul(x.reshape(math.prod(lead), -1), w)
    if bias is not None:
        out = out + bias
    return {"Out": out.reshape(lead + (w.shape[-1],))}


@register_op("cross_entropy", non_diff_inputs=("Label",))
def cross_entropy(ins, attrs):
    """-log(p + 1e-8) of X's probability at the label (reference
    operators/cross_entropy_op.cc): a hard label [N, 1] or [N] is squeezed
    and gathered, a soft label dotted with log(X + 1e-8) over the last
    axis. Y keeps a trailing 1. ``ignore_index`` is carried, unused, as
    the reference's lowering leaves it. The gradient is the generic
    ``__vjp_grad__`` of this lowering."""
    x, label = ins["X"][0], ins["Label"][0]
    eps = 1e-8
    if attrs.get("soft_label", False):
        return {"Y": -(label * torch.log(x + eps)).sum(dim=-1, keepdim=True)}
    if label.dim() == x.dim() and label.shape[-1] == 1:
        label = label.squeeze(-1)
    p = torch.gather(x, -1, label.long().unsqueeze(-1))
    return {"Y": -torch.log(p + eps)}


@register_op("softmax_with_cross_entropy", non_diff_inputs=("Label",))
def softmax_with_cross_entropy(ins, attrs):
    """Fused, numerically stable; outputs Softmax and Loss. The log
    softmax is taken step by step in the logits' dtype, as the
    reference's ``jax.nn.log_softmax`` does (bf16 logits stay bf16)."""
    logits, label = ins["Logits"][0], ins["Label"][0]
    axis = int(attrs.get("axis", -1)) % logits.dim()
    shifted = logits - logits.amax(dim=axis, keepdim=True).detach()
    logp = shifted - torch.log(torch.exp(shifted).sum(dim=axis, keepdim=True))
    if attrs.get("soft_label", False):
        loss = -(label * logp).sum(dim=axis, keepdim=True)
    else:
        lbl = label
        if lbl.dim() == logits.dim() and lbl.shape[axis] == 1:
            lbl = lbl.squeeze(axis)
        ignore = int(attrs.get("ignore_index", -100))
        # clip before the gather so an ignored label cannot index out of
        # range; its loss is masked to 0 afterwards
        safe = lbl.clamp(0, logits.shape[axis] - 1).long().unsqueeze(axis)
        loss = -torch.gather(logp, axis, safe)
        loss = torch.where((lbl != ignore).unsqueeze(axis), loss,
                           torch.zeros_like(loss))
    return {"Softmax": torch.exp(logp), "Loss": loss}


@register_op("top_k", non_diff_inputs=("X",))
def top_k(ins, attrs):
    """The k largest along the last axis, lowest index first among
    equals and +0.0 before -0.0 (``jax.lax.top_k``'s order: [0, -0, 0]
    gives [[0, 2, 1]]; ``torch.topk`` promises none). Two stable sorts:
    the sign bit ascending, then the values descending, so equal values
    keep the first sort's order. Indices are int32, as every index of the
    reference is."""
    x = ins["X"][0]
    k = int(attrs.get("k", 1))
    if k > x.shape[-1]:
        raise ValueError(f"top_k: k ({k}) is larger than the last axis "
                         f"({x.shape[-1]})")
    order = None
    if x.is_floating_point():
        order = torch.sort(torch.signbit(x).to(torch.uint8), dim=-1,
                           stable=True)[1]
        x = torch.gather(x, -1, order)
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    if order is not None:
        idx = torch.gather(order, -1, idx)
    return {"Out": vals[..., :k], "Indices": idx[..., :k].to(torch.int32)}


@register_op("softmax")
def softmax(ins, attrs):
    return {"Out": torch.softmax(ins["X"][0], dim=int(attrs.get("axis", -1)))}


@register_op("accuracy", non_diff_inputs=("Out", "Indices", "Label"))
def accuracy(ins, attrs):
    """Top-k accuracy from top_k's Indices: a row counts as correct when
    any of its k indices equals its label. Accuracy is fp32 [1], Correct
    and Total int32 [1]."""
    indices, label = ins["Indices"][0], ins["Label"][0]
    if label.dim() == indices.dim() and label.shape[-1] == 1:
        correct = (indices == label).any(dim=-1)
    else:
        correct = (indices == label[..., None]).any(dim=-1)
    total = correct.numel()
    num = correct.to(torch.int32).sum(dtype=torch.int32)
    return {"Accuracy": (num.float() / float(total)).reshape(1),
            "Correct": num.reshape(1),
            "Total": torch.full((1,), total, dtype=torch.int32,
                                device=indices.device)}
