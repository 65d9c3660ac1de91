"""Math lowerings (port of ``paddle_tpu/ops/math_ops.py``: elementwise
:38-46, relu :90, tanh :93, gelu :141, reduce_sum :231, mean :238, matmul
:267, matmul_v2 :285, mul :297, softmax_with_cross_entropy :361, top_k
:466).

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


@register_op("relu")
def relu(ins, attrs):
    return {"Out": torch.relu(ins["X"][0])}


@register_op("tanh")
def tanh(ins, attrs):
    return {"Out": torch.tanh(ins["X"][0])}


@register_op("gelu")
def gelu(ins, attrs):
    """Exact (erf) gelu, or the tanh approximation with approximate."""
    approx = "tanh" if attrs.get("approximate", False) else "none"
    return {"Out": F.gelu(ins["X"][0], approximate=approx)}


@register_op("mean")
def mean(ins, attrs):
    return {"Out": torch.mean(ins["X"][0])}


@register_op("reduce_sum")
def reduce_sum(ins, attrs):
    x = ins["X"][0]
    keep = bool(attrs.get("keep_dim", False))
    dims = attrs.get("dim")
    if attrs.get("reduce_all", False) or dims is None:
        dims = list(range(x.dim()))
    out = torch.sum(x, dim=tuple(dims), keepdim=keep)
    if not x.is_floating_point() and x.dtype != torch.bool:
        out = out.to(x.dtype)   # jnp.sum keeps int32 (x64 off)
    return {"Out": out}


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
    equals (``jax.lax.top_k``'s order; ``torch.topk`` promises none, so
    this is a stable descending sort). Indices are int32, as every
    index of the reference is."""
    x = ins["X"][0]
    k = int(attrs.get("k", 1))
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return {"Out": vals[..., :k], "Indices": idx[..., :k].to(torch.int32)}
