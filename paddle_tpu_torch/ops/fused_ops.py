"""Fused inference ops that the predictor's passes emit (port of
``paddle_tpu/ops/fused_ops.py``: fused_embedding_eltwise_layernorm :43,
fused_elemwise_activation :121, fusion_group :177).

Each is a composition of plain PyTorch calls, as the reference's are of
jnp calls: no TPU kernel sits behind them. ``multihead_matmul`` (:20),
which no default pass emits, and the file's other ops are not ported
yet."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import registry
from ..core.registry import register_op
from .tensor_ops import take_index


@register_op("fused_embedding_eltwise_layernorm", non_diff_inputs=("Ids",))
def fused_embedding_eltwise_layernorm(ins, attrs):
    """The sum of N embedding lookups, layer-normalised over the last
    axis (the BERT embedding stack). Negative ids wrap and out-of-range
    ids clamp, as the reference's ``e[ids]`` does."""
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    eps = float(attrs.get("epsilon", 1e-5))
    acc = None
    for ids, emb in zip(ins["Ids"], ins["Embs"]):
        idx, _ = take_index(ids, emb.shape[0])
        v = torch.index_select(emb, 0, idx).reshape(
            tuple(ids.shape) + tuple(emb.shape[1:]))
        acc = v if acc is None else acc + v
    mean = acc.mean(-1, keepdim=True)
    var = (acc - mean).square().mean(-1, keepdim=True)
    return {"Out": (acc - mean) * torch.rsqrt(var + eps) * scale + bias}


def _unary(name, attrs):
    return {"relu": torch.relu, "sigmoid": torch.sigmoid,
            "tanh": torch.tanh,
            "scale": lambda v: v * float(attrs.get("scale", 1.0)),
            # the standalone gelu op's default: the erf form
            "gelu": lambda v: F.gelu(
                v, approximate="tanh" if attrs.get("approximate", False)
                else "none")}[name]


_BINARY = {"elementwise_add": torch.add, "elementwise_sub": torch.sub,
           "elementwise_mul": torch.mul}


@register_op("fused_elemwise_activation", required_attrs=("functor_list",))
def fused_elemwise_activation(ins, attrs):
    """A binary elementwise op and a unary activation in one op;
    functor_list ["elementwise_add", "relu"] is relu(x + y), and
    ["relu", "elementwise_add"] is x + relu(y)."""
    x, y = ins["X"][0], ins["Y"][0]
    f0, f1 = list(attrs["functor_list"])
    if f0 in _BINARY:
        inter = _BINARY[f0](x, y)
        out = _unary(f1, attrs)(inter)
    elif f1 in _BINARY:
        inter = _unary(f0, attrs)(y)
        out = _BINARY[f1](inter, x)
    else:
        raise ValueError(f"unsupported functor_list {[f0, f1]}")
    return {"Out": out, "IntermediateOut": inter}


@register_op("fusion_group", skip_infer_shape=True,
             required_attrs=("sub_ops", "ext_in_names", "ext_out_names"))
def fusion_group(ins, attrs):
    """A run of elementwise ops packed by ``fusion_group_pass``, replayed
    in order through their registered lowerings. The runtime step
    (``__step__``) reaches every sub-op, so op by op a grouped dropout
    draws the mask the ungrouped op would; a compiled step has no seed
    slot for it and refuses it (``rng.unseeded_random_ops``)."""
    env = dict(zip(list(attrs["ext_in_names"]), list(ins["X"])))
    for sub in attrs["sub_ops"]:
        sub_attrs = dict(sub["attrs"])
        if "__step__" in attrs:
            sub_attrs["__step__"] = attrs["__step__"]
        sub_ins = {slot: [env[n] for n in names]
                   for slot, names in sub["inputs"].items()}
        outs = registry.normalize_outputs(
            registry.get(sub["type"]).forward(sub_ins, sub_attrs))
        for slot, names in sub["outputs"].items():
            for n, v in zip(names, outs.get(slot) or ()):
                env[n] = v
    return {"Out": [env[n] for n in attrs["ext_out_names"]]}
