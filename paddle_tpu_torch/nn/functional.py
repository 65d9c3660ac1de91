"""paddle.nn.functional: the 2.0 functional API, in both modes.

The port of ``paddle_tpu/nn/functional.py``. ``_op`` (:35) runs an op
type through the dygraph tracer (``trace_op``) in dygraph mode and
appends it to the current block in static mode, so every function here
builds programs and runs eagerly with the same lowerings. The few
functions the reference writes as its own array function over the eager
tensors (``_masked_mean``, ``nll_loss``, ``normalize``) are torch
functions through ``trace_fn`` here.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core import unique_name
from ..core.ir import in_dygraph_mode


def _static_op(op_type, ins, attrs=None, out_slots=("Out",), n_out=None):
    """Append op to the current block, creating output vars."""
    from ..core.ir import default_main_program

    block = default_main_program().current_block()
    outs = {}
    created = []
    for slot in out_slots:
        v = block.create_var(name=unique_name.generate(f"{op_type}.{slot.lower()}"))
        outs[slot] = [v]
        created.append(v)
    block.append_op(op_type, ins, outs, dict(attrs or {}))
    return created[0] if len(created) == 1 else created


def _op(op_type, ins, attrs=None, out_slot="Out"):
    """One-output dispatch: dygraph trace_op or static append_op."""
    if in_dygraph_mode():
        from ..dygraph.tracer import trace_op

        return trace_op(op_type, ins, attrs)[out_slot][0]
    return _static_op(op_type, ins, attrs, out_slots=(out_slot,))


# -- core nn ------------------------------------------------------------------

def linear(x, weight, bias=None, name=None):
    out = _op("matmul_v2", {"X": x, "Y": weight}, {})
    if bias is not None:
        out = _op("elementwise_add", {"X": out, "Y": bias}, {"axis": -1})
    return out


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    s = [stride] * 2 if isinstance(stride, int) else list(stride)
    p = [padding] * 2 if isinstance(padding, int) else list(padding)
    d = [dilation] * 2 if isinstance(dilation, int) else list(dilation)
    out = _op("conv2d", {"Input": x, "Filter": weight},
              {"strides": s, "paddings": p, "dilations": d, "groups": groups,
               "data_format": data_format}, out_slot="Output")
    if bias is not None:
        axis = 1 if data_format == "NCHW" else -1
        out = _op("elementwise_add", {"X": out, "Y": bias}, {"axis": axis})
    return out


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCHW", name=None):
    s = [stride] * 2 if isinstance(stride, int) else list(stride)
    p = [padding] * 2 if isinstance(padding, int) else list(padding)
    d = [dilation] * 2 if isinstance(dilation, int) else list(dilation)
    out = _op("conv2d_transpose", {"Input": x, "Filter": weight},
              {"strides": s, "paddings": p, "dilations": d, "groups": groups},
              out_slot="Output")
    if bias is not None:
        out = _op("elementwise_add", {"X": out, "Y": bias}, {"axis": 1})
    return out


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    # sparse=True routes the backward through the SelectedRows grad
    # (core/selected_rows.py) — no dense [V, D] gradient buffer
    return _op("lookup_table_v2", {"Ids": x, "W": weight},
               {"padding_idx": -1 if padding_idx is None else padding_idx,
                "is_sparse": bool(sparse)})


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    ndim_norm = len(list(normalized_shape))
    x_ndim = len(x.shape)
    ins = {"X": x}
    if weight is not None:
        ins["Scale"] = weight
    if bias is not None:
        ins["Bias"] = bias
    if in_dygraph_mode():
        from ..dygraph.tracer import trace_op

        return trace_op("layer_norm", ins,
                        {"epsilon": epsilon,
                         "begin_norm_axis": x_ndim - ndim_norm})["Y"][0]
    return _static_op("layer_norm", ins,
                      {"epsilon": epsilon, "begin_norm_axis": x_ndim - ndim_norm},
                      out_slots=("Y", "Mean", "Variance"))[0]


def dropout(x, p=0.5, training=True, mode="upscale_in_train", name=None):
    """The dropout op; in dygraph mode its seed comes from numpy's global
    RNG, as the reference's does (:114), in static mode from the
    program's ``next_op_seed``."""
    from ..core.ir import default_main_program

    seed = (np.random.randint(1 << 30) if in_dygraph_mode()
            else default_main_program().next_op_seed())
    return _op("dropout", {"X": x},
               {"dropout_prob": p, "is_test": not training, "seed": seed,
                "dropout_implementation": mode})


def batch_norm(x, running_mean, running_var, weight, bias, training=False,
               momentum=0.9, epsilon=1e-5, data_format="NCHW", name=None,
               _op_type="batch_norm"):
    ins = {"X": x, "Scale": weight, "Bias": bias, "Mean": running_mean,
           "Variance": running_var}
    attrs = {"momentum": momentum, "epsilon": epsilon,
             "is_test": not training, "data_layout": data_format}
    if in_dygraph_mode():
        from ..dygraph.tracer import trace_op

        outs = trace_op(_op_type, ins, attrs)
        if training:
            # thread running stats back into the caller's buffers
            running_mean._tensor = outs["MeanOut"][0]._tensor
            running_var._tensor = outs["VarianceOut"][0]._tensor
        return outs["Y"][0]
    from ..core.ir import default_main_program

    block = default_main_program().current_block()
    y = block.create_var(name=unique_name.generate("batch_norm.y"))
    sm = block.create_var(name=unique_name.generate("batch_norm.saved_mean"))
    sv = block.create_var(name=unique_name.generate("batch_norm.saved_var"))
    block.append_op(_op_type, ins,
                    {"Y": [y], "MeanOut": [running_mean],
                     "VarianceOut": [running_var], "SavedMean": [sm],
                     "SavedVariance": [sv]}, attrs)
    return y


def sync_batch_norm(x, running_mean, running_var, weight, bias,
                    training=False, momentum=0.9, epsilon=1e-5,
                    data_format="NCHW", name=None):
    """batch_norm with cross-rank statistics (the ``sync_batch_norm`` op:
    ``batch_norm`` at world size 1; its collective form is ROADMAP A8)."""
    return batch_norm(x, running_mean, running_var, weight, bias,
                      training=training, momentum=momentum, epsilon=epsilon,
                      data_format=data_format, name=name,
                      _op_type="sync_batch_norm")


def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5, name=None):
    ins = {"X": x}
    if weight is not None:
        ins["Scale"] = weight
    if bias is not None:
        ins["Bias"] = bias
    if in_dygraph_mode():
        from ..dygraph.tracer import trace_op

        return trace_op("group_norm", ins,
                        {"groups": num_groups, "epsilon": epsilon})["Y"][0]
    return _static_op("group_norm", ins,
                      {"groups": num_groups, "epsilon": epsilon},
                      out_slots=("Y",))


# -- activations --------------------------------------------------------------

def _unary(op_type):
    def f(x, name=None):
        return _op(op_type, {"X": x}, {})

    f.__name__ = op_type
    return f


relu = _unary("relu")
sigmoid = _unary("sigmoid")
tanh = _unary("tanh")
sqrt = _unary("sqrt")
square = _unary("square")


def gelu(x, approximate=False, name=None):
    return _op("gelu", {"X": x}, {"approximate": approximate})


def leaky_relu(x, negative_slope=0.01, name=None):
    return _op("leaky_relu", {"X": x}, {"alpha": negative_slope})


def elu(x, alpha=1.0, name=None):
    return _op("elu", {"X": x}, {"alpha": alpha})


def prelu(x, weight, mode=None, name=None):
    """mode: 'all' (scalar slope) or 'channel' (per-channel slope along
    axis 1, reference prelu_op.cc channel mode). Default: inferred from
    the weight size."""
    if mode is None:
        mode = "all" if int(np.prod(weight.shape)) == 1 else "channel"
    return _op("prelu", {"X": x, "Alpha": weight}, {"mode": mode})


def hardswish(x, name=None):
    return _op("hard_swish", {"X": x}, {})


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    # 2.0 reference slope is 1/6 (nn/functional/activation.py); the op
    # default (0.2) is the fluid hard_sigmoid
    return _op("hard_sigmoid", {"X": x}, {"slope": slope,
                                          "offset": offset})


def softmax(x, axis=-1, name=None):
    return _op("softmax", {"X": x}, {"axis": axis})


def log_softmax(x, axis=-1, name=None):
    return _op("log_softmax", {"X": x}, {"axis": axis})


def swish(x, name=None):
    return _op("sigmoid", {"X": x}, {}) * x


def silu(x, name=None):
    return swish(x)


# -- pooling ------------------------------------------------------------------

def _pool(x, kernel_size, stride, padding, pool_type, ceil_mode=False,
          exclusive=True, adaptive=False):
    k = [kernel_size] * 2 if isinstance(kernel_size, int) else list(kernel_size)
    if stride is None:
        stride = k
    s = [stride] * 2 if isinstance(stride, int) else list(stride)
    p = [padding] * 2 if isinstance(padding, int) else list(padding)
    return _op("pool2d", {"X": x},
               {"ksize": k, "strides": s, "paddings": p,
                "pooling_type": pool_type, "ceil_mode": ceil_mode,
                "exclusive": exclusive, "adaptive": adaptive})


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               name=None):
    return _pool(x, kernel_size, stride, padding, "max", ceil_mode)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, name=None):
    return _pool(x, kernel_size, stride, padding, "avg", ceil_mode, exclusive)


def adaptive_avg_pool2d(x, output_size, name=None):
    o = [output_size] * 2 if isinstance(output_size, int) else list(output_size)
    return _op("pool2d", {"X": x},
               {"ksize": o, "strides": o, "paddings": [0, 0],
                "pooling_type": "avg", "adaptive": True})


def adaptive_max_pool2d(x, output_size, name=None):
    o = [output_size] * 2 if isinstance(output_size, int) else list(output_size)
    return _op("pool2d", {"X": x},
               {"ksize": o, "strides": o, "paddings": [0, 0],
                "pooling_type": "max", "adaptive": True})


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, data_format="NCHW", name=None):
    attrs = {"interp_method": mode, "align_corners": align_corners}
    if size is not None:
        attrs["out_h"], attrs["out_w"] = int(size[0]), int(size[1])
    if scale_factor is not None:
        if isinstance(scale_factor, (list, tuple)):
            attrs["scale_h"] = float(scale_factor[0])
            attrs["scale_w"] = float(scale_factor[1])
        else:
            attrs["scale"] = float(scale_factor)
    return _op("interpolate", {"X": x}, attrs)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, name=None):
    return interpolate(x, size, scale_factor, mode, align_corners)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    return _op("pad2d", {"X": x},
               {"paddings": list(pad), "mode": mode, "pad_value": value,
                "data_format": data_format})


# -- losses -------------------------------------------------------------------

def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False):
    ins = {"Logits": logits, "Label": label}
    attrs = {"soft_label": soft_label, "ignore_index": ignore_index,
             "axis": axis}
    if in_dygraph_mode():
        from ..dygraph.tracer import trace_op

        outs = trace_op("softmax_with_cross_entropy", ins, attrs)
        if return_softmax:
            return outs["Loss"][0], outs["Softmax"][0]
        return outs["Loss"][0]
    res = _static_op("softmax_with_cross_entropy", ins, attrs,
                     out_slots=("Softmax", "Loss"))
    return (res[1], res[0]) if return_softmax else res[1]


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1, name=None):
    if weight is not None and not soft_label:
        # per-class weights: route through nll_loss, which owns the
        # weighted-mean semantics (divide by summed weights of valid entries)
        return nll_loss(log_softmax(input, axis=axis), label, weight=weight,
                        ignore_index=ignore_index, reduction=reduction)
    loss = softmax_with_cross_entropy(input, label, soft_label=soft_label,
                                      ignore_index=ignore_index, axis=axis)
    if reduction == "mean" and not soft_label:
        # mean over the NON-ignored entries only (reference:
        # python/paddle/nn/functional/loss.py cross_entropy divides by the
        # valid-token count, not the batch size)
        return _masked_mean(loss, label, ignore_index)
    return _reduce_loss(loss, reduction)


def _masked_mean(loss, label, ignore_index):
    if in_dygraph_mode():
        import torch

        from ..dygraph.tracer import trace_fn
        from ..dygraph.varbase import as_tensor

        lbl = as_tensor(label).detach()
        return trace_fn(
            lambda l: torch.sum(l) / torch.clamp(
                torch.sum((lbl != ignore_index).to(l.dtype)), min=1.0),
            loss)
    from .. import layers

    valid = layers.cast(layers.not_equal(label, ignore_index), "float32")
    count = layers.reduce_sum(valid)
    return _op("elementwise_div",
               {"X": _op("reduce_sum", {"X": loss}, {"reduce_all": True}),
                "Y": _op("elementwise_max",
                         {"X": count,
                          "Y": layers.fill_constant([1], "float32", 1.0)},
                         {})}, {})


def _reduce_loss(loss, reduction):
    if reduction == "mean":
        return _op("mean", {"X": loss}, {})
    if reduction == "sum":
        return _op("reduce_sum", {"X": loss},
                   {"dim": [0], "reduce_all": True, "keep_dim": False}) \
            if not in_dygraph_mode() else loss.sum()
    return loss


def mse_loss(input, label, reduction="mean", name=None):
    # the op's slots are Input and Label: the reference passes X and Y
    # and raises KeyError (ROADMAP, the reference's faults)
    loss = _op("square_error_cost", {"Input": input, "Label": label}, {})
    return _reduce_loss(loss, reduction)


def l1_loss(input, label, reduction="mean", name=None):
    d = input - label
    if in_dygraph_mode():
        a = d.abs()
        return a.mean() if reduction == "mean" else \
            (a.sum() if reduction == "sum" else a)
    from .. import layers

    a = layers.abs(d)
    if reduction == "mean":
        return layers.reduce_mean(a)
    if reduction == "sum":
        return layers.reduce_sum(a)
    return a


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    if weight is None and pos_weight is None:
        loss = _op("sigmoid_cross_entropy_with_logits",
                   {"X": logit, "Label": label}, {})
    else:
        # loss = pos_weight·z·softplus(−x) + (1−z)·softplus(x)  [torch/paddle]
        sp_neg = _op("softplus",
                     {"X": _op("scale", {"X": logit}, {"scale": -1.0})}, {})
        sp_pos = _op("softplus", {"X": logit}, {})
        pos_term = _op("elementwise_mul", {"X": label, "Y": sp_neg}, {})
        if pos_weight is not None:
            pos_term = _op("elementwise_mul",
                           {"X": pos_term, "Y": pos_weight}, {"axis": -1})
        one_minus = _op("scale", {"X": label}, {"scale": -1.0, "bias": 1.0})
        neg_term = _op("elementwise_mul", {"X": one_minus, "Y": sp_pos}, {})
        loss = _op("elementwise_add", {"X": pos_term, "Y": neg_term}, {})
        if weight is not None:
            loss = _op("elementwise_mul", {"X": loss, "Y": weight}, {"axis": -1})
    return _reduce_loss(loss, reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    loss = _op("smooth_l1_loss", {"X": input, "Y": label}, {"sigma": delta})
    return _reduce_loss(loss, reduction)


def kl_div(input, label, reduction="mean", name=None):
    # the op's output slot is Loss: the reference reads Out and raises
    # KeyError (ROADMAP, the reference's faults)
    loss = _op("kldiv_loss", {"X": input, "Target": label},
               {"reduction": "none"}, out_slot="Loss")
    return _reduce_loss(loss, reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """input is log-probabilities: gather the target entry, negate.
    Honors per-class ``weight`` and ``ignore_index`` (weighted mean divides
    by the summed weights of non-ignored entries, torch/paddle semantics)."""
    if in_dygraph_mode():
        import torch

        from ..dygraph.tracer import trace_fn
        from ..dygraph.varbase import as_tensor

        lbl = as_tensor(label).detach()
        w = None if weight is None else as_tensor(weight).detach()

        def f(logp):
            lb = lbl.reshape(-1).long()
            lp = logp.reshape(-1, logp.shape[-1])
            safe = lb.clamp(0, lp.shape[-1] - 1)
            picked = -torch.gather(lp, 1, safe[:, None])[:, 0]
            valid = (lb != ignore_index).to(lp.dtype)
            wts = valid if w is None else valid * w[safe]
            picked = picked * wts
            if reduction == "mean":
                return torch.sum(picked) / torch.clamp(torch.sum(wts),
                                                       min=1e-12)
            if reduction == "sum":
                return torch.sum(picked)
            return picked.reshape(lbl.shape)

        return trace_fn(f, input)
    from .. import layers

    if label.shape and len(label.shape) > 1 and label.shape[-1] == 1:
        label = layers.squeeze(label, [-1])
    oh = layers.cast(one_hot(label, input.shape[-1]), "float32")
    if weight is not None:
        # scale each one-hot row by its class weight; the weighted mean
        # divides by summed weights of non-ignored entries (torch semantics)
        oh = layers.elementwise_mul(oh, weight, axis=-1)
    prod = layers.elementwise_mul(input, oh)
    loss = layers.scale(layers.reduce_sum(prod, dim=-1), scale=-1.0)
    valid = layers.cast(layers.not_equal(label, ignore_index), "float32")
    loss = layers.elementwise_mul(loss, valid)
    denom_w = layers.reduce_sum(layers.elementwise_mul(
        layers.reduce_sum(oh, dim=-1), valid))
    if reduction == "mean":
        eps = layers.fill_constant([1], "float32", 1e-12)
        return layers.elementwise_div(
            layers.reduce_sum(loss), layers.elementwise_max(denom_w, eps))
    if reduction == "sum":
        return layers.reduce_sum(loss)
    return loss


# -- misc ---------------------------------------------------------------------

def one_hot(x, num_classes, name=None):
    return _op("one_hot_v2", {"X": x}, {"depth": num_classes})


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    return _op("label_smooth", {"X": label}, {"epsilon": epsilon})


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    return _normalize_impl(x, p, axis, epsilon)


def _normalize_impl(x, p, axis, epsilon):
    if in_dygraph_mode():
        import torch

        from ..dygraph.tracer import trace_fn

        return trace_fn(
            lambda a: a / torch.clamp(torch.linalg.vector_norm(
                a, ord=p, dim=axis, keepdim=True), min=epsilon), x)
    from .. import layers

    return layers.l2_normalize(x, axis=axis, epsilon=epsilon)


# -- the activation tail and misc functions (2.0 API surface:
# python/paddle/nn/functional/activation.py etc.) ---------------------------

def _unary_op(op_type, x, attrs=None, out_slot="Out"):
    return _op(op_type, {"X": x}, attrs or {}, out_slot=out_slot)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return _unary_op("selu", x, {"scale": scale, "alpha": alpha})


def hardshrink(x, threshold=0.5, name=None):
    return _unary_op("hard_shrink", x, {"threshold": threshold})


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return _unary_op("brelu", x, {"t_min": float(min), "t_max": float(max)})


def log_sigmoid(x, name=None):
    return _unary_op("logsigmoid", x)


def relu6(x, name=None):
    return _unary_op("relu6", x, {"threshold": 6.0})


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return _unary_op("softplus", x, {"beta": beta, "threshold": threshold})


def softshrink(x, threshold=0.5, name=None):
    return _unary_op("softshrink", x, {"lambda": threshold})


def softsign(x, name=None):
    return _unary_op("softsign", x)


def tanhshrink(x, name=None):
    return _unary_op("tanh_shrink", x)


def thresholded_relu(x, threshold=1.0, name=None):
    return _unary_op("thresholded_relu", x, {"threshold": threshold})


def pixel_shuffle(x, upscale_factor, name=None):
    return _unary_op("pixel_shuffle", x, {"upscale_factor": int(upscale_factor)})


def local_response_norm(x, size=5, alpha=1e-4, beta=0.75, k=1.0, name=None):
    return _unary_op("lrn", x, {"n": int(size), "alpha": alpha, "beta": beta,
                             "k": k})


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    """Composed from reduction ops, as the reference's is."""
    def rsum(v):
        return _op("reduce_sum", {"X": v}, {"dim": [axis]})

    dot = rsum(x1 * x2)
    n1 = sqrt(rsum(square(x1)))
    n2 = sqrt(rsum(square(x2)))
    eps_t = _op("fill_constant", {}, {"shape": [1], "value": eps,
                                      "dtype": str(x1.dtype)})
    denom = _op("elementwise_max", {"X": n1 * n2, "Y": eps_t}, {})
    return dot / denom


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False):
    """reference: nn/layer/distance.py PairwiseDistance."""
    d = x - y

    def rsum(v):
        return _op("reduce_sum", {"X": v},
                   {"dim": [-1], "keep_dim": keepdim})

    if p == 2.0:
        return sqrt(rsum(square(d)) + epsilon)
    ad = _op("abs", {"X": d}, {}) + epsilon
    s = rsum(_op("pow", {"X": ad}, {"factor": float(p)}))
    return _op("pow", {"X": s}, {"factor": 1.0 / float(p)})


def dropout2d(x, p=0.5, training=True, name=None):
    """Channel-wise dropout (reference nn/functional/common.py
    dropout2d): one Bernoulli per (N, C), broadcast over HxW — built
    from the dropout op on a [N, C, 1, 1] mask source."""
    if not training or p == 0.0:
        return x
    ones = _op("fill_constant_batch_size_like", {"Input": x},
               {"shape": [-1, int(x.shape[1]), 1, 1], "value": 1.0,
                "dtype": str(x.dtype)})
    mask = dropout(ones, p=p, training=True)
    return x * mask


def dropout3d(x, p=0.5, training=True, name=None):
    if not training or p == 0.0:
        return x
    ones = _op("fill_constant_batch_size_like", {"Input": x},
               {"shape": [-1, int(x.shape[1]), 1, 1, 1], "value": 1.0,
                "dtype": str(x.dtype)})
    mask = dropout(ones, p=p, training=True)
    return x * mask


def bilinear(x1, x2, weight, bias=None, name=None):
    """reference: nn/functional/common.py bilinear over
    bilinear_tensor_product_op.cc."""
    ins = {"X": x1, "Y": x2, "Weight": weight}
    if bias is not None:
        ins["Bias"] = bias
    return _op("bilinear_tensor_product", ins, {})
