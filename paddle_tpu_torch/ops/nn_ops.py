"""Neural-net lowerings (port of ``paddle_tpu/ops/nn_ops.py``: conv2d
:32, pool2d :93, batch_norm :378, layer_norm :401, dropout :453,
label_smooth :543)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core import rng
from ..core.registry import register_op


@register_op("layer_norm")
def layer_norm(ins, attrs):
    """Normalise the trailing dims from begin_norm_axis, in fp32, then
    scale and bias. Y and Mean come from one ``torch.native_layer_norm``
    call; Variance is the mean of squared deviations over the same axes,
    as the reference computes it (recovering it from the call's
    1/sqrt(var + eps) would go negative on constant rows)."""
    x = ins["X"][0]
    scale = ins["Scale"][0] if ins.get("Scale") else None
    bias = ins["Bias"][0] if ins.get("Bias") else None
    eps = attrs.get("epsilon", 1e-5)
    axis = int(attrs.get("begin_norm_axis", 1))
    norm_shape = tuple(x.shape[axis:])
    lead = tuple(x.shape[:axis])
    xf = x.float()
    y, mean, _ = torch.native_layer_norm(
        xf, norm_shape,
        None if scale is None else scale.reshape(norm_shape).float(),
        None if bias is None else bias.reshape(norm_shape).float(), eps)
    var = torch.var(xf, dim=tuple(range(axis, x.dim())), correction=0)
    return {"Y": y.to(x.dtype), "Mean": mean.reshape(lead),
            "Variance": var.reshape(lead)}


@register_op("dropout")
def dropout(ins, attrs):
    """Seed assigned at build; the run folds in the global step, so masks
    differ per step but stay reproducible. The keep mask is the
    reference's splitmix32 hash over the element lattice
    (``core/rng.dropout_keep``), bit for bit; from ``rng.THREEFRY_MIN``
    (2^32) elements, where that lattice would alias, the reference's
    threefry ``bernoulli`` (``_threefry_dropout``). upscale_in_train
    divides the kept values by 1 - p in x's dtype."""
    x = ins["X"][0]
    p = float(attrs.get("dropout_prob", 0.5))
    impl = attrs.get("dropout_implementation", "upscale_in_train")
    if bool(attrs.get("is_test", False)) or p == 0.0:
        out = x if impl == "upscale_in_train" else x * (1.0 - p)
        return {"Out": out, "Mask": torch.ones(x.shape, dtype=torch.uint8,
                                               device=x.device)}
    if x.numel() >= rng.THREEFRY_MIN and x.device.type != "meta":
        return _threefry_dropout(x, p, impl, rng.op_key(attrs))
    if x.device.type == "meta":
        keep = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    else:
        keep = rng.dropout_keep(x.shape, rng.op_seed(attrs), p, x.device)
    kept = x / (1.0 - p) if impl == "upscale_in_train" else x
    return {"Out": torch.where(keep, kept, torch.zeros_like(kept)),
            "Mask": keep.to(torch.uint8)}


def _threefry_dropout(x, p, impl, key):
    """The dropout of a tensor of 2^32 or more elements: the threefry keep
    mask (``rng.threefry_keep``) and the output, chunk by chunk of the
    flat index, into Out and Mask allocated once, so that beside them
    only one chunk's temporaries exist. Each chunk's output is the small
    path's expression on that chunk, bit for bit."""
    rng.threefry_masks += 1
    flat = x.reshape(-1)
    out = torch.empty_like(flat)
    mask = torch.empty(flat.shape, dtype=torch.uint8, device=x.device)
    n = flat.numel()
    for lo in range(0, n, rng.THREEFRY_CHUNK):
        hi = min(lo + rng.THREEFRY_CHUNK, n)
        keep = rng.threefry_keep(key, p, lo, hi, x.device)
        xc = flat[lo:hi]
        kept = xc / (1.0 - p) if impl == "upscale_in_train" else xc
        out[lo:hi] = torch.where(keep, kept, torch.zeros_like(kept))
        mask[lo:hi] = keep
    return {"Out": out.reshape(x.shape), "Mask": mask.reshape(x.shape)}


@register_op("label_smooth", non_diff_inputs=("PriorDist",))
def label_smooth(ins, attrs):
    """x * (1 - eps) + eps / k over the last axis's k classes (the
    uniform prior; PriorDist is read by neither package)."""
    x = ins["X"][0]
    eps = attrs.get("epsilon", 0.1)
    return {"Out": x * (1.0 - eps) + eps / x.shape[-1]}


# ---------------------------------------------------------------------------
# conv2d :32, pool2d :93, batch_norm :378 (the ResNet path)
# ---------------------------------------------------------------------------

def _explicit_pads(attrs, x, ksize, strides, dilations):
    """[(lo, hi), (lo, hi)] for H and W from the op's paddings and
    padding_algorithm, as ``_conv_padding`` :18 reads them: SAME pads
    (as XLA does) to ceil(in / stride) outputs, low side first."""
    algo = attrs.get("padding_algorithm", "EXPLICIT")
    if algo == "VALID":
        return [(0, 0), (0, 0)]
    if algo == "SAME":
        pads = []
        for size, k, s, d in zip(x.shape[2:], ksize, strides, dilations):
            total = max((-(-size // s) - 1) * s + (k - 1) * d + 1 - size, 0)
            pads.append((total // 2, total - total // 2))
        return pads
    p = [int(v) for v in attrs.get("paddings", [0, 0])]
    if len(p) == 2:
        return [(p[0], p[0]), (p[1], p[1])]
    if len(p) == 4:
        return [(p[0], p[1]), (p[2], p[3])]
    return [(0, 0), (0, 0)]


def _pad_hw(x, pads, value=0.0):
    (t, b), (l, r) = pads
    if not (t or b or l or r):
        return x
    return F.pad(x, (l, r, t, b), value=value)


@register_op("conv2d")
def conv2d(ins, attrs):
    """NCHW input, OIHW filter, through ``F.conv2d`` (cuDNN on the card),
    as the reference leaves its convs to ``lax.conv_general_dilated``.
    bf16 inputs give a bf16 output; fp32 convs run in full fp32 when the
    caller has switched TF32 off."""
    x, w = ins["Input"][0], ins["Filter"][0]
    strides = [int(s) for s in attrs.get("strides", [1, 1])]
    dilations = [int(d) for d in attrs.get("dilations", [1, 1])]
    pads = _explicit_pads(attrs, x, w.shape[2:], strides, dilations)
    if pads[0][0] == pads[0][1] and pads[1][0] == pads[1][1]:
        padding = (pads[0][0], pads[1][0])
    else:
        x, padding = _pad_hw(x, pads), 0
    return {"Output": F.conv2d(x, w, stride=strides, padding=padding,
                               dilation=dilations,
                               groups=int(attrs.get("groups", 1)))}


@register_op("pool2d")
def pool2d(ins, attrs):
    """Max or average pooling, NCHW. Global pooling (or adaptive to 1x1)
    reduces H and W; adaptive pooling takes ksize as the output size with
    the floor/ceil cell bounds of ``AdaptStartIndex``/``AdaptEndIndex``
    (PyTorch's adaptive pools use the same bounds). Padding is explicit:
    max pools see -inf, average pools zeros, and ``exclusive`` divides by
    the cells inside the input (only under explicit paddings, as the
    reference does)."""
    x = ins["X"][0]
    ptype = attrs.get("pooling_type", "max")
    ksize = tuple(int(k) for k in attrs.get("ksize", [2, 2]))
    adaptive = bool(attrs.get("adaptive", False))
    if attrs.get("global_pooling", False) or adaptive and ksize == (1, 1):
        if ptype == "max":
            return {"Out": x.amax(dim=(2, 3), keepdim=True)}
        return {"Out": x.mean(dim=(2, 3), keepdim=True)}
    if adaptive:
        fn = F.adaptive_max_pool2d if ptype == "max" \
            else F.adaptive_avg_pool2d
        return {"Out": fn(x, ksize)}
    strides = tuple(int(s) for s in attrs.get("strides", ksize))
    pads = _explicit_pads(attrs, x, ksize, strides, (1, 1))
    if ptype == "max":
        lowest = float("-inf") if x.is_floating_point() \
            else torch.iinfo(x.dtype).min
        return {"Out": F.max_pool2d(_pad_hw(x, pads, lowest), ksize,
                                    strides)}
    cells = float(ksize[0] * ksize[1])
    summed = F.avg_pool2d(_pad_hw(x, pads), ksize, strides) * cells
    explicit = attrs.get("padding_algorithm", "EXPLICIT") not in (
        "SAME", "VALID")
    if attrs.get("exclusive", True) and explicit:
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        counts = F.avg_pool2d(_pad_hw(ones, pads), ksize, strides) * cells
        return {"Out": summed / counts}
    return {"Out": summed / cells}


def _channel_axes(x, layout):
    """(reduction axes, broadcast shape of a per-channel vector)."""
    c_axis = 1 if layout == "NCHW" else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != c_axis)
    bshape = [1] * x.dim()
    bshape[c_axis] = x.shape[c_axis]
    return axes, bshape


@register_op("batch_norm")
def batch_norm(ins, attrs):
    """Batch normalisation (reference ``_batch_norm_impl`` :324), in the
    reference's formulas: batch statistics from fp32 sums, variance as
    E[x^2] - mean^2; the affine in x's dtype, each factor cast to it:
    (x - mean) * (inv * scale) + bias. MeanOut/VarianceOut carry the
    momentum update of the running statistics (the program names the stat
    vars as both input and output; this lowering returns new tensors, so
    a ``__vjp_grad__`` recompute reads unchanged inputs). SavedMean and
    SavedVariance are the batch mean and 1 / sqrt(var + eps); zeros under
    ``is_test`` or ``use_global_stats``."""
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = float(attrs.get("epsilon", 1e-5))
    momentum = float(attrs.get("momentum", 0.9))
    axes, bshape = _channel_axes(x, attrs.get("data_layout", "NCHW"))
    if attrs.get("is_test", False) or attrs.get("use_global_stats", False):
        use_mean, use_var = mean, var
        mean_out, var_out = mean, var
        saved_mean, saved_var = torch.zeros_like(mean), torch.zeros_like(var)
    else:
        xf = x.float()
        cnt = float(math.prod(x.shape[a] for a in axes))
        use_mean = xf.sum(dim=axes) / cnt
        use_var = (xf * xf).sum(dim=axes) / cnt - use_mean * use_mean
        mean_out = mean * momentum + use_mean * (1.0 - momentum)
        var_out = var * momentum + use_var * (1.0 - momentum)
        saved_mean, saved_var = use_mean, 1.0 / torch.sqrt(use_var + eps)
    inv = 1.0 / torch.sqrt(use_var.float() + eps)
    y = (x - use_mean.reshape(bshape).to(x.dtype)) \
        * (inv * scale.float()).reshape(bshape).to(x.dtype) \
        + bias.reshape(bshape).to(x.dtype)
    return {"Y": y, "MeanOut": mean_out, "VarianceOut": var_out,
            "SavedMean": saved_mean, "SavedVariance": saved_var}
