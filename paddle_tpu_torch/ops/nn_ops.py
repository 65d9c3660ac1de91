"""Neural-net lowerings (port of ``paddle_tpu/ops/nn_ops.py``: conv2d
:32, conv2d_transpose :58, pool2d :93, hierarchical_sigmoid :285,
batch_norm :378, sync_batch_norm :386, layer_norm :401, group_norm :430,
dropout :453, interpolate :496, pad2d :517, prelu :532, label_smooth
:543)."""

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


# -- the 2.0 nn layers' op types ----------------------------------------------

def _lax_pads(attrs, k, d):
    """The (lo, hi) padding of the stride-1 conv over the dilated input
    for one spatial dim, where the reference's conv2d_transpose gives one
    of its own: none for VALID. None for explicit paddings (the caller
    takes k - 1 - p); SAME raises ValueError, as the reference's
    lhs-dilated conv does."""
    algo = attrs.get("padding_algorithm", "EXPLICIT")
    if algo == "VALID":
        return 0, 0
    if algo == "SAME":
        raise ValueError("conv2d_transpose takes explicit paddings or "
                         "VALID, not SAME")
    return None


@register_op("conv2d_transpose")
def conv2d_transpose(ins, attrs):
    """Transposed conv with paddle's IOHW filter [in_c, out_c/groups, kh,
    kw], as the reference computes it (:58): the input dilated by the
    strides (zeros between rows and columns), padded by k - 1 - p on each
    side (a negative pad crops), then a stride-1 conv with the per-group
    transposed, spatially flipped filter and the dilations."""
    x, w = ins["Input"][0], ins["Filter"][0]
    strides = [int(s) for s in attrs.get("strides", [1, 1])]
    dilations = [int(d) for d in attrs.get("dilations", [1, 1])]
    groups = int(attrs.get("groups", 1))
    in_c, out_pg, kh, kw = w.shape
    pads = []
    explicit = _explicit_pads({"paddings": attrs.get("paddings", [0, 0])},
                              x, (kh, kw), strides, dilations)
    for i, (k, d) in enumerate(((kh, dilations[0]), (kw, dilations[1]))):
        lp = _lax_pads(attrs, k, d)
        if lp is None:
            lo, hi = explicit[i]
            lp = (k - 1 - lo, k - 1 - hi)
        pads.append(lp)
    n, c, h, wd = x.shape
    sh, sw = strides
    xd = x.new_zeros((n, c, (h - 1) * sh + 1, (wd - 1) * sw + 1))
    xd[:, :, ::sh, ::sw] = x
    xd = F.pad(xd, (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
    w_t = w.reshape(groups, in_c // groups, out_pg, kh, kw) \
        .transpose(1, 2).reshape(groups * out_pg, in_c // groups, kh, kw) \
        .flip(2, 3)
    return {"Output": F.conv2d(xd, w_t, dilation=dilations, groups=groups)}


@register_op("hierarchical_sigmoid", non_diff_inputs=("Label", "PathTable",
                                                      "PathCode"))
def hierarchical_sigmoid(ins, attrs):
    """Hierarchical softmax over the default complete binary tree
    (row ((c + C) >> (i + 1)) - 1 of W and bit ((c + C) >> i) & 1 at
    level i, for label c of C classes) or a custom tree (PathTable /
    PathCode, -1 ends a path): Out [B, 1] is the sum over the path of
    softplus(pre) - bit * pre, PreOut the pre-activations (0 past the
    path's end)."""
    x, w = ins["X"][0], ins["W"][0]
    label = ins["Label"][0].reshape(-1).long()
    bias = (ins.get("Bias") or [None])[0]
    path = (ins.get("PathTable") or [None])[0]
    code = (ins.get("PathCode") or [None])[0]
    if path is None:
        c = int(attrs["num_classes"])
        max_len = int(math.floor(math.log2(max(c - 1, 1)))) + 1
        lc = label + c
        i = torch.arange(max_len, device=x.device)
        idx = (lc[:, None] >> (i[None, :] + 1)) - 1
        bit = (lc[:, None] >> i[None, :]) & 1
    else:
        idx, bit = path.long(), code.long()
    valid = idx >= 0
    idx_c = torch.where(valid, idx, torch.zeros_like(idx))
    pre = torch.einsum("bd,bld->bl", x, w[idx_c])
    if bias is not None:
        pre = pre + bias.reshape(-1)[idx_c]
    cost = F.softplus(pre) - bit.to(pre.dtype) * pre
    cost = torch.where(valid, cost, torch.zeros_like(cost))
    return {"Out": cost.sum(dim=1, keepdim=True),
            "PreOut": torch.where(valid, pre, torch.zeros_like(pre))}


@register_op("sync_batch_norm")
def sync_batch_norm(ins, attrs):
    """batch_norm with statistics summed over the data-parallel ranks. At
    world size 1 it is ``batch_norm`` exactly, as the reference's lowering
    is outside an SPMD region (:386); the collective form (ROADMAP A8)
    raises in a process group of more than one rank."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            "sync_batch_norm across ranks is not in the port yet "
            "(ROADMAP A8); at world size 1 it is batch_norm")
    return batch_norm(ins, attrs)


@register_op("group_norm")
def group_norm(ins, attrs):
    """Normalise each of ``groups`` channel groups over its channels and
    spatial dims, in x's dtype; Mean and Variance are [N, groups]."""
    x = ins["X"][0]
    scale = ins["Scale"][0] if ins.get("Scale") else None
    bias = ins["Bias"][0] if ins.get("Bias") else None
    g = int(attrs.get("groups", 1))
    eps = float(attrs.get("epsilon", 1e-5))
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, g, c // g) + tuple(x.shape[2:]))
    axes = tuple(range(2, xg.dim()))
    mean = xg.mean(dim=axes, keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=axes, keepdim=True)
    y = ((xg - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    bshape = (1, c) + (1,) * (x.dim() - 2)
    if scale is not None:
        y = y * scale.reshape(bshape)
    if bias is not None:
        y = y + bias.reshape(bshape)
    return {"Y": y, "Mean": mean.reshape(n, g),
            "Variance": var.reshape(n, g)}


def _resize_weights(size_in, size_out, dtype, device):
    """``jax.image.resize``'s linear weight matrix [in, out] for one dim
    (``compute_weight_mat``, antialiased: the triangle kernel widens by
    in / out when shrinking), columns normalised to sum 1, zero for a
    sample outside the input."""
    inv_scale = size_in / size_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(size_out, dtype=torch.float32, device=device)
              + 0.5) * inv_scale - 0.5
    src = torch.arange(size_in, dtype=torch.float32, device=device)
    dist = torch.abs(sample[None, :] - src[:, None]) / kernel_scale
    wts = torch.clamp(1.0 - dist, min=0.0)
    total = wts.sum(dim=0, keepdim=True)
    eps = torch.finfo(torch.float32).eps
    wts = torch.where(torch.abs(total) > 1000.0 * eps,
                      wts / torch.where(total != 0, total,
                                        torch.ones_like(total)),
                      torch.zeros_like(wts))
    inside = (sample >= -0.5) & (sample <= size_in - 0.5)
    return torch.where(inside[None, :], wts, torch.zeros_like(wts)).to(dtype)


@register_op("interpolate")
@register_op("nearest_interp")
@register_op("bilinear_interp")
def interpolate(ins, attrs):
    """Resize H and W to out_h/out_w (or the input's times scale/scale_h/
    scale_w) as ``jax.image.resize`` does in the reference (:496):
    "nearest" takes row floor((i + 0.5) * in / out); otherwise linear with
    half-pixel centres and antialiasing, applied per dim as a weight
    matrix. ``align_corners`` is read by neither."""
    x = ins["X"][0]
    out_h = int(attrs.get("out_h", 0) or 0)
    out_w = int(attrs.get("out_w", 0) or 0)
    scale = attrs.get("scale", 0) or 0
    scale_h = attrs.get("scale_h", scale) or 0
    scale_w = attrs.get("scale_w", scale) or 0
    if not out_h and scale_h:
        out_h = int(x.shape[2] * scale_h)
    if not out_w and scale_w:
        out_w = int(x.shape[3] * scale_w)
    nearest = "nearest" in attrs.get("interp_method", "nearest")
    y = x
    for dim, size_out in ((2, out_h), (3, out_w)):
        size_in = x.shape[dim]
        if size_in == size_out:
            continue
        if nearest:
            idx = torch.floor((torch.arange(size_out, dtype=torch.float32,
                                            device=x.device) + 0.5)
                              * size_in / size_out).long()
            y = y.index_select(dim, idx)
        else:
            wm = _resize_weights(size_in, size_out, x.dtype, x.device)
            y = torch.movedim(torch.movedim(y, dim, -1) @ wm, -1, dim)
    return {"Out": y.to(x.dtype)}


@register_op("pad2d")
def pad2d(ins, attrs):
    """Pad H and W by paddings [top, bottom, left, right]: constant
    (pad_value), reflect, edge / replicate or circular."""
    x = ins["X"][0]
    p = [int(v) for v in attrs["paddings"]]
    mode = attrs.get("mode", "constant")
    pad = (p[2], p[3], p[0], p[1])
    if mode == "constant":
        return {"Out": F.pad(x, pad, value=float(attrs.get("pad_value",
                                                             0.0)))}
    tmode = {"reflect": "reflect", "edge": "replicate",
             "replicate": "replicate", "circular": "circular"}[mode]
    return {"Out": F.pad(x, pad, mode=tmode)}


@register_op("prelu")
def prelu(ins, attrs):
    """x where x > 0, else alpha * x: one alpha ("all") or one per channel
    along axis 1 ("channel")."""
    x, alpha = ins["X"][0], ins["Alpha"][0]
    if attrs.get("mode", "all") == "channel":
        alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    return {"Out": torch.where(x > 0, x, x * alpha)}
