"""Lowerings the reference keeps in ``paddle_tpu/ops/extra_ops.py``:
every op type of it but ``diag_v2``, which the reference's
``linalg_ops`` registers after it (``linalg_ops.py`` here). The unary
table :19-35, atan2 :38, the activations :46-125, eye :133, linspace
:145, meshgrid :160, index_select :183, index_sample :191, flip :200,
roll :208, broadcast_to :220 (with its alias expand_as_v2), unbind :230,
kron :240, take_along_axis :251, put_along_axis :260, cos_sim :283,
dist :298, the losses :314-383, instance_norm :386, norm :412 and auc
:427.

No lowering reads a tensor on the host. Repeated indices of
``put_along_axis`` resolve as on the CPU with no write order of the
card deciding them: ``assign`` keeps the last update, ``add`` sums in
order (``tensor_ops.ordered_index_sum``)."""

from __future__ import annotations

import torch

from ..core.registry import creation_device, register_op
from ..core.types import to_torch_dtype, x64_off
from .math_ops import tie_clip
from .tensor_ops import ordered_index_sum, take_fill, unstack


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


# -- the unary table and atan2 (reference :19-43) -----------------------------

def _log10(x):
    """``jnp.log10``: log(x) / log(10) in x's dtype."""
    return torch.log(x) / torch.log(torch.full((), 10.0, dtype=x.dtype,
                                               device=x.device))


_UNARY = {"asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
          "sinh": torch.sinh, "cosh": torch.cosh, "tan": torch.tan,
          "expm1": torch.expm1, "log1p": torch.log1p, "log10": _log10,
          "atanh": torch.atanh,
          "asinh": torch.asinh, "acosh": torch.acosh}


def _unary(fn):
    """An elementwise lowering; an integer X in float32, as jnp's."""
    def lowering(ins, attrs):
        x = ins["X"][0]
        return {"Out": fn(x if x.is_floating_point() else x.float())}

    return lowering


for _name, _fn in _UNARY.items():
    register_op(_name)(_unary(_fn))


@register_op("trunc")
def trunc(ins, attrs):
    """``jnp.trunc``: an integer X comes back as it is."""
    x = ins["X"][0]
    return {"Out": torch.trunc(x) if x.is_floating_point() else x}


@register_op("atan2")
def atan2(ins, attrs):
    """arctan2(X1, X2); integers in float32."""
    x1, x2 = ins["X1"][0], ins["X2"][0]
    if not x1.is_floating_point():
        x1 = x1.float()
    if not x2.is_floating_point():
        x2 = x2.float()
    return {"Out": torch.atan2(x1, x2)}


def _softplus(x):
    """``jax.nn.softplus``, i.e. logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


@register_op("mish")
def mish(ins, attrs):
    x = ins["X"][0]
    return {"Out": x * torch.tanh(_softplus(x))}


@register_op("celu")
def celu(ins, attrs):
    x = ins["X"][0]
    a = float(attrs.get("alpha", 1.0))
    return {"Out": torch.where(x > 0, x, a * (torch.exp(x / a) - 1.0))}


@register_op("stanh")
def stanh(ins, attrs):
    x = ins["X"][0]
    a = float(attrs.get("scale_a", 0.67))
    b = float(attrs.get("scale_b", 1.7159))
    return {"Out": b * torch.tanh(a * x)}


# -- tensor manipulation (reference :160-280) ---------------------------------

@register_op("meshgrid")
def meshgrid(ins, attrs):
    """The 'ij' grids of the 1-D inputs, each in its own dtype (where
    ``torch.meshgrid`` wants one dtype for all)."""
    xs = ins["X"]
    shape = [x.numel() for x in xs]
    outs = []
    for i, x in enumerate(xs):
        view = [1] * len(xs)
        view[i] = -1
        outs.append(x.reshape(view).expand(shape).contiguous())
    return {"Out": outs}


@register_op("index_sample", non_diff_inputs=("Index",))
def index_sample(ins, attrs):
    """take_along_axis on axis 1 (the fill for an out-of-range index,
    as ``take_along_axis``)."""
    return {"Out": take_along_axis(
        {"Input": ins["X"], "Index": ins["Index"]}, {"Axis": 1})["Result"]}


@register_op("unbind")
def unbind(ins, attrs):
    return {"Out": unstack(ins, attrs)["Y"]}


@register_op("kron")
def kron(ins, attrs):
    return {"Out": torch.kron(ins["X"][0], ins["Y"][0])}


@register_op("put_along_axis", non_diff_inputs=("Index",))
def put_along_axis(ins, attrs):
    """Input with Value written at Index along ``Axis`` (every other dim
    at Index's own positions), as ``x.at[...]`` on the CPU: an index
    wraps once if negative, one still outside the axis (or a position
    past Input's extent on another dim) is dropped. ``Reduce`` 'assign'
    (the default) keeps the last of repeated positions, found by a max
    over positions; 'add' sums them in order. Value broadcasts to
    Index's shape and takes Input's dtype."""
    x, idx, v = ins["Input"][0], ins["Index"][0], ins["Value"][0]
    axis = int(attrs.get("Axis", 0)) % x.dim()
    reduce = attrs.get("Reduce", "assign")
    n = x.shape[axis]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    lin = torch.zeros(idx.shape, dtype=torch.int64, device=idx.device)
    for d in range(x.dim()):
        if d == axis:
            c = idx
        else:
            shape = [1] * idx.dim()
            shape[d] = idx.shape[d]
            c = torch.arange(idx.shape[d], device=idx.device).reshape(shape)
            valid = valid & (c < x.shape[d])
        lin = lin * x.shape[d] + c
    total = x.numel()
    tgt = torch.where(valid, lin, total).reshape(-1)
    vals = torch.broadcast_to(v, idx.shape).to(x.dtype).reshape(-1)
    flat = x.reshape(-1)
    if reduce == "add":
        return {"Result": (flat + ordered_index_sum(vals, tgt, total))
                .reshape(x.shape)}
    pos = torch.arange(tgt.shape[0], device=tgt.device)
    last = torch.full((total + 1,), -1, dtype=torch.int64,
                      device=tgt.device).scatter_reduce(
        0, tgt, pos, "amax")[:total]
    out = torch.where(last >= 0, vals.index_select(0, last.clamp(0)), flat)
    return {"Result": out.reshape(x.shape)}


# -- similarity, distance and losses (reference :283-383) --------------------

@register_op("cos_sim")
def cos_sim(ins, attrs):
    """Row-wise cosine similarity in float32 (Y [1, D] broadcasts), the
    product of the norms floored at 1e-12; Out in X's dtype, XNorm and
    YNorm [N, 1] float32."""
    x, y = ins["X"][0], ins["Y"][0]
    xf = x.float()
    yf = torch.broadcast_to(y, x.shape).float()
    xn = torch.sqrt((xf * xf).sum(dim=-1, keepdim=True))
    yn = torch.sqrt((yf * yf).sum(dim=-1, keepdim=True))
    out = (xf * yf).sum(dim=-1, keepdim=True) / \
        torch.clamp(xn * yn, min=1e-12)
    return {"Out": out.to(x.dtype), "XNorm": xn, "YNorm": yn}


@register_op("dist")
def dist(ins, attrs):
    """The p-norm of X - Y in float32, a 0-d: max |d| at p = inf, the
    count of non-zeros at p = 0."""
    x, y = ins["X"][0], ins["Y"][0]
    p = float(attrs.get("p", 2.0))
    d = (x - y).reshape(-1).float()
    if p == float("inf"):
        out = torch.abs(d).max()
    elif p == 0:
        out = (d != 0).sum().float()
    else:
        out = (torch.abs(d) ** p).sum() ** (1.0 / p)
    return {"Out": out.reshape(())}


@register_op("log_loss", non_diff_inputs=("Labels",))
def log_loss(ins, attrs):
    pred, label = ins["Predicted"][0], ins["Labels"][0]
    eps = float(attrs.get("epsilon", 1e-4))
    return {"Loss": -label * torch.log(pred + eps)
            - (1.0 - label) * torch.log(1.0 - pred + eps)}


@register_op("hinge_loss", non_diff_inputs=("Labels",))
def hinge_loss(ins, attrs):
    """max(0, 1 - (2 label - 1) logits), with jnp.maximum's gradient (half
    at the tie)."""
    logits, label = ins["Logits"][0], ins["Labels"][0]
    return {"Loss": tie_clip(1.0 - (2.0 * label - 1.0) * logits, 0.0)}


@register_op("rank_loss", non_diff_inputs=("Label",))
def rank_loss(ins, attrs):
    """softplus(left - right) - label * (left - right)."""
    label, left, right = ins["Label"][0], ins["Left"][0], ins["Right"][0]
    d = left - right
    return {"Out": _softplus(d) - label * d}


@register_op("nll_loss", non_diff_inputs=("Label",))
def nll_loss(ins, attrs):
    """-X[i, label[i]] over [N, C] log-probabilities, reduced by
    ``reduction`` ('mean', 'sum', else none); Total_weight is N as
    float32. A label outside [0, C) takes ``take_along_axis``'s fill
    (NaN), as in the reference. The reference's lowering drops a
    ``Weight`` input and a non-default ``ignore_index``, either of which
    would change the result, so both raise NotImplementedError here."""
    x, label = ins["X"][0], ins["Label"][0]
    if ins.get("Weight") and ins["Weight"][0] is not None:
        raise NotImplementedError("nll_loss: a Weight input is dropped by "
                                  "the reference's lowering")
    if int(attrs.get("ignore_index", -100)) != -100:
        raise NotImplementedError("nll_loss: ignore_index is dropped by "
                                  "the reference's lowering")
    reduction = attrs.get("reduction", "mean")
    picked = -take_along_axis({"Input": [x],
                               "Index": [label.reshape(-1, 1)]},
                              {"Axis": 1})["Result"][:, 0]
    total = torch.full((), float(picked.numel()), dtype=torch.float32,
                       device=x.device)
    if reduction == "mean":
        out = picked.mean()
    elif reduction == "sum":
        out = picked.sum()
    else:
        out = picked
    return {"Out": out, "Total_weight": total}


@register_op("norm")
def norm(ins, attrs):
    """l2_normalize along ``axis``: X / sqrt(sum(X^2) + epsilon), the sum
    in float32; Norm float32."""
    x = ins["X"][0]
    axis = int(attrs.get("axis", -1))
    eps = float(attrs.get("epsilon", 1e-10))
    nrm = torch.sqrt(torch.square(x.float()).sum(dim=axis, keepdim=True)
                     + eps)
    return {"Out": (x / nrm).to(x.dtype), "Norm": nrm}


# -- the streaming AUC (reference :427) --------------------------------------

@register_op("auc", non_diff_inputs=("Predict", "Label", "StatPos",
                                     "StatNeg"))
def auc(ins, attrs):
    """ROC AUC over ``num_thresholds`` buckets of Predict[:, -1]: this
    batch's positive and negative counts added to StatPos and StatNeg
    (returned as StatPosOut, StatNegOut), the area by trapezoids from the
    top bucket down, 0 when either class is empty. A bucket is
    int(p * num_thresholds) clipped to [0, num_thresholds], with NaN in
    bucket 0 (clipped in float first, so an overflowing product lands at
    an end, as the reference's saturating conversion puts it). Counts are
    whole numbers in float32, exact in any order below 2^24."""
    pred, label = ins["Predict"][0], ins["Label"][0].reshape(-1)
    stat_pos, stat_neg = ins["StatPos"][0], ins["StatNeg"][0]
    num_t = int(attrs.get("num_thresholds", 4095))
    scaled = pred[:, -1].float() * num_t
    bucket = torch.where(torch.isnan(scaled), 0.0,
                         scaled.clamp(0, num_t)).to(torch.int64)
    is_pos = (label > 0).to(stat_pos.dtype)
    stat_pos = stat_pos + torch.zeros_like(stat_pos).index_add(
        0, bucket, is_pos)
    stat_neg = stat_neg + torch.zeros_like(stat_neg).index_add(
        0, bucket, 1.0 - is_pos)
    tot_pos = torch.cumsum(stat_pos.flip(0), 0)
    tot_neg = torch.cumsum(stat_neg.flip(0), 0)
    zero = tot_pos.new_zeros(1)
    area = ((tot_neg - torch.cat([zero, tot_neg[:-1]]))
            * (torch.cat([zero, tot_pos[:-1]]) + tot_pos) / 2.0).sum()
    denom = tot_pos[-1] * tot_neg[-1]
    value = torch.where(denom > 0, area / torch.clamp(denom, min=1.0), 0.0)
    return {"AUC": value.float().reshape(()), "StatPosOut": stat_pos,
            "StatNegOut": stat_neg}
