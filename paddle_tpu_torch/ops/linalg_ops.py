"""Lowerings the reference keeps in ``paddle_tpu/ops/linalg_ops.py``:
addmm :16 through frac :421, and bilinear_tensor_product :186.

None of them reads a tensor on the host. The only host decisions are
the reference's own refusals at trace time: ``bincount`` without
``minlength``, ``kthvalue`` with k out of range, ``cross`` with no axis
of length 3. A compiled step that holds them is captured as a CUDA
graph, but for one that holds ``inverse``: torch's batched ``inv_ex``
on CUDA takes a route that cannot run while a stream captures, so
``inverse`` is registered as deciding on the host, and such a step runs
uncaptured on the card, counted by ``executor.uncaptured_steps``. Sums over repeated indices (``scatter_nd``, ``bincount``'s
float weights) run in a fixed order (``ordered_index_sum``), so two runs
on the card give the same bits. Integer outputs carry the dtypes the
reference returns with 64-bit types off (int32)."""

from __future__ import annotations

import torch

from ..core.registry import register_op
from .extra_ops import linspace
from .tensor_ops import _tile, ordered_index_sum


def _int_sum(x, dim=None, keepdim=False):
    """``jnp.sum``: an integer sum keeps its (32-bit) dtype, where
    ``torch.sum`` widens it to int64; bool sums as int32."""
    dt = x.dtype if x.dtype.is_floating_point else (
        torch.int32 if x.dtype == torch.bool else x.dtype)
    if dim is None:
        return x.sum(dtype=dt)
    return x.sum(dim=dim, keepdim=keepdim, dtype=dt)


def _full(value, dtype, device):
    """A 0-d tensor made by a fill on ``device`` (no host-to-device
    copy, so a CUDA graph can capture it)."""
    return torch.full((), value, dtype=dtype, device=device)


@register_op("addmm")
def addmm(ins, attrs):
    """Out = beta * Input + alpha * (X @ Y)."""
    inp, x, y = ins["Input"][0], ins["X"][0], ins["Y"][0]
    alpha = float(attrs.get("Alpha", attrs.get("alpha", 1.0)))
    beta = float(attrs.get("Beta", attrs.get("beta", 1.0)))
    return {"Out": beta * inp + alpha * torch.matmul(x, y)}


@register_op("cross")
def cross(ins, attrs):
    """3-vector cross product along ``dim``; without one (or at the
    reference's kDefaultDim -100), the first axis of length 3. With no
    such axis the reference's ``next`` raises StopIteration, and so does
    this."""
    x, y = ins["X"][0], ins["Y"][0]
    dim = attrs.get("dim", None)
    if dim is None or int(dim) == -100:
        dim = next(i for i, d in enumerate(x.shape) if d == 3)
    return {"Out": torch.linalg.cross(x, y, dim=int(dim))}


@register_op("mv")
def mv(ins, attrs):
    return {"Out": torch.matmul(ins["X"][0], ins["Vec"][0])}


@register_op("trace")
def trace(ins, attrs):
    """The sum along a diagonal (``jnp.trace``; an integer trace stays
    int32)."""
    x = ins["Input"][0]
    d = torch.diagonal(x, offset=int(attrs.get("offset", 0)),
                       dim1=int(attrs.get("axis1", 0)),
                       dim2=int(attrs.get("axis2", 1)))
    return {"Out": _int_sum(d, -1)}


@register_op("inverse", decides_on_host=True)
def inverse(ins, attrs):
    """Batched inverse by LU (``inv_ex``): a singular matrix gives the
    infinities LU leaves, as ``jnp.linalg.inv`` does, where
    ``torch.linalg.inv`` raises after reading the status on the host.
    ``inv_ex`` cannot be captured into a CUDA graph, so a compiled step
    holding this op runs uncaptured (``decides_on_host``)."""
    return {"Output": torch.linalg.inv_ex(ins["Input"][0]).inverse}


@register_op("cholesky")
def cholesky(ins, attrs):
    """The lower Cholesky factor of (X + X^T) / 2 (``jnp.linalg.cholesky``
    symmetrises its input), its transpose with ``upper``. A matrix that
    is not positive definite comes out as the reference's: NaN on and
    below the diagonal, 0 above. ``cholesky_ex`` reports it in ``info``
    on the device, so nothing is read on the host (``torch.linalg
    .cholesky`` raises)."""
    x = ins["X"][0]
    sym = (x + x.transpose(-1, -2)) / 2
    low, info = torch.linalg.cholesky_ex(sym)
    n = x.shape[-1]
    tril = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
    bad = (info != 0)[..., None, None]
    low = torch.where(bad & tril, float("nan"), torch.where(bad, 0.0, low))
    if bool(attrs.get("upper", False)):
        low = low.transpose(-1, -2)
    return {"Out": low}


def _axes(axis):
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return (int(axis),)


@register_op("logsumexp")
def logsumexp(ins, attrs):
    """log(sum(exp(X))) over ``axis`` (all of them with ``reduce_all``,
    no axis or []); an integer X in float32."""
    x = ins["X"][0]
    if not x.is_floating_point():
        x = x.float()
    axis = attrs.get("axis", attrs.get("dim", None))
    keepdim = bool(attrs.get("keepdim", attrs.get("keep_dim", False)))
    if attrs.get("reduce_all", False) or axis is None or axis == []:
        dims = tuple(range(x.dim()))
    else:
        dims = _axes(axis)
    if x.dim() == 0:
        return {"Out": x.clone()}
    return {"Out": torch.logsumexp(x, dim=dims, keepdim=keepdim)}


@register_op("frobenius_norm")
def frobenius_norm(ins, attrs):
    """sqrt(sum(X^2)) over ``dim``. As in the reference, an empty or 0
    ``dim`` (or ``reduce_all``) means every axis."""
    x = ins["X"][0]
    axis = attrs.get("dim", attrs.get("axis", None))
    keepdim = bool(attrs.get("keep_dim", False))
    if attrs.get("reduce_all", False) or not axis:
        dims = None
    else:
        dims = tuple(int(a) for a in axis)
    return {"Out": torch.sqrt(torch.square(x).sum(dim=dims,
                                                  keepdim=keepdim))}


class _AbsSum(torch.autograd.Function):
    """sum(|x|) with ``jnp.abs``'s derivative: select(x >= 0, 1, -1), so 1
    at +-0 (and -1 at NaN), where torch's abs passes 0 at 0."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x).sum()

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


@register_op("l1_norm")
def l1_norm(ins, attrs):
    """sum(|X|); an integer X sums as int32. The gradient is jnp.abs's
    (``_AbsSum``)."""
    x = ins["X"][0]
    if not x.is_floating_point():
        return {"Out": _int_sum(torch.abs(x))}
    return {"Out": _AbsSum.apply(x)}


@register_op("multiplex", non_diff_inputs=("Ids",))
def multiplex(ins, attrs):
    """Out[i] = X[Ids[i]][i]. Ids index as jnp's integer indexing does: a
    negative id wraps once, then every id is clamped into [0, N). A
    clamped id passes no gradient, as the scatter that transposes jnp's
    gather drops it."""
    xs = ins["X"]
    n = len(xs)
    ids = ins["Ids"][0].reshape(-1).long()
    ids = torch.where(ids < 0, ids + n, ids)
    valid = (ids >= 0) & (ids < n)
    stacked = torch.stack(list(xs), dim=0)
    rows = torch.arange(stacked.shape[1], device=ids.device)
    out = stacked[ids.clamp(0, n - 1), rows]
    valid = valid.reshape((-1,) + (1,) * (out.dim() - 1))
    return {"Out": torch.where(valid, out, out.detach())}


@register_op("minus")
def minus(ins, attrs):
    return {"Out": ins["X"][0] - ins["Y"][0]}


@register_op("expand_as")
def expand_as(ins, attrs):
    """X tiled to the shape of ``target_tensor`` (or Y)."""
    x = ins["X"][0]
    target = (ins.get("target_tensor") or ins.get("Y"))[0]
    reps = [int(t) // int(s) for s, t in zip(x.shape, target.shape)]
    return {"Out": _tile(x, reps)}


@register_op("pad_constant_like")
def pad_constant_like(ins, attrs):
    """Y padded at the tail of every axis up to X's shape with
    ``pad_value`` (cast to Y's dtype, as ``jnp.pad`` casts it). A Y
    larger than X raises ValueError, as ``jnp.pad`` does for a negative
    width."""
    x, y = ins["X"][0], ins["Y"][0]
    val = float(attrs.get("pad_value", 0.0))
    widths = [int(dx) - int(dy) for dx, dy in zip(x.shape, y.shape)]
    if any(w < 0 for w in widths):
        raise ValueError(f"pad_constant_like: Y {tuple(y.shape)} is larger "
                         f"than X {tuple(x.shape)}")
    if not y.is_floating_point():
        val = int(val) if y.dtype != torch.bool else bool(val)
    pads = [p for w in reversed(widths) for p in (0, w)]
    return {"Out": torch.nn.functional.pad(y, pads, value=val)}


@register_op("shard_index", non_diff_inputs=("X",))
def shard_index(ins, attrs):
    """Global ids to shard-local ones: id % size for an id of this shard
    (floor division, as jnp's), ``ignore_value`` for the others."""
    x = ins["X"][0]
    index_num = int(attrs["index_num"])
    nshards = int(attrs["nshards"])
    shard_id = int(attrs["shard_id"])
    ignore = int(attrs.get("ignore_value", -1))
    size = (index_num + nshards - 1) // nshards
    mine = torch.div(x, size, rounding_mode="floor") == shard_id
    return {"Out": torch.where(mine, torch.remainder(x, size), ignore)}


@register_op("reverse")
def reverse(ins, attrs):
    axes = attrs.get("axis", [0])
    if not isinstance(axes, (list, tuple)):
        axes = [axes]
    return {"Out": torch.flip(ins["X"][0], dims=[int(a) for a in axes])}


@register_op("size", non_diff_inputs=("Input",))
def size_op(ins, attrs):
    """The element count, a 0-d int32 (the reference's int64 with 64-bit
    types off)."""
    x = ins["Input"][0]
    return {"Out": _full(x.numel(), torch.int32, x.device)}


@register_op("scatter_nd", non_diff_inputs=("Index", "Shape"))
def scatter_nd(ins, attrs):
    """Updates added into zeros of ``shape`` at the rows the last axis of
    Index names, as ``.at[].add`` on the CPU: a negative index wraps
    once, a row still out of range is dropped, and repeated rows are
    summed in their order (``ordered_index_sum``)."""
    idx, upd = ins["Index"][0], ins["Updates"][0]
    shape = tuple(int(v) for v in attrs["shape"])
    k = idx.shape[-1]
    lead = idx.reshape(-1, k).long()
    rows = 1
    for d in shape[:k]:
        rows *= d
    lin = torch.zeros(lead.shape[0], dtype=torch.int64, device=idx.device)
    valid = torch.ones(lead.shape[0], dtype=torch.bool, device=idx.device)
    for i in range(k):
        n = shape[i]
        c = lead[:, i]
        c = torch.where(c < 0, c + n, c)
        valid = valid & (c >= 0) & (c < n)
        lin = lin * n + c
    tgt = torch.where(valid, lin, rows)
    vals = upd.reshape((lead.shape[0],) + shape[k:])
    return {"Out": ordered_index_sum(vals, tgt, rows).reshape(shape)}


@register_op("diag")
def diag(ins, attrs):
    """The flattened Diagonal as the diagonal of a square matrix."""
    return {"Out": torch.diag(ins["Diagonal"][0].reshape(-1))}


@register_op("diag_v2")
def diag_v2(ins, attrs):
    """A vector to a matrix with it on diagonal ``offset`` (elsewhere
    ``padding_value``, which as a float promotes an integer vector to
    float32, as jnp.where does), or a matrix's diagonal ``offset``."""
    x = ins["X"][0]
    off = int(attrs.get("offset", 0))
    if x.dim() == 1:
        pad = float(attrs.get("padding_value", 0.0))
        out = torch.diag(x, off)
        if pad:
            mask = torch.diag(torch.ones_like(x, dtype=torch.bool), off)
            out = torch.where(mask, out, pad)
        return {"Out": out}
    return {"Out": torch.diagonal(x, offset=off).contiguous()}


@register_op("histogram", non_diff_inputs=("X",))
def histogram(ins, attrs):
    """``jnp.histogram`` of the flattened X over ``bins`` equal bins of
    [min, max] (both 0: the data's range, taken on the device), int32.
    A range (a, a) widens to (a - 0.5, a + 0.5); a value equal to the
    top edge falls in the last bin; values outside the range and NaN are
    dropped. The edges are in X's floating dtype (float32 for an integer
    X)."""
    x = ins["X"][0].reshape(-1)
    if not x.is_floating_point():
        x = x.float()
    bins = int(attrs.get("bins", 100))
    lo = float(attrs.get("min", 0))
    hi = float(attrs.get("max", 0))
    if lo == 0 and hi == 0:
        lo_t, hi_t = x.min(), x.max()
    else:
        lo_t = _full(lo, x.dtype, x.device)
        hi_t = _full(hi, x.dtype, x.device)
    same = (hi_t - lo_t) == 0
    lo_t = torch.where(same, lo_t - 0.5, lo_t)
    hi_t = torch.where(same, hi_t + 0.5, hi_t)
    edges = linspace({"Start": [lo_t], "Stop": [hi_t]},
                     {"num": bins + 1})["Out"].to(x.dtype)
    at = torch.searchsorted(edges, x, right=True)
    at = torch.where(x == edges[-1], bins, at)
    at = torch.where((at >= 1) & (at <= bins) & ~torch.isnan(x), at,
                     bins + 1)
    counts = torch.zeros(bins + 2, dtype=torch.int32, device=x.device)
    counts = counts.index_add(0, at, torch.ones_like(at, dtype=torch.int32))
    return {"Out": counts[1:bins + 1]}


@register_op("bincount", non_diff_inputs=("X", "Weights"))
def bincount(ins, attrs):
    """Counts (or summed Weights) of the flattened ids into ``minlength``
    bins, as ``jnp.bincount(..., length=minlength)``: a negative id
    counts in bin 0 and an id >= minlength is dropped. ``minlength`` is
    required (ValueError without it, as in the reference: the length is
    the output's shape). Counts are int32; float weights sum in a fixed
    order."""
    x = ins["X"][0].reshape(-1).long()
    n = int(attrs.get("minlength", 0))
    if n <= 0:
        raise ValueError("bincount needs a static minlength attr (the "
                         "output length is its shape)")
    if ins.get("Weights") and ins["Weights"][0] is not None:
        w = ins["Weights"][0].reshape(-1)
    else:
        w = torch.ones(x.shape, dtype=torch.int32, device=x.device)
    tgt = x.clamp(min=0)
    tgt = torch.where(tgt < n, tgt, n)
    return {"Out": ordered_index_sum(w, tgt, n)}


@register_op("isinf", non_diff_inputs=("X",))
def isinf_op(ins, attrs):
    return {"Out": torch.isinf(ins["X"][0]).any().reshape(1)}


@register_op("isnan", non_diff_inputs=("X",))
def isnan_op(ins, attrs):
    return {"Out": torch.isnan(ins["X"][0]).any().reshape(1)}


@register_op("isinf_v2", non_diff_inputs=("X",))
def isinf_v2(ins, attrs):
    return {"Out": torch.isinf(ins["X"][0])}


@register_op("isnan_v2", non_diff_inputs=("X",))
def isnan_v2(ins, attrs):
    return {"Out": torch.isnan(ins["X"][0])}


@register_op("rank", non_diff_inputs=("Input",))
def rank_op(ins, attrs):
    """The number of dims, a 0-d int32."""
    x = ins["Input"][0]
    return {"Out": _full(x.dim(), torch.int32, x.device)}


@register_op("cumprod")
def cumprod(ins, attrs):
    """The running product along ``dim``; an integer one stays int32."""
    x = ins["X"][0]
    dt = x.dtype if x.dtype != torch.bool else torch.int32
    return {"Out": torch.cumprod(x, dim=int(attrs.get("dim", -1)), dtype=dt)}


def _keep(t, axis, keepdim):
    return t.unsqueeze(axis) if keepdim else t


@register_op("kthvalue", non_diff_inputs=("X",))
def kthvalue(ins, attrs):
    """The k-th smallest along ``axis`` and its index (int32), from one
    stable sort: NaN sorts last and -0 ties with 0, as jnp.argsort's
    order. k outside [1, n] raises ValueError, as in the reference."""
    x = ins["X"][0]
    k = int(attrs["k"])
    axis = int(attrs.get("axis", -1)) % x.dim()
    keepdim = bool(attrs.get("keepdim", False))
    n = x.shape[axis]
    if not 1 <= k <= n:
        raise ValueError(f"kthvalue: k={k} out of range for axis "
                         f"length {n}")
    srt, arg = torch.sort(x, dim=axis, stable=True)
    val = srt.select(axis, k - 1)
    idx = arg.select(axis, k - 1).to(torch.int32)
    return {"Out": _keep(val, axis, keepdim),
            "Indices": _keep(idx, axis, keepdim)}


@register_op("median", non_diff_inputs=("X",))
def median(ins, attrs):
    """``jnp.median``: the mean of the two middle values of an even count
    ((lo + hi) * 0.5, as its 'midpoint' quantile), NaN where the slice
    holds a NaN; float32 for an integer X; ``axis`` None flattens."""
    x = ins["X"][0]
    if not x.is_floating_point():
        x = x.float()
    axis = attrs.get("axis", None)
    keepdim = bool(attrs.get("keepdim", False))
    shape = x.shape
    if axis is None:
        x, ax = x.reshape(-1), 0
    else:
        ax = int(axis) % x.dim()
    n = x.shape[ax]
    srt = torch.sort(x, dim=ax, stable=True)[0]
    lo, hi = (n - 1) // 2, n // 2
    out = (srt.select(ax, lo) + srt.select(ax, hi)) * 0.5
    out = torch.where(torch.isnan(x).any(dim=ax), float("nan"), out) \
        .to(out.dtype)
    if keepdim:
        out = out.reshape((1,) * len(shape)) if axis is None \
            else out.unsqueeze(ax)
    return {"Out": out}


@register_op("mode", non_diff_inputs=("X",))
def mode_op(ins, attrs):
    """The most frequent value along ``axis`` and the index of its first
    occurrence (int32). Among values equally frequent the smallest wins:
    the reference's run-length count over the sorted values, whose
    ``argmax`` takes the first longest run. ``torch.mode``'s index is not
    the first."""
    x = ins["X"][0]
    axis = int(attrs.get("axis", -1)) % x.dim()
    keepdim = bool(attrs.get("keepdim", False))
    x = torch.movedim(x, axis, -1)
    srt = torch.sort(x, dim=-1, stable=True)[0]
    eq = srt[..., 1:] == srt[..., :-1]
    zero = torch.zeros(x.shape[:-1] + (1,), dtype=torch.int64,
                       device=x.device)
    runs = torch.cat([zero, torch.cumsum(eq, dim=-1)], dim=-1)
    first = torch.cat([torch.ones_like(zero, dtype=torch.bool), ~eq], dim=-1)
    start = runs - torch.cummax(torch.where(first, runs, 0), dim=-1)[0]
    best = torch.argmax(start, dim=-1, keepdim=True)
    val = torch.gather(srt, -1, best)[..., 0]
    idx = torch.argmax((x == val[..., None]).to(torch.int32), dim=-1) \
        .to(torch.int32)
    return {"Out": _keep(val, axis, keepdim),
            "Indices": _keep(idx, axis, keepdim)}


def sort_key(x):
    """Integers ordered as jax's sort orders floats (``lax.sort``'s
    ``_float_to_int_for_sort``): -0 ties with 0, every NaN is one value
    above +inf. An integer X is its own key."""
    if not x.is_floating_point():
        return x
    wide = x.dtype == torch.float64
    itype = torch.int64 if wide else torch.int32
    x = x if wide else x.float()
    bits = x.view(itype)
    bits = torch.where(x == 0, 0, bits)
    bits = torch.where(torch.isnan(x), torch.full_like(
        bits, 0x7FF8000000000000 if wide else 0x7FC00000), bits)
    magnitude = torch.iinfo(itype).max
    return torch.where(bits < 0, -(bits & magnitude) - 1, bits)


@register_op("searchsorted", non_diff_inputs=("SortedSequence", "Values"))
def searchsorted(ins, attrs):
    """Insertion points of Values in SortedSequence (left, or ``right``),
    int32 (the reference's int64 with 64-bit types off); an N-D sequence
    searches row by row. Both compare by jax's sort order (``sort_key``):
    NaN above +inf, where torch's comparisons with NaN are all false."""
    seq = sort_key(ins["SortedSequence"][0])
    vals = sort_key(ins["Values"][0])
    right = bool(attrs.get("right", False))
    if seq.dim() == 1:
        out = torch.searchsorted(seq, vals.reshape(-1), right=right,
                                 out_int32=True)
    else:
        s2 = seq.reshape(-1, seq.shape[-1])
        out = torch.searchsorted(s2, vals.reshape(s2.shape[0], -1),
                                 right=right, out_int32=True)
    return {"Out": out.reshape(vals.shape)}


@register_op("lgamma")
def lgamma(ins, attrs):
    return {"Out": torch.lgamma(ins["X"][0])}


@register_op("digamma")
def digamma(ins, attrs):
    """``jsp.digamma``: NaN at 0, -0 and -inf, where torch's gives -inf,
    +inf and NaN."""
    x = ins["X"][0]
    y = torch.digamma(x)
    return {"Out": torch.where((x == 0) | (x == float("-inf")),
                               float("nan"), y).to(y.dtype)}


@register_op("frac")
def frac(ins, attrs):
    """x - trunc(x); an integer X gives zeros."""
    x = ins["X"][0]
    if not x.is_floating_point():
        return {"Out": x - x}
    return {"Out": x - torch.trunc(x)}


@register_op("bilinear_tensor_product")
def bilinear_tensor_product(ins, attrs):
    """Out[b, k] = x[b] @ W[k] @ y[b] (+ Bias)."""
    x, y, w = ins["X"][0], ins["Y"][0], ins["Weight"][0]
    out = torch.einsum("bi,kij,bj->bk", x, w, y)
    if ins.get("Bias") and ins["Bias"][0] is not None:
        out = out + ins["Bias"][0]
    return {"Out": out}
