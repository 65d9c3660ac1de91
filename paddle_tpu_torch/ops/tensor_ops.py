"""Tensor creation and manipulation lowerings: every op type of
``paddle_tpu/ops/tensor_ops.py`` (fill_constant :57 through
fill_constant_batch_size_like :556).

The random initializers draw from a ``torch.Generator`` seeded with the
op's seed as ``core/rng.op_seed`` derives it: the same distributions as
the reference, reproducible per seed, not the reference's bits. A CUDA
graph would replay the first draw's generator state, so they are not
``capturable``: they belong in a startup program, which runs once.
Neither is ``assign_value``, which copies its values from the host."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import rng
from ..core.ir import OpDesc
from ..core.registry import (creation_device, default_grad_maker,
                             register_grad_maker, register_op)
from ..core.selected_rows import SelectedRows, concat as concat_rows
from ..core.types import convert_dtype, to_torch_dtype, x64_off


def _shape_of(attrs):
    return tuple(int(d) for d in attrs["shape"])


def _dtype_of(attrs):
    """The op's ``dtype`` attr as the reference holds it (64-bit types as
    32, x64 off)."""
    return x64_off(to_torch_dtype(attrs.get("dtype", "float32")))


@register_op("fill_constant")
def fill_constant(ins, attrs):
    return {"Out": torch.full(_shape_of(attrs), attrs.get("value", 0.0),
                              dtype=_dtype_of(attrs),
                              device=creation_device())}


@register_op("assign_value", capturable=False)
def assign_value(ins, attrs):
    """A tensor of the given shape holding ``values``, in ``dtype``
    (64-bit types as 32, as the reference holds them)."""
    dtype = _dtype_of(attrs)
    dev = creation_device()
    if dev.type == "meta":
        return {"Out": torch.empty(_shape_of(attrs), dtype=dtype, device=dev)}
    vals = np.asarray(attrs["values"]).reshape(_shape_of(attrs))
    return {"Out": torch.from_numpy(vals).to(device=dev, dtype=dtype)}


@register_op("assign")
def assign(ins, attrs):
    """A copy of X (never an alias of the input's storage)."""
    return {"Out": ins["X"][0].clone()}


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


@register_op("uniform_random", capturable=False)
def uniform_random(ins, attrs):
    lo, hi = float(attrs.get("min", -1.0)), float(attrs.get("max", 1.0))
    out = lo + (hi - lo) * _uniform01(attrs)
    return {"Out": out.to(_dtype_of(attrs))}


@register_op("gaussian_random", capturable=False)
def gaussian_random(ins, attrs):
    x = _std_normal(_uniform01(attrs))
    out = x * float(attrs.get("std", 1.0)) + float(attrs.get("mean", 0.0))
    return {"Out": out.to(_dtype_of(attrs))}


@register_op("truncated_gaussian_random", capturable=False)
def truncated_gaussian_random(ins, attrs):
    """Normal(mean, std) truncated at two standard deviations, by the
    inverse CDF over [cdf(-2), cdf(2)]."""
    c = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    x = _std_normal(_uniform01(attrs), c, 1.0 - c).clamp(-2.0, 2.0)
    out = x * float(attrs.get("std", 1.0)) + float(attrs.get("mean", 0.0))
    return {"Out": out.to(_dtype_of(attrs))}


@register_op("cast")
def cast(ins, attrs):
    """To ``out_dtype`` (or ``dtype``); 64-bit targets become 32-bit, as
    in the reference with x64 off."""
    dtype = x64_off(to_torch_dtype(attrs.get("out_dtype", attrs.get(
        "dtype", "float32"))))
    return {"Out": convert(ins["X"][0], dtype)}


def convert(x, dtype):
    """``x`` in ``dtype`` as XLA's convert gives it: a float going to an
    integer type saturates at the type's range and NaN becomes 0 (a
    plain ``.to`` leaves both to the hardware: on x86 3e9 -> int32 is
    the int32 minimum). The bounds are taken in float64, which holds
    every bound of the 32-bit and smaller types exactly; all on the
    device, with no host read."""
    if not x.is_floating_point() or dtype.is_floating_point \
            or dtype == torch.bool:
        return x.to(dtype)
    info = torch.iinfo(dtype)
    xd = x.double().clamp(info.min, info.max)
    return torch.where(torch.isnan(xd), 0.0, xd).to(dtype)


@register_op("scale")
def scale(ins, attrs):
    """X * scale + bias (or (X + bias) * scale). The bias is first cast to
    X's dtype, as the reference's ``np.asarray(bias, x.dtype)`` does: an
    integer X truncates it (int32 [0..3], scale 0.5, bias 1.5 gives the
    float32 [1, 1.5, 2, 2.5]). The cast is of a host scalar, so the op
    stays capturable."""
    x = ins["X"][0]
    s = attrs.get("scale", 1.0)
    b = torch.tensor(float(attrs.get("bias", 0.0)),
                     dtype=torch.float64).to(x.dtype).item()
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


@register_op("transpose2")
def transpose2(ins, attrs):
    """Out is a permuted view of X (no copy); a consumer that needs
    contiguous memory makes it so. Its gradient is the generic
    ``__vjp_grad__``, which permutes the cotangent back."""
    x = ins["X"][0]
    return {"Out": x.permute([int(a) for a in attrs["axis"]]),
            "XShape": _xshape(x)}


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


def take_index(index, n):
    """(indices clamped into [0, n), which of them are in range) of a
    ``jnp.take`` index over an axis of ``n``: a negative index in [-n, 0)
    wraps to index + n, anything else outside [0, n) is out of range.
    Index arrives int32 and is widened for torch's indexing. No host
    read, so the ops stay capturable."""
    idx = index.reshape(-1).long()
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    return idx.clamp(0, max(n - 1, 0)), valid


def take_fill(dtype):
    """``jnp.take``'s fill for an out-of-range index: NaN for floats, the
    least value of a signed integer type, the largest of an unsigned one,
    True for bool."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).max if dtype == torch.uint8 \
        else torch.iinfo(dtype).min


def _fill_invalid(out, valid, axis):
    """``out`` (the taken slices along ``axis``) with the slices of
    out-of-range indices replaced by ``take_fill``."""
    shape = [1] * out.dim()
    shape[axis] = -1
    return torch.where(valid.reshape(shape), out, take_fill(out.dtype))


@register_op("gather", non_diff_inputs=("Index",))
def gather(ins, attrs):
    """jnp.take(x, index, axis): out shape is x.shape[:axis] +
    index.shape + x.shape[axis+1:]. As there, a negative index wraps and
    an out-of-range one takes the fill value (``take_fill``)."""
    x, index = ins["X"][0], ins["Index"][0]
    axis = int(attrs.get("axis", 0)) % x.dim()
    idx, valid = take_index(index, x.shape[axis])
    flat = _fill_invalid(torch.index_select(x, axis, idx), valid, axis)
    return {"Out": flat.reshape(tuple(x.shape[:axis]) + tuple(index.shape)
                                + tuple(x.shape[axis + 1:]))}


class _Lookup(torch.autograd.Function):
    """Rows of ``w`` gathered by the flat int64 ``ids``, with a gradient
    that sums each row's cotangents in a fixed order
    (``ordered_index_sum``: the ids sorted stably, then one float32
    segment sum a row, cast to the table's dtype). Two runs, op by op or replayed from a CUDA
    graph, give the same bits. The gradient autograd derives from a
    gather (``index_add_``) and ``F.embedding``'s both sum with atomics on
    the card when rows repeat, in a run-dependent order; no step of this
    one reads the device from the host, so it can be captured."""

    @staticmethod
    def forward(ctx, w, ids, valid):
        ctx.save_for_backward(ids, valid)
        ctx.rows = w.shape[0]
        return _fill_invalid(torch.index_select(w, 0, ids), valid, 0)

    @staticmethod
    def backward(ctx, dy):
        ids, valid = ctx.saved_tensors
        # an out-of-range id took the fill and gets no gradient
        return ordered_index_sum(dy, torch.where(valid, ids, ctx.rows),
                                 ctx.rows), None, None


@register_op("lookup_table_v2", non_diff_inputs=("Ids",))
def lookup_table_v2(ins, attrs):
    """Embedding lookup; rows of padding_idx come out as zeros. Ids index
    as ``jnp.take`` does (``take_index``: negative ids wrap, out-of-range
    ids take the fill). The gradient sums each row in the ids' order
    (``_Lookup``)."""
    w, ids = ins["W"][0], ins["Ids"][0]
    out = _Lookup.apply(w, *take_index(ids, w.shape[0])).reshape(
        tuple(ids.shape) + tuple(w.shape[1:]))
    pad = int(attrs.get("padding_idx", -1))
    if pad >= 0:
        out = out * (ids != pad)[..., None].to(out.dtype)
    return {"Out": out}


@register_grad_maker("lookup_table_v2")
def _lookup_table_v2_grad_maker(op, out_grads, in_grads):
    """The generic gradient (``_Lookup``'s dense one) or, with
    ``is_sparse``, one ``lookup_table_sparse_grad`` op emitting a
    SelectedRows, as the reference's maker does (lookup_table_op.cc's
    SelectedRows grad kernel)."""
    if not bool(op.attrs.get("is_sparse", False)):
        return default_grad_maker(op, out_grads, in_grads)
    og = (out_grads.get("Out") or [None])[0]
    wg = (in_grads.get("W") or [None])[0]
    if og is None or wg is None:
        return []
    return [OpDesc("lookup_table_sparse_grad",
                   {"Ids": list(op.inputs["Ids"]),
                    "W": list(op.inputs["W"]), "OutGrad": [og]},
                   {"WGrad": [wg]},
                   {"padding_idx": int(op.attrs.get("padding_idx", -1))})]


@register_op("lookup_table_sparse_grad", skip_infer_shape=True,
             non_diff_inputs=("Ids", "W", "OutGrad"))
def lookup_table_sparse_grad(ins, attrs):
    """d(lookup)/dW as a SelectedRows: rows the looked-up ids, values the
    incoming cotangents in W's dtype; no [V, D] buffer. Rows of
    padding_idx get zero values. An id out of range (``take_index``)
    gets the sentinel row V, which every consumer drops, where the
    reference's scatter drops it."""
    ids = ins["Ids"][0].reshape(-1)
    w, og = ins["W"][0], ins["OutGrad"][0]
    height = w.shape[0]
    idx, valid = take_index(ids, height)
    vals = og.reshape(ids.shape[0], og.shape[-1]).to(w.dtype)
    pad = int(attrs.get("padding_idx", -1))
    if pad >= 0:
        vals = vals * (ids != pad)[:, None].to(vals.dtype)
    return {"WGrad": SelectedRows(torch.where(valid, idx, height), vals,
                                  height)}


@register_op("lookup_table", non_diff_inputs=("Ids",))
def lookup_table(ins, attrs):
    """The fluid 1.x lookup: a trailing dim of 1 on Ids is squeezed,
    then as ``lookup_table_v2``."""
    w, ids = ins["W"][0], ins["Ids"][0]
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    return lookup_table_v2({"W": [w], "Ids": [ids]}, attrs)


@register_op("concat")
def concat(ins, attrs):
    return {"Out": torch.cat(ins["X"], dim=int(attrs.get("axis", 0)))}


@register_op("sum")
def sum_op(ins, attrs):
    """Multi-input add: the gradient-accumulation op. With its
    SelectedRows branch (sum_op.cc): SelectedRows inputs alone
    concatenate; a mix with dense inputs densifies them."""
    xs = [x for x in ins["X"] if x is not None]
    if any(isinstance(x, SelectedRows) for x in xs):
        if all(isinstance(x, SelectedRows) for x in xs):
            return {"Out": concat_rows(xs)}
        xs = [x.to_dense() if isinstance(x, SelectedRows) else x
              for x in xs]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": out}


def _one_hot(ids, depth):
    """float32 one-hot rows of ``depth`` along a new last axis, as
    ``jax.nn.one_hot`` gives them: an id outside [0, depth) gets a row of
    zeros. The ids (int32, as feeds arrive) are widened and compared with
    an arange: no bounds check reads the device, so the op stays
    capturable."""
    classes = torch.arange(depth, device=ids.device)
    return (ids.long().unsqueeze(-1) == classes).to(torch.float32)


@register_op("one_hot", non_diff_inputs=("X",))
def one_hot(ins, attrs):
    """The fluid 1.x op: a trailing dim of 1 is squeezed first."""
    x = ins["X"][0]
    if x.dim() >= 2 and x.shape[-1] == 1:
        x = x.squeeze(-1)
    return {"Out": _one_hot(x, int(attrs["depth"]))}


@register_op("one_hot_v2", non_diff_inputs=("X",))
def one_hot_v2(ins, attrs):
    return {"Out": _one_hot(ins["X"][0], int(attrs["depth"]))}


@register_op("increment")
def increment(ins, attrs):
    """X + step in X's dtype, out of place: the step counter the
    learning-rate schedules read is a persistable that the executor
    writes back."""
    x = ins["X"][0]
    step = float(attrs.get("step", 1.0))
    return {"Out": x + (step if x.is_floating_point() else int(step))}


# -- the rest of the reference's tensor ops -----------------------------------

@register_op("randint", capturable=False)
def randint(ins, attrs):
    """Integers uniform in [low, high) from the op's seed (the same
    distribution as the reference, not its bits), int32 for int64."""
    dev = creation_device()
    dtype = x64_off(to_torch_dtype(attrs.get("dtype", "int64")))
    if dev.type == "meta":
        return {"Out": torch.empty(_shape_of(attrs), dtype=dtype,
                                   device=dev)}
    gen = torch.Generator(device=dev)
    gen.manual_seed(rng.op_seed(attrs))
    return {"Out": torch.randint(int(attrs.get("low", 0)),
                                 int(attrs.get("high", 100)),
                                 _shape_of(attrs), generator=gen,
                                 device=dev, dtype=dtype)}


@register_op("share_data")
def share_data(ins, attrs):
    return {"Out": ins["X"][0]}


@register_op("reshape")
def reshape(ins, attrs):
    x = ins["X"][0]
    return {"Out": x.reshape([x.shape[i] if d == 0 else d
                              for i, d in enumerate(attrs["shape"])])}


@register_op("transpose")
def transpose(ins, attrs):
    return {"Out": ins["X"][0].permute([int(a) for a in attrs["axis"]])}


def _along(x, axis, sl):
    return x[(slice(None),) * axis + (sl,)]


@register_op("split")
def split(ins, attrs):
    """``jnp.split``: at the cumulative ``sections`` (the last one
    implied), or into ``num`` equal parts. A section of -1 is not
    inferred: it makes a piece's size negative, which jnp refuses, and
    so does this."""
    x = ins["X"][0]
    axis = int(attrs.get("axis", 0)) % x.dim()
    n = x.shape[axis]
    sections = attrs.get("sections")
    if sections:
        bounds = [0] + np.cumsum(sections)[:-1].tolist() + [n]
    else:
        num = int(attrs.get("num", 0))
        if num <= 0 or n % num:
            raise ValueError(f"split: {n} does not divide into {num} "
                             f"equal parts")
        bounds = list(range(0, n + 1, n // num))
    sizes = np.diff(bounds)
    if (sizes < 0).any():
        raise ValueError(f"split: sizes must be nonnegative, got "
                         f"{sizes.tolist()}")
    return {"Out": [_along(x, axis, slice(int(a), int(b)))
                    for a, b in zip(bounds[:-1], bounds[1:])]}


@register_op("stack")
def stack(ins, attrs):
    return {"Y": torch.stack(ins["X"], dim=int(attrs.get("axis", 0)))}


@register_op("unstack")
def unstack(ins, attrs):
    return {"Y": list(torch.unbind(ins["X"][0],
                                   dim=int(attrs.get("axis", 0))))}


@register_op("flatten2")
def flatten2(ins, attrs):
    x = ins["X"][0]
    axis = int(attrs.get("axis", 1))
    lead = math.prod(x.shape[:axis]) if axis > 0 else 1
    return {"Out": x.reshape(lead, -1), "XShape": _xshape(x)}


@register_op("flatten_contiguous_range")
def flatten_contiguous_range(ins, attrs):
    x = ins["X"][0]
    start = int(attrs.get("start_axis", 1)) % max(x.dim(), 1)
    stop = int(attrs.get("stop_axis", -1)) % max(x.dim(), 1)
    return {"Out": x.reshape(tuple(x.shape[:start]) + (-1,)
                             + tuple(x.shape[stop + 1:])),
            "XShape": _xshape(x)}


def _strided(x, axis, start, end, step):
    """``x[start:end:step]`` along ``axis`` with Python's clamping of the
    bounds; a negative step walks back (torch slices only forward)."""
    n = x.shape[axis]
    lo, hi, st = slice(start, end, step).indices(n)
    if st > 0:
        return _along(x, axis, slice(lo, hi, st))
    count = len(range(lo, hi, st))
    if not count:
        return _along(x, axis, slice(0, 0))
    last = lo + (count - 1) * st
    return _along(x.flip(axis), axis, slice(n - 1 - lo, n - last, -st))


@register_op("strided_slice")
def strided_slice(ins, attrs):
    x = ins["Input"][0]
    for a, s, e, st in zip(attrs["axes"], attrs["starts"], attrs["ends"],
                           attrs["strides"]):
        x = _strided(x, int(a) % x.dim(), s, e, st)
    return {"Out": x}


@register_op("gather_nd", non_diff_inputs=("Index",))
def gather_nd(ins, attrs):
    """X at the last axis of Index, as jnp's integer-array indexing takes
    it: a negative index wraps once, then every index is clamped into
    range. An index still out of range after the wrap passes no
    gradient, as the scatter that transposes jnp's gather drops it."""
    x, index = ins["X"][0], ins["Index"][0]
    idx = []
    valid = torch.ones(index.shape[:-1], dtype=torch.bool,
                       device=index.device)
    for i in range(index.shape[-1]):
        n = x.shape[i]
        k = index[..., i].long()
        k = torch.where(k < 0, k + n, k)
        valid = valid & (k >= 0) & (k < n)
        idx.append(k.clamp(0, max(n - 1, 0)))
    out = x[tuple(idx)]
    valid = valid.reshape(tuple(valid.shape)
                          + (1,) * (out.dim() - valid.dim()))
    return {"Out": torch.where(valid, out, out.detach())}


@register_op("scatter", non_diff_inputs=("Ids",))
def scatter(ins, attrs):
    """Rows of X replaced by (``overwrite``) or added to by Updates at
    Ids, as ``x.at[ids]`` on the CPU: a negative id wraps once, an id
    still out of range is dropped, and among equal ids the last update
    wins (overwrite) or all are summed in their order. The winner is
    found by a max over positions, so no write order of the card's
    decides it."""
    x, upd = ins["X"][0], ins["Updates"][0]
    n = x.shape[0]
    ids = ins["Ids"][0].reshape(-1).long()
    ids = torch.where(ids < 0, ids + n, ids)
    tgt = torch.where((ids >= 0) & (ids < n), ids, n)    # n: dropped
    upd = upd.reshape((ids.shape[0],) + tuple(x.shape[1:])).to(x.dtype)
    if attrs.get("overwrite", True):
        pos = torch.arange(ids.shape[0], device=ids.device)
        last = torch.full((n + 1,), -1, dtype=torch.int64,
                          device=ids.device).scatter_reduce(
            0, tgt, pos, "amax")[:n]
        hit = (last >= 0).reshape((n,) + (1,) * (x.dim() - 1))
        return {"Out": torch.where(hit, upd.index_select(0, last.clamp(0)),
                                   x)}
    padded = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    return {"Out": padded.index_add(0, tgt, upd)[:n]}


def ordered_index_sum(values, target, n):
    """``values`` [M, ...] summed into ``n`` rows by ``target`` [M]
    (int64 in [0, n]; n marks a dropped row), each row's values in their
    order: a stable sort by target, then one float32 segment sum a row,
    cast to the values' dtype. ``index_add_`` sums floats with atomics on
    the card, in an order that changes run to run; integers it sums
    exactly, so they take it. No step reads the device from the host."""
    if not values.is_floating_point():
        out = values.new_zeros((n + 1,) + tuple(values.shape[1:]))
        return out.index_add(0, target, values)[:n]
    order = torch.sort(target, stable=True)[1]
    counts = torch.zeros(n + 1, dtype=torch.int64,
                         device=target.device).index_add_(
        0, target, torch.ones_like(target))
    sums = torch.segment_reduce(values.index_select(0, order).float(), "sum",
                                lengths=counts, unsafe=True)
    return sums[:n].to(values.dtype)


def int32_values(values, device):
    """An int32 vector of host ints made by fills on ``device``, with no
    host-to-device copy, so a compiled step can capture it."""
    if not values:
        return torch.zeros(0, dtype=torch.int32, device=device)
    return torch.cat([torch.full((1,), int(v), dtype=torch.int32,
                                 device=device) for v in values])


@register_op("shape", non_diff_inputs=("Input",))
def shape_op(ins, attrs):
    """X's shape as int32, as the reference's."""
    x = ins["Input"][0]
    return {"Out": int32_values(list(x.shape), x.device)}


@register_op("fill_zeros_like")
def fill_zeros_like(ins, attrs):
    return {"Out": torch.zeros_like(ins["X"][0])}


def _fill_value(value, dtype):
    """``value`` converted to ``dtype`` as XLA converts it (a float to an
    integer type truncates and saturates)."""
    if dtype.is_floating_point:
        return float(value)
    return convert(torch.tensor(float(value), dtype=torch.float64),
                   dtype).item()


@register_op("fill_any_like")
def fill_any_like(ins, attrs):
    x = ins["X"][0]
    dtype = attrs.get("dtype")
    dt = x.dtype if dtype in (None, -1) else x64_off(to_torch_dtype(dtype))
    return {"Out": torch.full(x.shape, _fill_value(attrs.get("value", 0.0),
                                                   dt),
                              dtype=dt, device=x.device)}


def _tile(x, reps):
    """``np.tile``: a shorter ``reps`` is padded with leading ones."""
    reps = [int(r) for r in reps]
    reps = [1] * (x.dim() - len(reps)) + reps
    if len(reps) > x.dim():
        x = x.reshape((1,) * (len(reps) - x.dim()) + tuple(x.shape))
    return x.repeat(reps)


@register_op("expand")
def expand(ins, attrs):
    return {"Out": _tile(ins["X"][0], attrs["expand_times"])}


@register_op("expand_v2")
def expand_v2(ins, attrs):
    x = ins["X"][0]
    shape = list(attrs["shape"])
    shape = [x.shape[i - (len(shape) - x.dim())] if d == -1 else d
             for i, d in enumerate(shape)]
    return {"Out": torch.broadcast_to(x, shape)}


@register_op("tile")
def tile(ins, attrs):
    return {"Out": _tile(ins["X"][0], attrs["repeat_times"])}


def _range_arg(attrs, ins, name, slot, default):
    """A bound of ``range``: the attr, else the input tensor, read on the
    host as the numpy scalar of its dtype (jnp.arange takes the
    concrete value to numpy). jnp.arange refuses anything but a scalar,
    the [1] tensors ``layers.range`` makes among them, and so does
    this."""
    if name in attrs:
        return attrs[name]
    vals = ins.get(slot)
    if not vals or vals[0] is None:
        return default
    v = vals[0]
    if v.dim() != 0:
        raise ValueError(f"range: arguments must be scalars; got {name} "
                         f"of shape {list(v.shape)}")
    return v.detach().cpu().numpy()


@register_op("range", skip_infer_shape=True, capturable=False,
             non_diff_inputs=("Start", "End", "Step"))
def range_op(ins, attrs):
    """``jnp.arange`` with a step, which is ``np.arange``: the length
    and values numpy gives (``torch.arange`` can count a float step
    otherwise). The length depends on the bounds' values, so tensor
    bounds are read on the host and the op is not capturable."""
    dtype = np.dtype(convert_dtype(attrs.get("dtype", "int64")))
    out = np.arange(_range_arg(attrs, ins, "start", "Start", 0),
                    _range_arg(attrs, ins, "end", "End", 0),
                    _range_arg(attrs, ins, "step", "Step", 1), dtype=dtype)
    return {"Out": torch.from_numpy(out).to(
        device=creation_device(), dtype=x64_off(to_torch_dtype(dtype)))}


@register_op("where", non_diff_inputs=("Condition",))
def where(ins, attrs):
    cond = ins["Condition"][0]
    if cond.dtype != torch.bool:
        cond = cond != 0
    return {"Out": torch.where(cond, ins["X"][0], ins["Y"][0])}


@register_op("cumsum")
def cumsum(ins, attrs):
    """Running sum along ``axis`` (``flatten`` or an axis of None: of X
    flattened, as ``jnp.cumsum``), from the end with ``reverse``; an
    integer or bool X sums in int32 (x64 off)."""
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    if attrs.get("flatten", False) or axis is None:
        x, axis = x.reshape(-1), 0
    axis = int(axis)
    if attrs.get("reverse", False):
        out = torch.cumsum(x.flip(axis), dim=axis).flip(axis)
    else:
        out = torch.cumsum(x, dim=axis)
    if not x.is_floating_point():
        out = out.to(torch.int32)
    return {"Out": out}


@register_op("pad")
def pad(ins, attrs):
    """Constant padding, ``paddings`` as (before, after) per axis from
    the first."""
    x = ins["X"][0]
    p = [int(v) for v in attrs["paddings"]]
    flat = []
    for i in reversed(range(x.dim())):
        flat += [p[2 * i], p[2 * i + 1]]
    return {"Out": torch.nn.functional.pad(
        x, flat, value=_fill_value(attrs.get("pad_value", 0.0), x.dtype))}


@register_op("tril_triu")
def tril_triu(ins, attrs):
    x = ins["X"][0]
    k = int(attrs.get("diagonal", 0))
    return {"Out": torch.tril(x, k) if attrs.get("lower", True)
            else torch.triu(x, k)}


@register_op("fill_constant_batch_size_like", non_diff_inputs=("Input",))
def fill_constant_batch_size_like(ins, attrs):
    """``shape`` with the dim at output_dim_idx taken from Input's dim at
    input_dim_idx, filled with ``value``."""
    x = ins["Input"][0]
    shape = [int(d) for d in attrs["shape"]]
    shape[int(attrs.get("output_dim_idx", 0))] = \
        x.shape[int(attrs.get("input_dim_idx", 0))]
    dtype = _dtype_of(attrs)
    return {"Out": torch.full(shape, _fill_value(attrs.get("value", 0.0),
                                                 dtype),
                              dtype=dtype, device=x.device)}
