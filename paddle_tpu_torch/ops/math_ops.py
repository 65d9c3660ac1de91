"""Math lowerings: every op type of ``paddle_tpu/ops/math_ops.py``
(elementwise :38-46, the comparisons and logical ops :60-75, the
activations :88-111, softplus through minimum :124-206, the reductions
:211-231, mean, the norms, the matmul family, softmax, the losses,
accuracy, top_k, arg_max/arg_min, argsort, isfinite, fc).

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


class _TieClamp(torch.autograd.Function):
    """``torch.clamp`` with ``jnp.clip``'s gradient, which splits a tie:
    d/dx min(max(x, lo), hi) is ([x > lo] + [x == lo] / 2) *
    ([m < hi] + [m == hi] / 2) for m = max(x, lo), and 0 at NaN
    (``torch.clamp`` passes the whole gradient at a bound and at NaN)."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.lo, ctx.hi = lo, hi
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.lo, ctx.hi
        w = torch.ones_like(x)
        if lo is not None:
            w = (x > lo).to(x.dtype) + 0.5 * (x == lo).to(x.dtype)
            x = torch.clamp(x, min=lo)
        if hi is not None:
            w = w * ((x < hi).to(x.dtype) + 0.5 * (x == hi).to(x.dtype))
        return g * w, None, None


def tie_clip(x, lo=None, hi=None):
    """x clamped to [lo, hi] (either may be None); a float x gets
    ``jnp.clip``'s gradient (``_TieClamp``)."""
    if not x.is_floating_point():
        return torch.clamp(x, lo, hi)
    return _TieClamp.apply(x, lo, hi)


@register_op("clip")
def clip(ins, attrs):
    """X clamped to [min, max] (reference :190, ``jnp.clip``, whose
    gradient is half at a bound: ``tie_clip``); with neither bound, X
    itself."""
    lo, hi = attrs.get("min"), attrs.get("max")
    if lo is None and hi is None:
        return {"Out": ins["X"][0]}
    return {"Out": tie_clip(ins["X"][0], lo, hi)}


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


# -- the rest of the reference's math ops -------------------------------------

def _promoted(x, y):
    """x and y in their promoted dtype, as ``jnp``'s binary ufuncs take
    them (an int32 X with a float32 Y is float32)."""
    dt = torch.result_type(x, y)
    return x.to(dt), y.to(dt)


def _pow(x, y):
    """``jnp.power``. Integer powers take jax's six rounds of binary
    exponentiation (``_pow_int_int``): the exponent's low six bits, so a
    negative exponent gives 0 for |x| > 1 where ``torch.pow`` raises, and
    products wrap. A float X with an integer Y keeps X's dtype."""
    if x.is_floating_point() or y.is_floating_point():
        if x.is_floating_point() and not y.is_floating_point():
            return torch.pow(x, y.to(x.dtype))
        return torch.pow(*_promoted(x, y))
    x, y = _promoted(x, y)
    if x.dtype == torch.bool:
        x, y = x.to(torch.int32), y.to(torch.int32)
    acc = torch.where((x == 0) & (y != 0), torch.zeros_like(x),
                      torch.ones_like(x))
    for bit in range(6):
        acc = torch.where(((y >> bit) & 1).bool(), acc * x, acc)
        x = x * x
    return acc


def _int_divisor(y):
    """y with 0 and -1 replaced by 1: the divisions that XLA defines and
    C++ traps on (x / 0, INT_MIN / -1) are taken apart."""
    return torch.where((y == 0) | (y == -1), torch.ones_like(y), y)


def _fmod(x, y):
    """The C remainder, exact as XLA's. A float is taken in float64,
    where the remainder of two float32 values is exact and so rounds to
    itself: torch's vectorised float32 fmod gives NaN once x / y
    overflows (-1e30 over 1e-30)."""
    if x.is_floating_point() and x.dtype != torch.float64:
        return torch.fmod(x.double(), y.double()).to(x.dtype)
    return torch.fmod(x, y)


def _mod(x, y):
    """``jnp.mod``: the remainder takes the divisor's sign (the C
    remainder, corrected as jnp corrects it; ``torch.remainder`` computes
    x - y * floor(x / y) and rounds otherwise). An integer divisor of 0
    gives 0, as jnp's (it divides by 1 there)."""
    x, y = _promoted(x, y)
    if not x.is_floating_point():
        y = _int_divisor(y)
    trunc = _fmod(x, y)
    plus = (trunc != 0) & ((trunc < 0) != (y < 0))
    return torch.where(plus, trunc + y, trunc)


def _round_away(d):
    """``lax.round``'s default: halves away from zero (``torch.round``
    rounds them to even)."""
    t = torch.trunc(d)
    return t + torch.where((d - t).abs() >= 0.5, torch.sign(d),
                           torch.zeros_like(d))


def _floordiv(x, y):
    """``jnp.floor_divide``. Integers: XLA's truncating quotient (x / 0
    is -1, INT_MIN / -1 is INT_MIN) less one where the signs differ and
    XLA's remainder (x % 0 is x) is not 0. Floats: CPython's
    float_divmod as jnp takes it, so x / 0 and inf / y are NaN."""
    x, y = _promoted(x, y)
    if x.is_floating_point():
        mod = _fmod(x, y)
        div = (x - mod) / y
        ind = (mod != 0) & (torch.sign(y) != torch.sign(mod))
        return _round_away(torch.where(ind, div - 1, div))
    ys = _int_divisor(y)
    q = torch.where(y == 0, torch.full_like(x, -1),
                    torch.where(y == -1, 0 - x,
                                torch.div(x, ys, rounding_mode="trunc")))
    r = torch.where(y == 0, x, torch.where(y == -1, torch.zeros_like(x),
                                           _fmod(x, ys)))
    return torch.where((torch.sign(x) != torch.sign(y)) & (r != 0), q - 1, q)


register_op("elementwise_sub")(_ew(torch.sub))
register_op("elementwise_min")(_ew(torch.minimum))
register_op("elementwise_pow")(_ew(_pow))
register_op("elementwise_mod")(_ew(_mod))
register_op("elementwise_floordiv")(_ew(_floordiv))


def _cmp(fn):
    """A comparison or logical op: numpy broadcasting, the ``axis`` attr
    ignored (reference :60-75)."""
    def lowering(ins, attrs):
        return {"Out": fn(ins["X"][0], ins["Y"][0])}

    return lowering


for _name, _fn in (("equal", torch.eq), ("not_equal", torch.ne),
                   ("less_than", torch.lt), ("less_equal", torch.le),
                   ("greater_than", torch.gt), ("greater_equal", torch.ge),
                   ("logical_and", torch.logical_and),
                   ("logical_or", torch.logical_or),
                   ("logical_xor", torch.logical_xor)):
    register_op(_name, non_diff_inputs=("X", "Y"))(_cmp(_fn))


@register_op("logical_not", non_diff_inputs=("X",))
def logical_not(ins, attrs):
    return {"Out": torch.logical_not(ins["X"][0])}


def _int_same(fn):
    """An activation that jnp leaves an integer X unchanged by (floor,
    ceil, round)."""
    def run(x):
        return fn(x) if x.is_floating_point() else x.clone()

    return run


def _log_sigmoid(x):
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -torch.logaddexp(-x, torch.zeros_like(x))


for _name, _fn in (
        ("relu6", lambda x: tie_clip(x, 0.0, 6.0)),
        ("exp", torch.exp), ("log", torch.log), ("log2", torch.log2),
        ("rsqrt", torch.rsqrt), ("abs", torch.abs),
        ("floor", _int_same(torch.floor)), ("ceil", _int_same(torch.ceil)),
        ("round", _int_same(torch.round)),   # halves to even, as jnp
        ("reciprocal", torch.reciprocal),
        ("softsign", lambda x: x / (1 + torch.abs(x))),
        ("silu", lambda x: x * torch.sigmoid(x)),
        # the reference's swish is silu: its beta attr is not read (:107)
        ("swish", lambda x: x * torch.sigmoid(x)),
        # (sin is extra_ops' in the reference, which registers it last)
        ("cos", torch.cos), ("erf", torch.erf),
        ("logsigmoid", _log_sigmoid)):
    register_op(_name)(_unary(_fn))


@register_op("softplus")
def softplus(ins, attrs):
    """(1/beta) log(1 + exp(beta x)), x itself where beta x > threshold
    (reference :124)."""
    x = ins["X"][0]
    beta = float(attrs.get("beta", 1.0) or 1.0)
    threshold = float(attrs.get("threshold", 20.0) or 20.0)
    bx = beta * x
    return {"Out": torch.where(bx > threshold, x,
                               torch.logaddexp(bx, torch.zeros_like(bx))
                               / beta)}


@register_op("leaky_relu")
def leaky_relu(ins, attrs):
    x = ins["X"][0]
    return {"Out": torch.where(x >= 0, x, attrs.get("alpha", 0.02) * x)}


@register_op("elu")
def elu(ins, attrs):
    x = ins["X"][0]
    neg = torch.where(x > 0, torch.zeros_like(x), x)
    return {"Out": torch.where(x > 0, x,
                               attrs.get("alpha", 1.0) * torch.expm1(neg))}


@register_op("hard_sigmoid")
def hard_sigmoid(ins, attrs):
    x = ins["X"][0]
    return {"Out": tie_clip(x * attrs.get("slope", 0.2)
                            + attrs.get("offset", 0.5), 0.0, 1.0)}


@register_op("hard_swish")
def hard_swish(ins, attrs):
    x = ins["X"][0]
    t = attrs.get("threshold", 6.0)
    return {"Out": x * tie_clip(x + attrs.get("offset", 3.0), 0.0, t)
            / attrs.get("scale", 6.0)}


@register_op("pow")
def pow_op(ins, attrs):
    """X ** factor: an integer X with a float factor is float32, with an
    integer factor an integer power, as ``x ** factor`` is in jnp; a
    float X takes IEEE pow's values at -0 and -inf (C20)."""
    x, factor = ins["X"][0], attrs.get("factor", 1.0)
    if not x.is_floating_point() and isinstance(factor, int):
        return {"Out": _pow(x, torch.full_like(x, factor))}
    out = x ** factor
    if x.is_floating_point() and factor in (0.5, -0.5):
        # torch takes these as sqrt and rsqrt; IEEE pow (jnp's) gives
        # +0 and +inf at -0 and -inf for 0.5, +inf and +0 for -0.5
        zero, ninf = x == 0, x == float("-inf")
        if factor == 0.5:
            out = torch.where(zero, 0.0, torch.where(ninf, float("inf"), out))
        else:
            out = torch.where(zero, float("inf"),
                              torch.where(ninf, 0.0, out))
    return {"Out": out}


@register_op("maximum")
def maximum(ins, attrs):
    return {"Out": torch.maximum(ins["X"][0], ins["Y"][0])}


@register_op("minimum")
def minimum(ins, attrs):
    return {"Out": torch.minimum(ins["X"][0], ins["Y"][0])}


def _reduce_dims(x, attrs):
    """The axes a reduce op takes: every one with reduce_all or no dim,
    none for dim=[] (jnp's axis=())."""
    dims = attrs.get("dim")
    if attrs.get("reduce_all", False) or dims is None:
        return tuple(range(x.dim()))
    return tuple(int(d) % max(x.dim(), 1) for d in dims)


def _reduction(kind):
    def lowering(ins, attrs):
        x = ins["X"][0]
        keep = bool(attrs.get("keep_dim", False))
        dims = _reduce_dims(x, attrs)
        if kind in ("amax", "amin") and any(x.shape[d] == 0 for d in dims):
            raise ValueError(f"reduce_{kind[1:]}: zero-size array to a "
                             f"reduction with no identity")
        if not dims:    # jnp's axis=(): any/all give bool, prod an int32
            if kind in ("any", "all"):
                out = x != 0
            elif kind == "prod" and x.dtype == torch.bool:
                out = x.to(torch.int32)
            else:
                out = x.clone()
        elif kind in ("any", "all"):
            out = getattr(torch, kind)(x, dim=dims, keepdim=keep)
        elif kind == "prod":
            out = x
            for d in sorted(dims, reverse=True):
                out = out.prod(d, keepdim=keep)
            if not x.is_floating_point():   # jnp.prod: int32 (x64 off)
                out = out.to(torch.int32)
        else:   # NaN wins, as in jnp.max / jnp.min
            out = getattr(torch, kind)(x, dim=dims, keepdim=keep)
        return {"Out": out}

    return lowering


for _name, _kind in (("reduce_max", "amax"), ("reduce_min", "amin"),
                     ("reduce_prod", "prod"), ("reduce_any", "any"),
                     ("reduce_all", "all")):
    register_op(_name)(_reduction(_kind))


@register_op("squared_l2_norm")
def squared_l2_norm(ins, attrs):
    x = ins["X"][0]
    return {"Out": torch.square(x).sum().reshape(1)}


@register_op("p_norm")
def p_norm(ins, attrs):
    """``jnp.linalg.norm``: a vector norm over ``axis``; with no axis a
    vector norm of a 1-D X and a matrix norm of a 2-D one, as numpy
    (and ``torch.linalg.norm``) read ``ord``."""
    axis = attrs.get("axis", None)
    return {"Out": torch.linalg.norm(ins["X"][0],
                                     ord=attrs.get("porder", 2.0), dim=axis,
                                     keepdim=bool(attrs.get("keepdim",
                                                            False)))}


@register_op("bmm")
def bmm(ins, attrs):
    return {"Out": torch.matmul(ins["X"][0], ins["Y"][0])}


@register_op("dot")
def dot(ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    return {"Out": (x * y).sum(dim=-1, keepdim=True)}


@register_op("log_softmax")
def log_softmax(ins, attrs):
    """Step by step as ``jax.nn.log_softmax``: the max taken off (no
    gradient through it), then the log of the sum of exponentials."""
    x = ins["X"][0]
    axis = int(attrs.get("axis", -1))
    shifted = x - x.amax(dim=axis, keepdim=True).detach()
    return {"Out": shifted - torch.log(torch.exp(shifted).sum(
        dim=axis, keepdim=True))}


@register_op("sigmoid_cross_entropy_with_logits", non_diff_inputs=("Label",))
def sigmoid_cross_entropy_with_logits(ins, attrs):
    x, label = ins["X"][0], ins["Label"][0]
    return {"Out": torch.logaddexp(x, torch.zeros_like(x)) - x * label}


@register_op("huber_loss", non_diff_inputs=("Y",))
def huber_loss(ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    d = attrs.get("delta", 1.0)
    r = y - x
    a = torch.abs(r)
    return {"Out": torch.where(a <= d, 0.5 * r * r, d * (a - 0.5 * d)),
            "Residual": r}


@register_op("square_error_cost", non_diff_inputs=("Label",))
def square_error_cost(ins, attrs):
    d = ins["Input"][0] - ins["Label"][0]
    return {"Out": d * d}


@register_op("smooth_l1_loss", non_diff_inputs=("Y",))
def smooth_l1_loss(ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    sigma2 = attrs.get("sigma", 1.0) ** 2
    d = x - y
    a = torch.abs(d)
    diff = torch.where(a < 1.0 / sigma2, 0.5 * d * d * sigma2,
                       a - 0.5 / sigma2)
    return {"Out": diff.sum(dim=-1, keepdim=True), "Diff": diff}


@register_op("kldiv_loss", non_diff_inputs=("Target",))
def kldiv_loss(ins, attrs):
    x, t = ins["X"][0], ins["Target"][0]
    loss = torch.where(t > 0, t * (torch.log(t) - x), 0.0)
    red = attrs.get("reduction", "mean")
    if red == "mean":
        loss = loss.mean()
    elif red == "sum":
        loss = loss.sum()
    elif red == "batchmean":
        loss = loss.sum() / x.shape[0]
    return {"Loss": loss}


register_op("top_k_v2", non_diff_inputs=("X",))(top_k)


def _arg(fn, x, axis):
    """torch.argmax/argmin as jnp's: NaN counts as the extreme, the
    first index wins a tie, bool compares as 0/1; int32 (x64 off)."""
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    return fn(x, dim=axis).to(torch.int32)


@register_op("arg_max", non_diff_inputs=("X",))
def arg_max(ins, attrs):
    axis = int(attrs.get("axis", -1))
    out = _arg(torch.argmax, ins["X"][0], axis)
    if attrs.get("keepdims", False):
        out = out.unsqueeze(axis)
    return {"Out": out}


@register_op("arg_min", non_diff_inputs=("X",))
def arg_min(ins, attrs):
    return {"Out": _arg(torch.argmin, ins["X"][0],
                        int(attrs.get("axis", -1)))}


@register_op("argsort", non_diff_inputs=("X",))
def argsort(ins, attrs):
    """A stable sort, as jnp's: equal values (0 and -0 among them) keep
    their order both ways, NaN sorts as the largest. Indices int32."""
    x = ins["X"][0]
    axis = int(attrs.get("axis", -1))
    idx = torch.sort(x, dim=axis,
                     descending=bool(attrs.get("descending", False)),
                     stable=True)[1]
    return {"Out": torch.gather(x, axis, idx), "Indices": idx.to(torch.int32)}


@register_op("isfinite_v2", non_diff_inputs=("X",))
def isfinite_v2(ins, attrs):
    return {"Out": torch.isfinite(ins["X"][0])}
