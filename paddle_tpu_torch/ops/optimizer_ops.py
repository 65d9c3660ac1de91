"""Optimizer op lowerings: state updates are ops in the program (port
of ``paddle_tpu/ops/optimizer_ops.py``: sgd :48, momentum :63, adam :140,
adamw :167, adagrad :211, adamax :223, adadelta :241, rmsprop :257,
lars_momentum :283, lamb :303, ftrl :331, decayed_adagrad :350).

Each op names its parameter and state as both input and output. The
port's lowerings update those tensors IN PLACE and return the same
tensors: the counterpart of the reference's buffer donation, under which
XLA reuses the donated buffers.

A SelectedRows gradient (``embedding(is_sparse=True)``) takes the
reference's sparse branches: ``sgd`` and ``momentum`` update the touched
rows, as do ``adam`` and ``adamw`` under ``lazy_mode`` (the reference's
``_sparse_adam``, SparseAdamFunctor); every other optimizer, and
non-lazy Adam(W), densifies it first (the reference's ``_dense_grad``).
A row update merges duplicate rows first (``core/selected_rows.py``
``write_slots``), gathers the touched rows of the parameter and state,
computes them with the dense branch's arithmetic and writes them back
with ``index_copy_``; untouched rows are not read or written, and no
[V, D] gradient exists.
"""

from __future__ import annotations

import torch

from ..core.registry import register_op
from ..core.selected_rows import SelectedRows, write_slots
from ..kernels.fused_adam import fused_adamw_

_OPT = dict(non_diff_inputs=("Param", "Grad", "LearningRate", "Moment1",
                             "Moment2", "Beta1Pow", "Beta2Pow", "Velocity"))


def _norm(t):
    """The fp32 L2 norm of a whole tensor, as the reference writes it."""
    return torch.sqrt(torch.sum(torch.square(t)))


def _dense(g):
    """The gradient as a dense tensor (a SelectedRows densified)."""
    return g.to_dense() if isinstance(g, SelectedRows) else g


def _put(t, rows, new, old, live):
    """Write the touched rows back in place; a slot that is not live
    writes its row's old value."""
    live = live.reshape((-1,) + (1,) * (new.dim() - 1))
    t.index_copy_(0, rows, torch.where(live, new, old).to(t.dtype))


@register_op("sgd", **_OPT)
def sgd(ins, attrs):
    """p -= lr * g (reference sgd_op.cc); a SelectedRows g updates its
    rows, duplicates summed first (so a row gets the dense branch's
    bits)."""
    p, lr, g = ins["Param"][0], ins["LearningRate"][0], ins["Grad"][0]
    if isinstance(g, SelectedRows):
        rows, vals, live = write_slots(g)
        p_r = p.index_select(0, rows)
        _put(p, rows, p_r - lr.to(p.dtype) * vals.to(p.dtype), p_r, live)
        return {"ParamOut": p}
    p.sub_(lr.to(p.dtype) * g.to(p.dtype))
    return {"ParamOut": p}


@register_op("momentum", **_OPT)
def momentum(ins, attrs):
    """MomentumFunctor (reference momentum_op.h):
    v' = mu v + g, then p -= lr v' or, with ``use_nesterov``,
    p -= (g + mu v') lr; an ``l2_decay`` regularization adds
    regularization_coeff * p to g first. A SelectedRows g updates the
    velocity and parameter of its rows only: an untouched velocity does
    not decay (the reference's sparse kernel)."""
    p, v, lr = ins["Param"][0], ins["Velocity"][0], ins["LearningRate"][0]
    g = ins["Grad"][0]
    lr = lr.to(p.dtype)
    mu = float(attrs.get("mu", 0.9))
    rd = float(attrs.get("regularization_coeff", 0.0))
    l2 = attrs.get("regularization_method", "") == "l2_decay" and rd
    nesterov = attrs.get("use_nesterov", False)
    if isinstance(g, SelectedRows):
        rows, vals, live = write_slots(g)
        p_r, v_r = p.index_select(0, rows), v.index_select(0, rows)
        g_r = vals.to(p.dtype)
        if l2:
            g_r = g_r + rd * p_r
        v_new = v_r * mu + g_r
        p_new = p_r - (g_r + mu * v_new) * lr if nesterov \
            else p_r - lr * v_new
        _put(v, rows, v_new, v_r, live)
        _put(p, rows, p_new, p_r, live)
        return {"ParamOut": p, "VelocityOut": v}
    g = g.to(p.dtype)
    if l2:
        g = g + rd * p
    v.mul_(mu).add_(g)
    if nesterov:
        p.sub_((g + mu * v) * lr)
    else:
        p.sub_(lr * v)
    return {"ParamOut": p, "VelocityOut": v}


def _slots(ins, attrs):
    return (ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0],
            ins["Moment1"][0], ins["Moment2"][0], ins["Beta1Pow"][0],
            ins["Beta2Pow"][0], float(attrs.get("beta1", 0.9)),
            float(attrs.get("beta2", 0.999)),
            float(attrs.get("epsilon", 1e-8)))


def _sparse_adam(ins, attrs, coeff=0.0):
    """Row-wise Adam(W) on a SelectedRows gradient (the reference's
    ``_sparse_adam``, SparseAdamFunctor's lazy_mode,
    operators/optimizers/adam_op.h:404): the touched rows' moments and
    parameter are gathered, updated with the dense branch's arithmetic
    and written back; ``coeff`` adds AdamW's decoupled decay
    lr * coeff * p. Untouched rows keep their moments (no decay)."""
    p, g, lr, m1, m2, b1p, b2p, b1, b2, eps = _slots(ins, attrs)
    rows, vals, live = write_slots(g)
    m1_r, m2_r, p_r = (t.index_select(0, rows) for t in (m1, m2, p))
    gf = vals.to(m1.dtype)
    m1_new = torch.add(m1_r * b1, gf, alpha=1.0 - b1)
    m2_new = torch.addcmul(m2_r * b2, gf, gf, value=1.0 - b2)
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    step = lr_t * m1_new / (torch.sqrt(m2_new) + eps)
    pf = p_r.float()
    if coeff:
        step = step + lr * coeff * pf
    _put(m1, rows, m1_new, m1_r, live)
    _put(m2, rows, m2_new, m2_r, live)
    _put(p, rows, pf - step, p_r, live)
    return _outs(p, m1, m2, b1p, b2p, b1, b2)


def _outs(p, m1, m2, b1p, b2p, b1, b2):
    b1p.mul_(b1)
    b2p.mul_(b2)
    return {"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2,
            "Beta1PowOut": b1p, "Beta2PowOut": b2p}


@register_op("adam", **_OPT)
def adam(ins, attrs):
    """AdamFunctor (reference: operators/optimizers/adam_op.h), plain
    PyTorch: the reference has no Adam kernel either. With
    ``lazy_mode`` a SelectedRows gradient takes ``_sparse_adam``;
    otherwise it is densified."""
    if attrs.get("lazy_mode", False) and isinstance(ins["Grad"][0],
                                                    SelectedRows):
        return _sparse_adam(ins, attrs)
    p, g, lr, m1, m2, b1p, b2p, b1, b2, eps = _slots(ins, attrs)
    gf = _dense(g).to(m1.dtype)
    m1.mul_(b1).add_(gf, alpha=1.0 - b1)
    m2.mul_(b2).addcmul_(gf, gf, value=1.0 - b2)
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    step = lr_t * m1 / (torch.sqrt(m2) + eps)
    p.copy_((p.float() - step).to(p.dtype))
    return _outs(p, m1, m2, b1p, b2p, b1, b2)


@register_op("adamw", **_OPT)
def adamw(ins, attrs):
    """Adam with decoupled weight decay ``coeff``. With decay the update
    and both beta-power updates are one launch of the AdamW kernel
    (``kernels/fused_adam.py``): on the card there is no other route for
    a dense gradient. With ``lazy_mode`` a SelectedRows gradient takes
    the row-wise ``_sparse_adam``, as in the reference; otherwise it is
    densified."""
    decay = attrs.get("with_decay", True)
    if attrs.get("lazy_mode", False) and isinstance(ins["Grad"][0],
                                                    SelectedRows):
        return _sparse_adam(ins, attrs, float(attrs.get("coeff", 0.01))
                            if decay else 0.0)
    if not decay:
        return adam(ins, attrs)
    p, g, lr, m1, m2, b1p, b2p, b1, b2, eps = _slots(ins, attrs)
    fused_adamw_(p, _dense(g).contiguous(), m1, m2, lr, b1, b2, eps,
                 float(attrs.get("coeff", 0.01)), b1p, b2p)
    return {"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2,
            "Beta1PowOut": b1p, "Beta2PowOut": b2p}


@register_op("lars_momentum", **_OPT)
def lars_momentum(ins, attrs):
    """Layer-wise adaptive rate scaling (reference lars_momentum_op.cc),
    dense: local_lr = lr * lars_coeff * ||p|| / (||g|| + decay ||p|| +
    epsilon), v' = mu v + local_lr (g + decay p), p -= v'. A zero
    parameter norm gives local_lr 0. Plain PyTorch, as the reference
    keeps it plain jnp."""
    p, v, lr = ins["Param"][0], ins["Velocity"][0], ins["LearningRate"][0]
    g = _dense(ins["Grad"][0])
    mu = attrs.get("mu", 0.9)
    coeff = attrs.get("lars_coeff", 0.001)
    decay = attrs.get("lars_weight_decay", 0.0005)
    eps = attrs.get("epsilon", 1e-9)
    pn = _norm(p.to(torch.float32))
    gn = _norm(g.to(torch.float32))
    local_lr = lr * coeff * pn / (gn + decay * pn + eps)
    v.copy_(mu * v + local_lr * (g + decay * p))
    p.sub_(v)
    return {"ParamOut": p, "VelocityOut": v}


@register_op("lamb", **_OPT)
def lamb(ins, attrs):
    """LAMB (reference lamb_op.h), dense: Adam's moments and bias
    corrections, r = m^ / (sqrt(v^) + epsilon) + weight_decay * p, and
    p -= lr * (||p|| / ||r||) * r, the trust ratio taken as 1 where
    either norm is 0. Updates its tensors in place. Plain PyTorch, as the
    reference keeps it plain jnp."""
    p, lr = ins["Param"][0], ins["LearningRate"][0]
    g = _dense(ins["Grad"][0])
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-6)
    wd = attrs.get("weight_decay", 0.01)
    pf, gf = p.to(torch.float32), g.to(torch.float32)
    m1.copy_(b1 * m1 + (1 - b1) * gf)
    m2.copy_(b2 * m2 + (1 - b2) * gf * gf)
    r = (m1 / (1 - b1p)) / (torch.sqrt(m2 / (1 - b2p)) + eps) + wd * pf
    r_norm, p_norm = _norm(r), _norm(pf)
    ratio = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm, 1.0)
    p.copy_((pf - lr * ratio * r).to(p.dtype))
    b1p.mul_(b1)
    b2p.mul_(b2)
    return {"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2,
            "Beta1PowOut": b1p, "Beta2PowOut": b2p}


# -- the rest of the 2.0 optimizers (reference :211-360), dense: a
# SelectedRows gradient is densified first, as the reference's _dense_grad
# does. Each updates its parameter and state in place.

_OPT2 = dict(non_diff_inputs=_OPT["non_diff_inputs"] + (
    "Moment", "InfNorm", "AvgSquaredGrad", "AvgSquaredUpdate", "MeanSquare",
    "MeanGrad", "SquaredAccumulator", "LinearAccumulator"))


@register_op("adagrad", **_OPT2)
def adagrad(ins, attrs):
    """m' = m + g^2, p -= lr g / (sqrt(m') + epsilon)."""
    p, mom, lr = ins["Param"][0], ins["Moment"][0], ins["LearningRate"][0]
    g = _dense(ins["Grad"][0])
    eps = attrs.get("epsilon", 1e-6)
    mom.copy_(mom + g * g)
    p.copy_(p - lr * g / (torch.sqrt(mom) + eps))
    return {"ParamOut": p, "MomentOut": mom}


@register_op("adamax", **_OPT2)
def adamax(ins, attrs):
    """m' = b1 m + (1 - b1) g, u' = max(b2 u, |g|),
    p -= lr / (1 - Beta1Pow) * m' / (u' + epsilon). Beta1Pow is read and
    not advanced, as in the reference (the op has no Beta1PowOut)."""
    p, lr = ins["Param"][0], ins["LearningRate"][0]
    g = _dense(ins["Grad"][0])
    m, inf, b1p = ins["Moment"][0], ins["InfNorm"][0], ins["Beta1Pow"][0]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m.copy_(b1 * m + (1 - b1) * g)
    inf.copy_(torch.maximum(b2 * inf, torch.abs(g)))
    p.copy_(p - lr / (1 - b1p) * m / (inf + eps))
    return {"ParamOut": p, "MomentOut": m, "InfNormOut": inf}


@register_op("adadelta", **_OPT2)
def adadelta(ins, attrs):
    """E[g^2]' = rho E[g^2] + (1 - rho) g^2,
    u = sqrt(E[du^2] + eps) / sqrt(E[g^2]' + eps) * g, p -= u,
    E[du^2]' = rho E[du^2] + (1 - rho) u^2 (no learning rate)."""
    p = ins["Param"][0]
    g = _dense(ins["Grad"][0])
    avg_sq, avg_upd = ins["AvgSquaredGrad"][0], ins["AvgSquaredUpdate"][0]
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    avg_sq.copy_(rho * avg_sq + (1 - rho) * g * g)
    upd = torch.sqrt(avg_upd + eps) / torch.sqrt(avg_sq + eps) * g
    avg_upd.copy_(rho * avg_upd + (1 - rho) * upd * upd)
    p.copy_(p - upd)
    return {"ParamOut": p, "AvgSquaredGradOut": avg_sq,
            "AvgSquaredUpdateOut": avg_upd}


@register_op("rmsprop", **_OPT2)
def rmsprop(ins, attrs):
    """ms' = rho ms + (1 - rho) g^2 (centered: minus mg'^2, mg' = rho mg +
    (1 - rho) g), mom' = mu mom + lr g / sqrt(ms' (- mg'^2) + eps),
    p -= mom'."""
    p, lr = ins["Param"][0], ins["LearningRate"][0]
    g = _dense(ins["Grad"][0])
    ms, mom = ins["MeanSquare"][0], ins["Moment"][0]
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    mu = attrs.get("momentum", 0.0)
    ms.copy_(rho * ms + (1 - rho) * g * g)
    outs = {"ParamOut": p, "MeanSquareOut": ms, "MomentOut": mom}
    if attrs.get("centered", False):
        mg = ins["MeanGrad"][0]
        mg.copy_(rho * mg + (1 - rho) * g)
        denom = ms - mg * mg + eps
        outs["MeanGradOut"] = mg
    else:
        denom = ms + eps
    mom.copy_(mu * mom + lr * g / torch.sqrt(denom))
    p.copy_(p - mom)
    return outs


@register_op("decayed_adagrad", **_OPT2)
def decayed_adagrad(ins, attrs):
    """m' = decay m + (1 - decay) g^2, p -= lr g / (sqrt(m') + epsilon)."""
    p, mom, lr = ins["Param"][0], ins["Moment"][0], ins["LearningRate"][0]
    g = _dense(ins["Grad"][0])
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    mom.copy_(decay * mom + (1 - decay) * g * g)
    p.copy_(p - lr * g / (torch.sqrt(mom) + eps))
    return {"ParamOut": p, "MomentOut": mom}


@register_op("ftrl", **_OPT2)
def ftrl(ins, attrs):
    """FTRL-proximal in the reference's formulas: n' = n + g^2,
    sigma = (n'^-power - n^-power) / lr, z' = z + g - sigma p,
    p = (clip(z', -l1, l1) - z') / (n'^-power / lr + 2 l2)."""
    p, lr = ins["Param"][0], ins["LearningRate"][0]
    g = _dense(ins["Grad"][0])
    sq, lin = ins["SquaredAccumulator"][0], ins["LinearAccumulator"][0]
    l1 = float(attrs.get("l1", 0.0))
    l2 = float(attrs.get("l2", 0.0))
    power = float(attrs.get("lr_power", -0.5))
    new_sq = sq + g * g
    sigma = (new_sq ** -power - sq ** -power) / lr
    lin.copy_(lin + g - sigma * p)
    pre = torch.clamp(lin, -l1, l1) - lin
    denom = new_sq ** -power / lr + 2 * l2
    p.copy_(pre / denom)
    sq.copy_(new_sq)
    return {"ParamOut": p, "SquaredAccumOut": sq, "LinearAccumOut": lin}
