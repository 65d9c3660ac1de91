"""Optimizer op lowerings: state updates are ops in the program (port
of ``paddle_tpu/ops/optimizer_ops.py``: sgd :48, momentum :63, adam :140,
adamw :167, lars_momentum :283, lamb :303).

Each op names its parameter and state as both input and output. The
port's lowerings update those tensors IN PLACE and return the same
tensors: the counterpart of the reference's buffer donation, under which
XLA reuses the donated buffers. Gradients are dense; the SelectedRows
branches (adam's ``lazy_mode``, sparse sgd and momentum) are not in the
port.
"""

from __future__ import annotations

import torch

from ..core.registry import register_op
from ..kernels.fused_adam import fused_adamw_

_OPT = dict(non_diff_inputs=("Param", "Grad", "LearningRate", "Moment1",
                             "Moment2", "Beta1Pow", "Beta2Pow", "Velocity"))


def _norm(t):
    """The fp32 L2 norm of a whole tensor, as the reference writes it."""
    return torch.sqrt(torch.sum(torch.square(t)))


def _dense(g, op):
    if not isinstance(g, torch.Tensor):
        raise NotImplementedError(
            f"{op} with a SelectedRows gradient is not in the port")
    return g


@register_op("sgd", **_OPT)
def sgd(ins, attrs):
    """p -= lr * g (reference sgd_op.cc, dense branch)."""
    p, lr = ins["Param"][0], ins["LearningRate"][0]
    g = _dense(ins["Grad"][0], "sgd")
    p.sub_(lr.to(p.dtype) * g.to(p.dtype))
    return {"ParamOut": p}


@register_op("momentum", **_OPT)
def momentum(ins, attrs):
    """MomentumFunctor (reference momentum_op.h), dense branch:
    v' = mu v + g, then p -= lr v' or, with ``use_nesterov``,
    p -= (g + mu v') lr; an ``l2_decay`` regularization adds
    regularization_coeff * p to g first."""
    p, v, lr = ins["Param"][0], ins["Velocity"][0], ins["LearningRate"][0]
    g = _dense(ins["Grad"][0], "momentum").to(p.dtype)
    lr = lr.to(p.dtype)
    mu = float(attrs.get("mu", 0.9))
    rd = float(attrs.get("regularization_coeff", 0.0))
    if attrs.get("regularization_method", "") == "l2_decay" and rd:
        g = g + rd * p
    v.mul_(mu).add_(g)
    if attrs.get("use_nesterov", False):
        p.sub_((g + mu * v) * lr)
    else:
        p.sub_(lr * v)
    return {"ParamOut": p, "VelocityOut": v}


def _slots(ins, attrs):
    if attrs.get("lazy_mode", False):
        raise NotImplementedError(
            "adam/adamw lazy_mode (SelectedRows grads) is not in the port")
    return (ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0],
            ins["Moment1"][0], ins["Moment2"][0], ins["Beta1Pow"][0],
            ins["Beta2Pow"][0], float(attrs.get("beta1", 0.9)),
            float(attrs.get("beta2", 0.999)),
            float(attrs.get("epsilon", 1e-8)))


def _outs(p, m1, m2, b1p, b2p, b1, b2):
    b1p.mul_(b1)
    b2p.mul_(b2)
    return {"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2,
            "Beta1PowOut": b1p, "Beta2PowOut": b2p}


@register_op("adam", **_OPT)
def adam(ins, attrs):
    """AdamFunctor (reference: operators/optimizers/adam_op.h), plain
    PyTorch: the reference has no Adam kernel either."""
    p, g, lr, m1, m2, b1p, b2p, b1, b2, eps = _slots(ins, attrs)
    gf = g.to(m1.dtype)
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
    (``kernels/fused_adam.py``): on the card there is no other route."""
    if not attrs.get("with_decay", True):
        return adam(ins, attrs)
    p, g, lr, m1, m2, b1p, b2p, b1, b2, eps = _slots(ins, attrs)
    fused_adamw_(p, g.contiguous(), m1, m2, lr, b1, b2, eps,
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
    g = _dense(ins["Grad"][0], "lars_momentum")
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
    g = _dense(ins["Grad"][0], "lamb")
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
