"""Optimizer op lowerings: state updates are ops in the program (port
of ``paddle_tpu/ops/optimizer_ops.py``: adam :140, adamw :167).

Each op names its parameter and state as both input and output. The
port's lowerings update those tensors IN PLACE and return the same
tensors: the counterpart of the reference's buffer donation, under which
XLA reuses the donated buffers. Gradients are dense; the SelectedRows
``lazy_mode`` branch is not in the port.
"""

from __future__ import annotations

import torch

from ..core.registry import register_op
from ..kernels.fused_adam import fused_adamw_

_OPT = dict(non_diff_inputs=("Param", "Grad", "LearningRate", "Moment1",
                             "Moment2", "Beta1Pow", "Beta2Pow"))


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
    is the one-pass AdamW kernel (``kernels/fused_adam.py``): on the
    card there is no other route."""
    if not attrs.get("with_decay", True):
        return adam(ins, attrs)
    p, g, lr, m1, m2, b1p, b2p, b1, b2, eps = _slots(ins, attrs)
    fused_adamw_(p, g.contiguous(), m1, m2, lr, b1, b2, eps,
                 float(attrs.get("coeff", 0.01)), b1p, b2p)
    return _outs(p, m1, m2, b1p, b2p, b1, b2)
