"""Fused training-time BatchNorm(+residual add)+ReLU with a pinned
minimal-residual backward: the port of ``paddle_tpu/ops/pallas/bn_act.py``
(a ``jax.custom_vjp``, no Pallas kernel), in plain PyTorch.

    y = act((x - mean(x)) * rsqrt(var(x) + eps) * scale + bias [+ z])

``FusedBnAddAct`` is a ``torch.autograd.Function`` that saves exactly the
reference's residual set ``(x, scale, mean, inv, z, bias_f32)`` (``_fwd``
:62): no fp32 copy of x and no pre-activation tensor survive to the
backward, which recomputes the ReLU mask from the normalised form
(``_bwd`` :69). NCHW (``c_axis=1``) or NHWC (``c_axis=-1``); statistics
in fp32 over bf16 inputs, the affine in x's dtype.
"""

from __future__ import annotations

import math

import torch


def _axes_and_bshape(x, c_axis):
    c_axis = c_axis % x.dim()
    axes = tuple(i for i in range(x.dim()) if i != c_axis)
    bshape = [1] * x.dim()
    bshape[c_axis] = x.shape[c_axis]
    return axes, bshape


def _batch_stats(x, axes, eps):
    """(mean, var, inv) in fp32, variance as E[x^2] - mean^2."""
    xf = x.float()
    mean = xf.mean(dim=axes)
    var = (xf * xf).mean(dim=axes) - mean * mean
    return mean, var, torch.rsqrt(var + eps)


def _affine_act(x, scale_f, bias_f, mean, inv, z, bshape, act):
    """act(x * a + b [+ z]) with a = inv * scale and b = bias - mean * inv
    * scale, both cast to x's dtype, as the reference's forward computes
    it."""
    a = (inv * scale_f).to(x.dtype)
    b = (bias_f - mean * inv * scale_f).to(x.dtype)
    pre = x * a.reshape(bshape) + b.reshape(bshape)
    if z is not None:
        pre = pre + z
    return torch.relu(pre) if act == "relu" else pre


class FusedBnAddAct(torch.autograd.Function):
    """Gradients for x, scale, bias and z; the batch mean and inv
    (= rsqrt(var + eps)) come in computed and take no gradient."""

    @staticmethod
    def forward(ctx, x, scale, bias, z, mean, inv, c_axis, act):
        _, bshape = _axes_and_bshape(x, c_axis)
        bias_f = bias.float()
        ctx.c_axis, ctx.act = c_axis, act
        ctx.save_for_backward(x, scale, mean, inv, z, bias_f)
        return _affine_act(x, scale.float(), bias_f, mean, inv, z, bshape,
                           act)

    @staticmethod
    def backward(ctx, dy):
        x, scale, mean, inv, z, bias_f = ctx.saved_tensors
        axes, bshape = _axes_and_bshape(x, ctx.c_axis)
        n = float(math.prod(x.shape[i] for i in axes))
        scale_f = scale.float()
        x_hat = (x.float() - mean.reshape(bshape)) * inv.reshape(bshape)
        dyf = dy.float()
        if ctx.act == "relu":
            pre = x_hat * scale_f.reshape(bshape) + bias_f.reshape(bshape)
            if z is not None:
                pre = pre + z.float()
            dyf = torch.where(pre > 0, dyf, torch.zeros_like(dyf))
        dz = dyf.to(x.dtype) if z is not None else None
        dbias = dyf.sum(dim=axes)
        dscale = (dyf * x_hat).sum(dim=axes)
        t = dyf - (dbias.reshape(bshape) / n) \
            - x_hat * (dscale.reshape(bshape) / n)
        dx = (t * (inv * scale_f).reshape(bshape)).to(x.dtype)
        return (dx, dscale.to(scale.dtype), dbias.to(scale.dtype), dz,
                None, None, None, None)


def fused_batch_norm_act(x, scale, bias, mean, var, z=None, *, eps=1e-5,
                         momentum=0.9, c_axis=1, act="relu", is_test=False):
    """The full training contract (reference :95): returns (y, mean_out,
    var_out, saved_mean, saved_inv). Training normalises with the batch
    statistics and moves the running ones by ``momentum``; ``is_test``
    normalises with the running statistics and saves zeros. The batch
    statistics are computed once, outside the autograd graph: they are
    outputs for the running update, never a training signal."""
    _, bshape = _axes_and_bshape(x, c_axis)
    if is_test:
        inv = torch.rsqrt(var.float() + eps)
        y = _affine_act(x, scale.float(), bias.float(), mean.float(), inv, z,
                        bshape, act)
        return y, mean, var, torch.zeros_like(mean), torch.zeros_like(var)
    axes, _ = _axes_and_bshape(x, c_axis)
    with torch.no_grad():
        batch_mean, batch_var, inv = _batch_stats(x.detach(), axes, eps)
    y = FusedBnAddAct.apply(x, scale, bias, z, batch_mean, inv, c_axis, act)
    mean_out = mean * momentum + batch_mean * (1.0 - momentum)
    var_out = var * momentum + batch_var * (1.0 - momentum)
    return y, mean_out, var_out, batch_mean, inv
