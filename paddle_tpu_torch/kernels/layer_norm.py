"""Layer normalisation over the last axis: the ``fused_layer_norm`` op's
forward kernel and its gradient.

Replaces ``_ln_kernel`` of ``paddle_tpu/ops/pallas/layer_norm.py`` (:21,
launched by ``_ln_pallas`` :37 at :71): per row, in fp32, the mean, the
centred variance, rstd = rsqrt(var + eps), then the optional scale and
bias; y in x's dtype, mean and rstd fp32 [rows]. The Hopper kernel,
``csrc/layer_norm.cu``, takes one row a block of 256 threads, held in
registers, for any width up to ``MAX_H``; the reference's route for a
width that is not a multiple of 128 is its jnp formula, which computes
the same function.

The backward is the reference's formula (``_fused_ln_bwd`` :94) in plain
PyTorch, as the reference's is jnp: no cotangent flows through mean and
rstd, which are statistics outputs.

On a CPU or meta tensor ``layer_norm_fwd`` runs ``plain_layer_norm``; on
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0   # kernel launches since the last reset (not plain calls)

MAX_H = 8192   # csrc/layer_norm.cu: 256 threads x 32 values a thread
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # template instances


def plain_layer_norm(x2, scale, bias, eps):
    """The kernel's arithmetic in plain PyTorch: (y, mean, rstd) of a
    [rows, h] x2."""
    xf = x2.float()
    mean = xf.mean(dim=-1)
    xc = xf - mean[:, None]
    rstd = torch.rsqrt((xc * xc).mean(dim=-1) + eps)
    y = xc * rstd[:, None]
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x2.dtype), mean, rstd


def _lib():
    lib = _build.load("layer_norm")
    if not getattr(lib, "_typed", False):
        vp = ctypes.c_void_p
        lib.pt_layer_norm.argtypes = [vp, vp, vp, vp, vp, vp, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_float,
                                      ctypes.c_int, vp]
        lib.pt_layer_norm.restype = ctypes.c_int
        lib._typed = True
    return lib


def _launch(x2, scale, bias, eps):
    global launches
    rows, h = x2.shape
    if x2.dtype not in DTYPES or not x2.is_contiguous():
        raise ValueError(f"layer norm kernel: x must be a contiguous tensor "
                         f"of {tuple(DTYPES)}, got {x2.dtype}")
    if not 0 < h <= MAX_H:
        raise ValueError(f"layer norm kernel: width {h} outside 1..{MAX_H}")
    vecs = []
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None:
            if t.device != x2.device or t.numel() != h:
                raise ValueError(f"layer norm kernel: {name} must hold {h} "
                                 f"values on {x2.device}")
            t = t.reshape(h).float().contiguous()
        vecs.append(t)
    y = torch.empty_like(x2)
    mean = torch.empty(rows, device=x2.device)
    rstd = torch.empty(rows, device=x2.device)
    if rows:
        rc = _lib().pt_layer_norm(
            x2.data_ptr(), *(None if t is None else t.data_ptr()
                             for t in vecs),
            y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), rows, h,
            float(eps), DTYPES[x2.dtype],
            torch.cuda.current_stream(x2.device).cuda_stream)
        _build.check(rc, "layer norm")
        launches += 1
    return y, mean, rstd


def layer_norm_fwd(x2, scale, bias, eps):
    """(y, mean, rstd) of a [rows, h] x2: the kernel on a CUDA tensor, the
    plain version on a CPU or meta one."""
    if x2.device.type in ("cpu", "meta"):
        return plain_layer_norm(x2, scale, bias, eps)
    if x2.device.type == "cuda":
        return _launch(x2, scale, bias, eps)
    raise ValueError(f"layer norm: unsupported device {x2.device}")


class FusedLayerNorm(torch.autograd.Function):
    """The kernel forward with the reference's backward formula."""

    @staticmethod
    def forward(ctx, x2, scale, bias, eps):
        y, mean, rstd = layer_norm_fwd(x2, scale, bias, eps)
        ctx.save_for_backward(x2, scale, bias, mean, rstd)
        ctx.mark_non_differentiable(mean, rstd)
        return y, mean, rstd

    @staticmethod
    def backward(ctx, dy, _dmean, _drstd):
        x2, scale, bias, mean, rstd = ctx.saved_tensors
        xhat = (x2.float() - mean[:, None]) * rstd[:, None]
        dyf = dy.float()
        dscale = (dyf * xhat).sum(dim=0).to(scale.dtype) \
            if scale is not None else None
        dbias = dyf.sum(dim=0).to(bias.dtype) if bias is not None else None
        g = dyf * scale.float() if scale is not None else dyf
        # dx = rstd * (g - mean(g) - xhat * mean(g * xhat))
        gm = g.mean(dim=-1, keepdim=True)
        gxm = (g * xhat).mean(dim=-1, keepdim=True)
        dx = (rstd[:, None] * (g - gm - xhat * gxm)).to(x2.dtype)
        return dx, dscale, dbias, None


def fused_layer_norm(x, scale=None, bias=None, eps=1e-5):
    """Layer norm over the last axis of x: (y, mean, rstd), mean and rstd
    shaped like x without its last axis."""
    lead, h = tuple(x.shape[:-1]), x.shape[-1]
    y, mean, rstd = FusedLayerNorm.apply(x.reshape(-1, h).contiguous(),
                                         scale, bias, float(eps))
    return y.reshape(x.shape), mean.reshape(lead), rstd.reshape(lead)
