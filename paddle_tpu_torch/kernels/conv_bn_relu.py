"""3x3 stride-1 convolution with a fused inference-BN scale/shift and ReLU
epilogue, NHWC bf16.

Replaces ``_conv_kernel`` of ``tools/exp_pallas_conv.py`` (:31, launched
by ``pallas_conv_bn_relu`` :45 at :49): on an input padded once
(``xp`` [N, H+2, W+2, C] bf16) and an HWIO weight [3, 3, C, Co] bf16, it
sums the 9 shifted [rows, C] x [C, Co] products in fp32, then writes
``relu(acc * scale + shift)`` ([Co] fp32 each) as bf16 [N, H, W, Co]. The
Hopper kernel, ``csrc/conv_bn_relu.cu``, is an implicit GEMM over
M = N*H*W pixels, Co channels and K = 9*C on the bf16 tensor cores
(wgmma, fp32 accumulators). It computes what ``_conv_kernel`` computes,
not its grid: the images a grid step takes there are VMEM geometry.

On a CPU or meta tensor ``conv_bn_relu`` runs ``plain_conv_bn_relu`` (the
same 9 products, in plain PyTorch); on a CUDA tensor it launches the
kernel or raises. A weight whose Co is not a multiple of 8 is
zero-padded to one for the kernel's 16-byte copies; the extra channels
are never written.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0   # kernel launches since the last reset (not plain calls)

C_MULTIPLE, CO_MULTIPLE = 16, 4   # csrc/conv_bn_relu.cu accepts
LDO_MULTIPLE = 8                  # w's row, in 16-byte copies


def plain_conv_bn_relu(xp, w, scale, shift):
    """The kernel's arithmetic in plain PyTorch: the 9 shifted products of
    the bf16 values summed in fp32, the epilogue in fp32, rounded once."""
    n, hp, wp, c = xp.shape
    h, wd, co = hp - 2, wp - 2, w.shape[-1]
    xf, wf = xp.float(), w.float()
    acc = None
    for ky in range(3):
        for kx in range(3):
            xs = xf[:, ky:ky + h, kx:kx + wd, :].reshape(n * h * wd, c)
            d = xs @ wf[ky, kx]
            acc = d if acc is None else acc + d
    out = torch.relu(acc * scale.float() + shift.float())
    return out.reshape(n, h, wd, co).to(xp.dtype)


def _lib():
    lib = _build.load("conv_bn_relu")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.pt_conv_bn_relu.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci,
                                        ci, ci, vp]
        lib.pt_conv_bn_relu.restype = ctypes.c_int
        lib._typed = True
    return lib


def _launch(xp, w, scale, shift):
    global launches
    if xp.dim() != 4 or w.dim() != 4:
        raise ValueError("conv_bn_relu kernel: xp must be [N, H+2, W+2, C] "
                         "and w [3, 3, C, Co]")
    n, hp, wp, c = xp.shape
    co = w.shape[-1]
    if tuple(w.shape[:3]) != (3, 3, c) or hp < 3 or wp < 3:
        raise ValueError(f"conv_bn_relu kernel: weight {tuple(w.shape)} "
                         f"does not fit input {tuple(xp.shape)}")
    if c % C_MULTIPLE or co % CO_MULTIPLE:
        raise ValueError(f"conv_bn_relu kernel: C = {c} must be a multiple "
                         f"of {C_MULTIPLE} and Co = {co} of {CO_MULTIPLE}")
    for name, t, dt, numel in (("xp", xp, torch.bfloat16, None),
                               ("w", w, torch.bfloat16, None),
                               ("scale", scale, torch.float32, co),
                               ("shift", shift, torch.float32, co)):
        if t.device != xp.device or t.dtype != dt or not t.is_contiguous() \
                or numel is not None and t.numel() != numel:
            raise ValueError(f"conv_bn_relu kernel: {name} must be a "
                             f"contiguous {dt} tensor on {xp.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    ldo = -(-co // LDO_MULTIPLE) * LDO_MULTIPLE
    if ldo != co or w.data_ptr() % 16:
        w = torch.nn.functional.pad(w, (0, ldo - co))
    if xp.data_ptr() % 16:
        xp = xp.clone()
    out = torch.empty(n, hp - 2, wp - 2, co, dtype=xp.dtype,
                      device=xp.device)
    rc = _lib().pt_conv_bn_relu(
        xp.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        out.data_ptr(), n, hp - 2, wp - 2, c, co, ldo,
        torch.cuda.current_stream(xp.device).cuda_stream)
    _build.check(rc, "conv_bn_relu")
    launches += 1
    return out


def conv_bn_relu(xp, w, scale, shift):
    """relu(conv3x3(xp, w) * scale + shift) as NHWC bf16: the kernel on a
    CUDA tensor, the plain version on a CPU or meta one."""
    if xp.device.type in ("cpu", "meta"):
        return plain_conv_bn_relu(xp, w, scale, shift)
    if xp.device.type == "cuda":
        return _launch(xp, w, scale, shift)
    raise ValueError(f"conv_bn_relu: unsupported device {xp.device}")
