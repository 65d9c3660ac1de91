"""One-pass AdamW parameter update, in place.

Replaces ``_adamw_kernel`` of ``paddle_tpu/ops/pallas/fused_adam.py``
(:22, launched at :85 through ``fused_adamw`` :42): one kernel reads
param, grad and both moments and writes param and moments back, with
fp32 math for bf16 params, in the AdamFunctor form

    m' = b1 m + (1 - b1) g              v' = b2 v + (1 - b2) g g
    lr_t = lr sqrt(1 - b2^t) / (1 - b1^t)
    p' = p - (lr_t m' / (sqrt(v') + eps) + lr wd p)

The Hopper kernel, ``csrc/fused_adamw.cu``, is a grid-stride elementwise
pass that reads lr, b1^t and b2^t from device tensors, so a step's one
launch per parameter needs no host synchronisation. It updates the
tensors it is given: the counterpart of the reference's buffer donation.

On a CPU or meta tensor the wrapper runs ``plain_fused_adamw`` and copies
the results in; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0   # kernel launches since the last reset (not plain calls)

DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # template instances


def plain_fused_adamw(param, grad, m, v, lr, beta1, beta2, eps,
                      weight_decay, beta1_pow, beta2_pow):
    """The same update in plain PyTorch, out of place: returns
    (param', m', v'). lr, beta1_pow (b1^t) and beta2_pow (b2^t) are
    one-element fp32 tensors; the math is fp32 whatever param's dtype."""
    lr = lr.float().reshape(())
    bp1 = 1.0 - beta1_pow.float().reshape(())
    bp2 = 1.0 - beta2_pow.float().reshape(())
    p, g = param.float(), grad.float()
    m_new = beta1 * m.float() + (1.0 - beta1) * g
    v_new = beta2 * v.float() + (1.0 - beta2) * g * g
    lr_t = lr * torch.sqrt(bp2) / bp1
    upd = lr_t * m_new / (torch.sqrt(v_new) + eps) + lr * weight_decay * p
    return (p - upd).to(param.dtype), m_new.to(m.dtype), v_new.to(v.dtype)


def _lib():
    lib = _build.load("fused_adamw")
    if not getattr(lib, "_typed", False):
        vp, cf = ctypes.c_void_p, ctypes.c_float
        lib.pt_fused_adamw.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, ctypes.c_longlong, cf, cf, cf, cf,
            cf, cf, ctypes.c_int, vp]
        lib.pt_fused_adamw.restype = ctypes.c_int
        lib._typed = True
    return lib


def _launch(param, grad, m, v, lr, beta1, beta2, eps, wd, b1p, b2p):
    global launches
    dev = param.device
    if param.dtype not in DTYPES:
        raise ValueError(f"fused AdamW kernel: param dtype {param.dtype} "
                         f"not in {tuple(DTYPES)}")
    for name, t, dt, shape in (
            ("param", param, param.dtype, param.shape),
            ("grad", grad, param.dtype, param.shape),
            ("m", m, torch.float32, param.shape),
            ("v", v, torch.float32, param.shape),
            ("lr", lr, torch.float32, None),
            ("beta1_pow", b1p, torch.float32, None),
            ("beta2_pow", b2p, torch.float32, None)):
        ok_shape = t.numel() == 1 if shape is None else t.shape == shape
        if t.device != dev or t.dtype != dt or not ok_shape \
                or not t.is_contiguous():
            raise ValueError(f"fused AdamW kernel: {name} must be a "
                             f"contiguous {dt} tensor on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not param.numel():
        return
    rc = _lib().pt_fused_adamw(
        param.data_ptr(), grad.data_ptr(), m.data_ptr(), v.data_ptr(),
        lr.data_ptr(), b1p.data_ptr(), b2p.data_ptr(), param.numel(),
        float(beta1), float(1.0 - beta1), float(beta2), float(1.0 - beta2),
        float(eps), float(wd), DTYPES[param.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "fused AdamW")
    launches += 1


def fused_adamw_(param, grad, m, v, lr, beta1, beta2, eps, weight_decay,
                 beta1_pow, beta2_pow):
    """One AdamW step on param, m and v IN PLACE. param and grad are
    both fp32 or both bf16, m and v fp32; lr, beta1_pow and beta2_pow one-element
    fp32 tensors on param's device."""
    if param.device.type in ("cpu", "meta"):
        p2, m2, v2 = plain_fused_adamw(param, grad, m, v, lr, beta1, beta2,
                                       eps, weight_decay, beta1_pow,
                                       beta2_pow)
        param.copy_(p2)
        m.copy_(m2)
        v.copy_(v2)
    elif param.device.type == "cuda":
        _launch(param, grad, m, v, lr, beta1, beta2, eps, weight_decay,
                beta1_pow, beta2_pow)
    else:
        raise ValueError(f"fused AdamW: unsupported device {param.device}")
    return param, m, v
