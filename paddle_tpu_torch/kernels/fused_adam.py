"""One-pass AdamW parameter update, in place.

Replaces ``_adamw_kernel`` of ``paddle_tpu/ops/pallas/fused_adam.py``
(:22, launched at :85 through ``fused_adamw`` :42): one kernel reads
param, grad and both moments and writes param and moments back, with
fp32 math for bf16 params, in the AdamFunctor form

    m' = b1 m + (1 - b1) g              v' = b2 v + (1 - b2) g g
    lr_t = lr sqrt(1 - b2^t) / (1 - b1^t)
    p' = p - (lr_t m' / (sqrt(v') + eps) + lr wd p)

The Hopper kernel, ``csrc/fused_adamw.cu``, streams the tensors in
16-byte evict-first vectors (8 bf16 or 4 fp32 elements a thread, all of
a vector's loads in flight before any is used), a block for every 256
vectors, with a scalar head and tail that ``split`` cuts off where a
view does not start on a 16-byte boundary or its length is not a whole
number of vectors. It reads lr, b1^t and b2^t from device
tensors, so a step's one launch per parameter needs no host
synchronisation, and the same launch also updates b1^t *= b1 and
b2^t *= b2, as the ``adamw`` op's Beta1PowOut and Beta2PowOut. It
updates the tensors it is given: the counterpart of the reference's
buffer donation.

The power update needs a ticket, one int that every launch leaves 0
(``_ticket``): the stream's own for an eager launch, so launches on two
streams never share one, and one of its own for a launch captured into a
CUDA graph, zeroed inside the graph before the launch, so a graph may
replay on any stream, beside eager launches or other graphs. Only a
launch cut short by a device fault could leave a ticket non-zero, and
such a fault ends the CUDA context for every later call anyway.

On a CPU or meta tensor the wrapper runs ``plain_fused_adamw``, copies
the results in and advances the powers; on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0   # kernel launches since the last reset (not plain calls)

DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # template instances
VEC = {torch.float32: 4, torch.bfloat16: 8}      # elements a 16-byte vector

# (device index, stream) -> the ticket of eager launches on that stream
_TICKETS = {}


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


def split(numel: int, esz: int, vec: int, p_addr: int, g_addr: int,
          m_addr: int, v_addr: int):
    """(head, nvec): the kernel updates elements [0, head) one by one,
    the nvec vectors of ``vec`` elements after them 16 bytes at a time,
    and the tail past them one by one. head brings p (``esz`` bytes an
    element, as g; m and v fp32) to a 16-byte boundary; where g, m or v
    are not on one there too, every element goes one by one."""
    head = min(numel, (-p_addr % 16) // esz)
    if p_addr % esz or any((a + head * s) % 16 for a, s in (
            (g_addr, esz), (m_addr, 4), (v_addr, 4))):
        return numel, 0
    return head, (numel - head) // vec


def _lib():
    lib = _build.load("fused_adamw")
    if not getattr(lib, "_typed", False):
        vp, cf, ll = ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong
        lib.pt_fused_adamw.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, ll, ll, ll, cf, cf, cf, cf, cf,
            cf, ctypes.c_int, vp]
        lib.pt_fused_adamw.restype = ctypes.c_int
        lib._typed = True
    return lib


def _ticket(dev, stream):
    """The beta-power ticket of a launch on ``stream`` (one int32, 0).
    While the stream captures a CUDA graph, a new one allocated and zeroed
    inside the capture: the graph owns it and zeroes it before the launch
    on every replay, so it never shares a ticket with eager launches or
    with another graph, whatever stream it replays on."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(1, dtype=torch.int32, device=dev)
    ticket = _TICKETS.get((dev.index, stream))
    if ticket is None:
        ticket = _TICKETS[dev.index, stream] = torch.zeros(
            1, dtype=torch.int32, device=dev)
    return ticket


def _refuse(param, grad, m, v, lr, b1p, b2p):
    """Raise the message for the first argument the kernel cannot take."""
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
    raise ValueError("fused AdamW kernel: arguments it cannot take")


def _launch(param, grad, m, v, lr, beta1, beta2, eps, wd, b1p, b2p):
    global launches
    dev, dt, shape = param.device, param.dtype, param.shape
    f32 = torch.float32
    # one pass of cheap tests; _refuse names the argument at fault
    if not (dt in DTYPES and grad.dtype == dt and m.dtype == f32
            and v.dtype == f32 and lr.dtype == f32 and b1p.dtype == f32
            and b2p.dtype == f32 and grad.shape == shape
            and m.shape == shape and v.shape == shape and lr.numel() == 1
            and b1p.numel() == 1 and b2p.numel() == 1
            and grad.device == dev and m.device == dev and v.device == dev
            and lr.device == dev and b1p.device == dev and b2p.device == dev
            and param.is_contiguous() and grad.is_contiguous()
            and m.is_contiguous() and v.is_contiguous()):
        _refuse(param, grad, m, v, lr, b1p, b2p)
    numel = param.numel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ticket = _ticket(dev, stream)
    p_addr, g_addr = param.data_ptr(), grad.data_ptr()
    m_addr, v_addr = m.data_ptr(), v.data_ptr()
    head, nvec = split(numel, param.element_size(), VEC[dt], p_addr, g_addr,
                       m_addr, v_addr)
    rc = _lib().pt_fused_adamw(
        p_addr, g_addr, m_addr, v_addr, lr.data_ptr(), b1p.data_ptr(),
        b2p.data_ptr(), ticket.data_ptr(), numel, head, nvec, float(beta1),
        float(1.0 - beta1), float(beta2), float(1.0 - beta2), float(eps),
        float(wd), DTYPES[dt], stream)
    _build.check(rc, "fused AdamW")
    launches += 1


def fused_adamw_(param, grad, m, v, lr, beta1, beta2, eps, weight_decay,
                 beta1_pow, beta2_pow):
    """One AdamW step on param, m and v IN PLACE. param and grad are
    both fp32 or both bf16, m and v fp32; lr, beta1_pow and beta2_pow
    one-element fp32 tensors on param's device. Also multiplies beta1_pow
    by beta1 and beta2_pow by beta2 in place, after the update has read
    them (on the card, in the same launch)."""
    if param.device.type in ("cpu", "meta"):
        p2, m2, v2 = plain_fused_adamw(param, grad, m, v, lr, beta1, beta2,
                                       eps, weight_decay, beta1_pow,
                                       beta2_pow)
        param.copy_(p2)
        m.copy_(m2)
        v.copy_(v2)
        beta1_pow.mul_(beta1)
        beta2_pow.mul_(beta2)
    elif param.device.type == "cuda":
        _launch(param, grad, m, v, lr, beta1, beta2, eps, weight_decay,
                beta1_pow, beta2_pow)
    else:
        raise ValueError(f"fused AdamW: unsupported device {param.device}")
    return param, m, v
