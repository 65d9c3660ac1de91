"""Fake-quantisation and int8 serving lowerings (port of
``paddle_tpu/ops/quant_ops.py``).

* The three fake quantise-dequantise ops (:28, :38, :53): quantise to
  int``bits`` and dequantise in fp, with the reference's operation order
  (``clip(round(x / s * bnt)) * s / bnt``; ``torch.round`` rounds half to
  even as ``jnp.round`` does), so the CPU results equal the reference's
  bit for bit. The moving-average op threads its scale state through the
  scope as the reference does. Their gradient is the straight-through
  estimator (``_ste_grad``, :84-104): the output grad is copied to X.
* ``dequantize_weight`` (:108): int8 weight x per-channel scale.
* ``int8_matmul`` (:125), two modes behind one op:

  - weight-only (no ``act_scale``): ``act((X @ Y_i8) * YScale[col] +
    Bias)`` through the int8 GEMM kernel (``kernels/int8_gemm.py``,
    ``csrc/int8_gemm.cu``): the kernel on a CUDA tensor, its plain
    version on a CPU or meta tensor;
  - static quant (``act_scale``, the PTQ path): X quantised with the
    calibrated scale ``sx = act_scale / 127`` as ``clip(round(X / sx),
    -127, 127)`` to int8, an int8 x int8 product with int32 accumulation,
    then ``* sx * YScale``. The reference computes the product with
    ``lax.dot_general`` outside any Pallas kernel; here it is
    ``torch._int_mm`` on a CUDA tensor (cuBLAS, exact), with M padded to
    more than 16 and K, N to multiples of 8 by zeros, which leaves the
    product exact, and the weight column-major (``column_major``: the
    predictor lays each such weight out so once, on the card; another
    caller's row-major weight is copied so for the call;
    ``static_int8_calls`` counts those calls). On a CPU or
    meta tensor the product is taken in float64, exact for every int8
    product of K below 2**39 terms, and cast to int32.
"""

from __future__ import annotations

import math

import torch

from ..core.ir import OpDesc
from ..core.registry import register_grad_maker, register_op
from ..kernels.int8_gemm import int8_weight_only_gemm

static_int8_calls = 0   # torch._int_mm calls on the card since the reset

INT_MM_MIN_M = 17       # torch._int_mm on CUDA takes M > 16 rows
INT_MM_MULTIPLE = 8     # ... and K, N multiples of 8


def _qdq(x, scale, bits):
    bnt = float(2 ** (bits - 1) - 1)
    s = torch.clamp_min(scale, 1e-8)
    q = torch.clamp(torch.round(x / s * bnt), -bnt, bnt)
    return q * s / bnt


@register_op("fake_quantize_dequantize_abs_max")
def fake_qdq_abs_max(ins, attrs):
    x = ins["X"][0]
    bits = int(attrs.get("bit_length", 8))
    scale = torch.amax(torch.abs(x))
    return {"Out": _qdq(x, scale, bits), "OutScale": scale.reshape(1)}


@register_op("fake_channel_wise_quantize_dequantize_abs_max")
def fake_qdq_channel(ins, attrs):
    x = ins["X"][0]
    bits = int(attrs.get("bit_length", 8))
    axis = int(attrs.get("quant_axis", 0))
    red = tuple(i for i in range(x.dim()) if i != axis)
    scale = torch.amax(torch.abs(x), dim=red, keepdim=True)
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    return {"Out": _qdq(x, scale.reshape(shape), bits),
            "OutScale": scale.reshape(-1)}


def _state(ins, slot, like):
    """A state input as a 0-d fp32 tensor (0 when absent)."""
    vals = ins.get(slot)
    if vals and vals[0] is not None:
        return vals[0].reshape(())
    return torch.zeros((), dtype=torch.float32, device=like.device)


@register_op("fake_quantize_dequantize_moving_average_abs_max",
             non_diff_inputs=("InScale", "InAccum", "InState"))
def fake_qdq_moving_avg(ins, attrs):
    """Activation quant whose scale is a moving average of the abs-max
    across steps: accum = rate * accum + cur, state = rate * state + 1,
    scale = accum / state; in test mode InScale is used as it is."""
    x = ins["X"][0]
    bits = int(attrs.get("bit_length", 8))
    rate = float(attrs.get("moving_rate", 0.9))
    in_scale = ins["InScale"][0].reshape(())
    state = _state(ins, "InState", x)
    accum = _state(ins, "InAccum", x)
    cur = torch.amax(torch.abs(x)).to(torch.float32)
    if bool(attrs.get("is_test", False)):
        scale = in_scale
        state_out, accum_out = state, accum
    else:
        state_out = rate * state + 1.0
        accum_out = rate * accum + cur
        scale = accum_out / state_out
    return {"Out": _qdq(x, scale, bits),
            "OutScale": scale.reshape(1),
            "OutState": state_out.reshape(1),
            "OutAccum": accum_out.reshape(1)}


def _ste_grad(op: OpDesc, out_grads, in_grads):
    """Straight-through estimator: the output grad goes to X unchanged
    (the reference's fake_quantize grad kernels are identity copies)."""
    og = (out_grads.get("Out") or [None])[0]
    ig = (in_grads.get("X") or [None])[0]
    if og is None or ig is None:
        return []
    return [OpDesc("assign", {"X": [og]}, {"Out": [ig]}, {})]


for _t in ("fake_quantize_dequantize_abs_max",
           "fake_channel_wise_quantize_dequantize_abs_max",
           "fake_quantize_dequantize_moving_average_abs_max"):
    register_grad_maker(_t)(_ste_grad)


@register_op("dequantize_weight", non_diff_inputs=("X", "Scale"))
def dequantize_weight(ins, attrs):
    """fp32 = int8 weight * per-channel scale along attr ``axis``."""
    x = ins["X"][0]
    scale = ins["Scale"][0]
    axis = int(attrs.get("axis", -1))
    shape = [1] * x.dim()
    if scale.dim():
        shape[axis] = scale.reshape(-1).shape[0]
    return {"Out": x.to(torch.float32) * scale.reshape(shape)}


def _round_up(v: int, multiple: int) -> int:
    return -(-v // multiple) * multiple


def column_major(w8):
    """w8 laid out column-major (the same values and shape, strides (1,
    K)); no copy when it already is. On the card torch._int_mm runs a
    column-major weight on cuBLASLt's int8 tensor-core kernels and a
    row-major one on a far slower route (PERF.md §6, row 4)."""
    return w8.t().contiguous().t()


def int_mm_padded(xq, w8):
    """xq [M, K] int8 @ w8 [K, N] int8 -> [M, N] int32 through
    ``torch._int_mm``, the operands zero-padded to M > 16 and K, N
    multiples of 8 (zeros add nothing to an integer sum), the weight
    column-major (``column_major``)."""
    global static_int8_calls
    m, k = xq.shape
    n = w8.shape[1]
    mp = max(m, INT_MM_MIN_M)
    kp, np_ = _round_up(k, INT_MM_MULTIPLE), _round_up(n, INT_MM_MULTIPLE)
    if (mp, kp) != (m, k):
        xq = torch.nn.functional.pad(xq, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        w8 = torch.nn.functional.pad(w8, (0, np_ - n, 0, kp - k))
    acc = torch._int_mm(xq.contiguous(), column_major(w8))
    static_int8_calls += 1
    return acc[:m, :n]


def static_int8_product(xq, w8):
    """The exact int32 product of int8 [M, K] and [K, N]: ``_int_mm`` on a
    CUDA tensor, float64 (exact for these sums) on a CPU or meta one."""
    dev = xq.device.type
    if dev == "cuda":
        if w8.dtype != torch.int8 or w8.device != xq.device:
            raise ValueError(f"static int8_matmul: the weight must be an "
                             f"int8 tensor on {xq.device}, got {w8.dtype} "
                             f"on {w8.device}")
        return int_mm_padded(xq, w8)
    if dev in ("cpu", "meta"):
        return torch.matmul(xq.to(torch.float64),
                            w8.to(torch.float64)).to(torch.int32)
    raise ValueError(f"static int8_matmul: unsupported device {xq.device}")


@register_op("int8_matmul", non_diff_inputs=("Y", "YScale", "Bias"))
def int8_matmul(ins, attrs):
    """Weight-only (no ``act_scale``) or static-quant int8 GEMM; see the
    module docstring."""
    x, w = ins["X"][0], ins["Y"][0]
    sy = ins["YScale"][0].reshape(-1)
    act_scale = attrs.get("act_scale")
    if not act_scale:
        bias = ins["Bias"][0] if ins.get("Bias") and \
            ins["Bias"][0] is not None else None
        return {"Out": int8_weight_only_gemm(x, w, sy, bias=bias,
                                             act=attrs.get("act") or None)}
    return {"Out": static_int8_matmul(x, w, sy, act_scale)}


def quantize_activation(x, act_scale):
    """x's int8 codes under the calibrated abs-max ``act_scale``:
    ``clip(round(x / sx), -127, 127)``, sx = act_scale / 127."""
    # divide by a 0-d tensor: CUDA computes x / python_float as
    # x * (1 / sx), which can round one bit away from the division
    sx_t = torch.full((), float(act_scale) / 127.0, dtype=torch.float32,
                      device=x.device)
    return torch.clamp(torch.round(x.to(torch.float32) / sx_t), -127,
                       127).to(torch.int8)


def static_int8_matmul(x, w, sy, act_scale):
    """The static-quant mode: x [..., K] quantised (``quantize_activation``),
    the exact int32 product with the int8 weight w [K, N], then ``* sx *
    sy`` (sy: [N] per-channel weight scales)."""
    lead = tuple(x.shape[:-1])
    xq = quantize_activation(x, act_scale)
    acc = static_int8_product(xq.reshape(math.prod(lead), x.shape[-1]), w)
    out = acc.to(torch.float32) * (float(act_scale) / 127.0) * sy
    return out.reshape(lead + (w.shape[-1],))
