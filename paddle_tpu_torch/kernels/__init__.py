"""Hand-written Hopper kernels of the port, one module per TPU kernel
file of ``paddle_tpu/ops/pallas`` (and ``conv_bn_relu`` for the kernel
of ``tools/exp_pallas_conv.py``); sources in ``paddle_tpu_torch/csrc``.

Every wrapper takes its plain PyTorch version for CPU and ``meta``
tensors (tests, shape inference) and, for a CUDA tensor, launches its
kernel or raises: there is no fallback and no switch that turns a kernel
off on the card. Each wrapper counts its kernel launches in a plain
module-level integer (``launches``; the flash module's backward kernel
counts in ``bwd_launches``). The flash module also splits its two counts
by the layout the kernel read (``layout_counts``) and by the dtype
instance it ran (``dtype_counts``: bf16 on the tensor cores, fp32 on the
CUDA cores).
"""

from __future__ import annotations

from typing import Dict

from . import (conv_bn_relu, flash_attention, fused_adam, int8_gemm,
               layer_norm, paged_attention)

# kernel (its csrc/<name>.cu) -> the module that wraps it
MODULES = {"flash_attention_fwd": flash_attention,
           "paged_attention": paged_attention,
           "int8_gemm": int8_gemm,
           "flash_attention_bwd": flash_attention,
           "fused_adamw": fused_adam,
           "layer_norm": layer_norm,
           "conv_bn_relu": conv_bn_relu}
_COUNTER = {"flash_attention_bwd": "bwd_launches"}


def launch_counts() -> Dict[str, int]:
    return {name: int(getattr(mod, _COUNTER.get(name, "launches")))
            for name, mod in MODULES.items()}


def layout_counts() -> Dict[str, Dict[str, int]]:
    """Flash launches by layout: {kernel: {"packed": n, "bnsd": m}}."""
    return {"flash_attention_fwd": dict(flash_attention.launches_by_layout),
            "flash_attention_bwd":
                dict(flash_attention.bwd_launches_by_layout)}


def dtype_counts() -> Dict[str, Dict[str, int]]:
    """Flash launches by instance: {kernel: {"fp32_cuda_cores": n,
    "bf16_wgmma": m}}."""
    return {"flash_attention_fwd": dict(flash_attention.launches_by_dtype),
            "flash_attention_bwd":
                dict(flash_attention.bwd_launches_by_dtype)}


def reset_launch_counts():
    for name, mod in MODULES.items():
        setattr(mod, _COUNTER.get(name, "launches"), 0)
    flash_attention.reset_layout_counts()
