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
tensor cores in split TF32); the int8 GEMM splits its count by the
instance its M chose (``int8_instance_counts``: prefill, M > 16; decode,
M <= 16).

A launch captured into a CUDA graph runs only when the graph replays:
the code that captures and replays graphs (``core/graph.py``) takes the
capture's counts back out (``snapshot_counts`` before and after,
``add_counts``) and adds them on every replay, so a replayed step counts
what the op-by-op step counts.
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
# the snapshot key of the flash op's general-route calls
GENERAL = "flash_general_route"


def launch_counts() -> Dict[str, int]:
    return {name: int(getattr(mod, _COUNTER.get(name, "launches")))
            for name, mod in MODULES.items()}


def layout_counts() -> Dict[str, Dict[str, int]]:
    """Flash launches by layout: {kernel: {"packed": n, "bnsd": m}}."""
    return {"flash_attention_fwd": dict(flash_attention.launches_by_layout),
            "flash_attention_bwd":
                dict(flash_attention.bwd_launches_by_layout)}


def dtype_counts() -> Dict[str, Dict[str, int]]:
    """Flash launches by instance: {kernel: {"fp32_tf32x3": n,
    "bf16_wgmma": m}}."""
    return {"flash_attention_fwd": dict(flash_attention.launches_by_dtype),
            "flash_attention_bwd":
                dict(flash_attention.bwd_launches_by_dtype)}


def int8_instance_counts() -> Dict[str, int]:
    """int8 GEMM launches by instance: {"prefill": n, "decode": m}."""
    return dict(int8_gemm.launches_by_instance)


# the dict-valued launch splits, by the module that keeps them
_SPLITS = {"launches_by_layout": flash_attention,
           "bwd_launches_by_layout": flash_attention,
           "launches_by_dtype": flash_attention,
           "bwd_launches_by_dtype": flash_attention,
           "launches_by_instance": int8_gemm}


def general_route_calls() -> int:
    """Calls of the flash op's reference_general route (plain PyTorch,
    no kernel): its count beside the launch counters."""
    return flash_attention.general_calls


def snapshot_counts() -> Dict:
    """Every launch counter, totals (by kernel name) and splits (by
    (split, key)), and the general route's calls (``GENERAL``), in one
    flat dict."""
    snap: Dict = dict(launch_counts())
    for attr, mod in _SPLITS.items():
        for key, n in getattr(mod, attr).items():
            snap[(attr, key)] = n
    snap[GENERAL] = flash_attention.general_calls
    return snap


def count_delta(before: Dict, after: Dict) -> Dict:
    """The launches between two snapshots, counters that moved only."""
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def add_counts(delta: Dict):
    """Add a ``count_delta`` to the counters: the launches of a replayed
    CUDA graph, which no wrapper sees."""
    for k, n in delta.items():
        if k == GENERAL:
            flash_attention.general_calls += n
        elif isinstance(k, tuple):
            getattr(_SPLITS[k[0]], k[0])[k[1]] += n
        else:
            attr = _COUNTER.get(k, "launches")
            setattr(MODULES[k], attr, getattr(MODULES[k], attr) + n)


def reset_launch_counts():
    for name, mod in MODULES.items():
        setattr(mod, _COUNTER.get(name, "launches"), 0)
    flash_attention.general_calls = 0
    flash_attention.reset_layout_counts()
    int8_gemm.reset_instance_counts()
