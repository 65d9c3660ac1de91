"""What sets the pace of the bf16 flash kernels on the card.

    python -m paddle_tpu_torch.tools.profile_flash

At the three packed training shapes of ERNIE-large (16 heads of 64, key
bias with 10 % of keys masked: B=40 S=512, B=4 S=2048, B=2 S=4096) it
times, with CUDA events over back-to-back calls, the forward and the
backward with attention dropout 0.1 (the training call) and without it,
and splits the backward into its kernels (delta, the dkv and dq passes,
dbias) with torch.profiler. Beside the times it prints three floors, all
computed from the shapes: the tensor cores' (the products' flops at 989
TFLOP/s dense bf16: 2 products forward, 5 backward, 7 as the two passes
compute them), the exps' (one exp2 a score per pass at 16 a clock per SM
on 132 SMs at the card's maximum SM clock), and device memory's (each
input read and each output written once at 3.35 TB/s). Dropout adds one
splitmix32 hash a score per pass; the difference between the two timed
calls is what it costs.

Prints one JSON line per shape, then the card's name and power limit.
Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

SHAPES = ((40, 512), (4, 2048), (2, 4096))
N, HD, RATE, SEED = 16, 64, 0.1, 20261016
TC_FLOPS, HBM, SMS, EXP_PER_CLOCK = 989e12, 3.35e12, 132, 16


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def events_ms(fn, reps=10):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps=5):
    """Device ms per call of fn by kernel name, from torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = ev.cuda_time_total
        if t > 0:
            name = ev.key.replace("(anonymous namespace)::", "")
            name = name.replace("void ", "").split("<")[0].split("(")[0]
            name = name.strip().split("::")[-1] or ev.key
            out[name] = out.get(name, 0.0) + t / 1e3 / reps
    return out


def main():
    if not torch.cuda.is_available():
        print("profile_flash: needs a CUDA card", file=sys.stderr)
        return 2
    from paddle_tpu_torch.kernels import flash_attention as fa

    dev = torch.device("cuda:0")
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    for b, s in SHAPES:
        g = torch.Generator(device=dev).manual_seed(s)
        q, k, v, do = (torch.randn(b, s, N * HD, device=dev, generator=g)
                       .bfloat16() for _ in range(4))
        bias = torch.where(torch.rand(b, s, device=dev, generator=g) < 0.1,
                           -1e4, 0.0)
        scale = HD ** -0.5

        def fwd(rate):
            return fa.flash_fwd(q, k, v, N, scale, False, bias, rate, SEED)

        out, lse = fwd(RATE)

        def bwd(rate):
            return fa.flash_bwd(q, k, v, out, lse, do, N, scale, False, bias,
                                rate, SEED)

        scores = b * N * s * s
        product_ms = 2 * scores * HD / TC_FLOPS * 1e3
        exp_ms = scores / (EXP_PER_CLOCK * SMS * clock_hz) * 1e3
        io = q.numel() * 2
        print(json.dumps(dict(
            shape=f"B={b} S={s} n={N} hd={HD} bias bf16",
            forward=dict(
                ms_dropout=events_ms(lambda: fwd(RATE)),
                ms_no_dropout=events_ms(lambda: fwd(0.0)),
                tensor_core_floor_ms=2 * product_ms, exp_floor_ms=exp_ms,
                memory_floor_ms=(4 * io + bias.numel() * 4 +
                                 lse.numel() * 4) / HBM * 1e3),
            backward=dict(
                ms_dropout=events_ms(lambda: bwd(RATE)),
                ms_no_dropout=events_ms(lambda: bwd(0.0)),
                kernels_ms_dropout=kernel_ms(lambda: bwd(RATE)),
                tensor_core_floor_ms=5 * product_ms,
                tensor_core_floor_as_computed_ms=7 * product_ms,
                exp_floor_ms=2 * exp_ms,
                memory_floor_ms=(8 * io + lse.numel() * 4 +
                                 2 * bias.numel() * 4) / HBM * 1e3),
            max_sm_clock_mhz=clock_hz / 1e6)), flush=True)
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    print(smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
