"""The layer-norm kernel against F.layer_norm on the card, on the device
alone and through the host.

    python -m paddle_tpu_torch.tools.profile_layer_norm

At the three shapes chip_smoke.py checks ([20480, 1024] bf16 and fp32,
ERNIE-large's layer-norm rows at s512 b40; [1500, 1024] fp32, the decoder
LM's longest prefill), with an fp32 scale and bias, it times 30
back-to-back calls of the kernel's wrapper (``layer_norm_fwd``) and of
``F.layer_norm`` two ways:

* ``events_ms``: CUDA events around the 30 calls as Python issues them,
  so a call whose device time is below its host time reads its host time;
* ``device_ms``: the same 30 calls captured once in a ``torch.cuda.CUDAGraph``
  and replayed between events, so only the device's time is left (the
  wrapper launches on the current stream, which the capture records).

Inputs are rotated through more than the 50 MB L2, as a training step reads
them cold. Beside them: ``host_us``, the wrapper's host time per call (the
perf_counter over 200 calls issued without a synchronise), and the bound,
each input read and each output written once at 3.35 TB/s. Each shape is
measured twice in the one process.

Prints one JSON line per shape and round, then the card's name and power
limit. Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

CASES = ((20480, 1024, torch.bfloat16), (20480, 1024, torch.float32),
         (1500, 1024, torch.float32))
HBM, CALLS, ROUNDS = 3.35e12, 30, 2


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def events_ms(fn, reps=CALLS):
    """ms per call over ``reps`` calls issued back to back from Python."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=CALLS, replays=5):
    """ms per call on the device alone: ``reps`` calls captured once in a
    CUDA graph, the graph replayed ``replays`` times between events."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm up off the default stream first
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def host_us(fn, reps=200):
    """The host's microseconds per call, issued without a synchronise."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(i)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def measure(dev, rows, h, dtype):
    """One round at one shape: the kernel's and F.layer_norm's times."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import layer_norm as ln

    g = torch.Generator(device=dev).manual_seed(rows + h)
    esz = torch.finfo(dtype).bits // 8
    reps = max(1, -(-(64 << 20) // (rows * h * esz)))
    xs = [(torch.randn(rows, h, device=dev, generator=g) * 2 + 0.5)
          .to(dtype) for _ in range(reps)]
    sc = torch.rand(h, device=dev, generator=g) + 0.5
    bi = torch.randn(h, device=dev, generator=g)
    sc_t, bi_t = sc.to(dtype), bi.to(dtype)

    def kernel(i):
        return ln.layer_norm_fwd(xs[i % reps], sc, bi, 1e-5)

    def library(i):
        return F.layer_norm(xs[i % reps], (h,), sc_t, bi_t, 1e-5)

    nbytes = 2 * rows * h * esz + 2 * h * 4 + 2 * rows * 4
    return dict(
        shape=f"[{rows}, {h}] {'bf16' if dtype == torch.bfloat16 else 'fp32'}",
        kernel_events_ms=events_ms(kernel),
        kernel_device_ms=graph_ms(kernel),
        library_events_ms=events_ms(library),
        library_device_ms=graph_ms(library),
        kernel_host_us=host_us(kernel),
        library_host_us=host_us(library),
        bound_ms=nbytes / HBM * 1e3, bound_by="bytes")


def main():
    if not torch.cuda.is_available():
        print("profile_layer_norm: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    for rnd in range(ROUNDS):
        for rows, h, dtype in CASES:
            print(json.dumps(dict(round=rnd, **measure(dev, rows, h, dtype))),
                  flush=True)
            torch.cuda.empty_cache()
    print(smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
