"""Where the ERNIE-large training step's time goes on the card.

    python -m paddle_tpu_torch.tools.profile_train [--seq 512|2048|4096]

Builds the pre-training program the reference's benchmark trains (ERNIE
large: 24 layers, hidden 1024, 16 heads of 64, FFN 4096, vocab 18000, bf16
params, packed flash attention with probs dropout 0.1, hidden dropout 0.1,
NSP, AdamW) at one of its three cells: seq 512 batch 40 with 80 masked
predictions (the default), or the long-context rows, seq 2048 batch 4 and
seq 4096 batch 2 with max(80, seq * 15 // 100) and the position table
widened to the sequence. It runs the startup on cuda:0 and measures on one
synthetic batch:

* the step's host wall ms over 5 steps without the profiler (each ending
  in a synchronise), and the peak device memory;
* over 2 steps traced by torch.profiler: the wall ms per step, the device
  busy ms per step (the sum of kernel and copy times in the trace), the
  device idle share 1 - busy / wall of those same traced steps, and the
  top kernels by device time;
* ms by op type over one step with a synchronise after every op (host
  launch plus device time of that op; the sum exceeds the step's wall by
  the overlap lost), ``__vjp_grad__`` split by the forward type it
  differentiates;
* host ms by op type over one unsynchronised step at batch 1, where the
  card is never the bottleneck: what the interpreter and PyTorch's
  dispatch cost per op.

The idle share is printed as computed, unclamped. The traced wall
includes the profiler's own host cost; the untraced wall beside it shows
how much that is.

Prints one JSON line, then the card's name and power limit. Needs one
CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ERNIE = dict(vocab_size=18000, hidden_size=1024, num_attention_heads=16,
             intermediate_size=4096)
LAYERS = 24
# seq -> (batch, masked predictions): tools/bench_models.py bench_ernie and
# bench_long_context
CELLS = {512: (40, 80), 2048: (4, 307), 4096: (2, 614)}


def _traced(run, reps, top_n=14):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps * 1e3
    rows = [(e.key, e.self_device_time_total / reps / 1e3, e.count / reps)
            for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.self_device_time_total]
    rows.sort(key=lambda r: -r[1])
    top = [{"kernel": k[:70], "ms": ms, "calls": c}
           for k, ms, c in rows[:top_n]]
    return wall, sum(r[1] for r in rows), top


def _op_label(op):
    if op.type == "__vjp_grad__":
        return f"__vjp_grad__[{op.attrs['fwd_type']}]"
    return op.type


def _ms_by_op(executor_mod, run, sync):
    """One step with every op timed on the host clock; with ``sync`` the
    clock stops only when the op's device work has ended."""
    ms = defaultdict(float)
    calls = defaultdict(int)
    inner = executor_mod.run_op

    def timed(op, env, step=None):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(op, env, step=step)
        if sync:
            torch.cuda.synchronize()
        label = _op_label(op)
        ms[label] += (time.perf_counter() - t0) * 1e3
        calls[label] += 1
        return out

    executor_mod.run_op = timed
    try:
        run()
    finally:
        executor_mod.run_op = inner
    torch.cuda.synchronize()
    order = sorted(ms, key=lambda k: -ms[k])
    return {k: {"ms": ms[k], "calls": calls[k]} for k in order}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seq", type=int, choices=sorted(CELLS),
                        default=512)
    seq = parser.parse_args(argv).seq
    batch_size, preds = CELLS[seq]
    if not torch.cuda.is_available():
        print("profile_train: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig(num_hidden_layers=LAYERS, dtype="bfloat16",
                          use_flash_attention=True,
                          max_position_embeddings=max(512, seq), **ERNIE)
    with unique_name.guard():
        main_prog, startup, _, fetches = bert.build_pretraining_program(
            cfg, seq_len=seq, optimizer_name="adamw",
            max_predictions_per_seq=preds)
    exe = executor_mod.Executor(device="cuda:0")
    scope = Scope()
    exe.run(startup, scope=scope)

    def stepper(b):
        batch = bert.synthetic_pretraining_batch(
            cfg, b, seq, seed=0, max_predictions_per_seq=preds)
        feed = {k: torch.from_numpy(v).to("cuda:0") for k, v in batch.items()}
        return lambda: exe.run(main_prog, feed=feed, scope=scope,
                               fetch_list=[fetches["loss"]])

    step = stepper(batch_size)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = {k: v / 5 for k, v in kernels.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated()
    traced_wall, busy, top = _traced(step, 2)
    by_op_sync = _ms_by_op(executor_mod, step, sync=True)
    small = stepper(1)
    small()
    by_op_host = _ms_by_op(executor_mod, small, sync=False)
    ops = main_prog.global_block().ops
    print(json.dumps({
        "model": "ernie_large", "layers": LAYERS, "batch": batch_size,
        "seq": seq, "dtype": "bfloat16", "ops": len(ops),
        "wall_ms": walls, "wall_ms_p50": float(np.median(walls)),
        "tokens_per_s": batch_size * seq / (float(np.median(walls)) / 1e3),
        "max_memory_allocated": peak, "kernel_launches_per_step": launches,
        "traced_wall_ms": traced_wall, "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy / traced_wall, "top_kernels": top,
        "synchronised_ms_by_op": by_op_sync,
        "synchronised_ms_total": sum(v["ms"] for v in by_op_sync.values()),
        "host_ms_by_op_at_batch_1": by_op_host,
        "host_ms_total_at_batch_1": sum(v["ms"]
                                        for v in by_op_host.values())}),
        flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
