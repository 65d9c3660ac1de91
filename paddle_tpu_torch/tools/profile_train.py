"""Where a training step's time goes on the card.

    python -m paddle_tpu_torch.tools.profile_train [--seq 512|2048|4096]
    python -m paddle_tpu_torch.tools.profile_train --model resnet50

``--model ernie_large`` (the default) builds the pre-training program the
reference's benchmark trains (ERNIE large: 24 layers, hidden 1024, 16
heads of 64, FFN 4096, vocab 18000, bf16 params, packed flash attention
with probs dropout 0.1, hidden dropout 0.1, NSP, AdamW) at one of its
three cells: seq 512 batch 40 with 80 masked predictions (the default),
or the long-context rows, seq 2048 batch 4 and seq 4096 batch 2 with
max(80, seq * 15 // 100) and the position table widened to the sequence.
``--model resnet50`` builds the reference benchmark's ResNet-50 row
(``tools/bench_models.py:157``: 224x224 images, batch 256, bf16 AMP,
Momentum lr 0.1, fuse_bn_act_pass). It runs the startup on cuda:0 and
measures on one synthetic batch:

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
  dispatch cost per op;
* the traced device time by kernel class (convolutions, GEMMs,
  reductions, elementwise, copies, the port's flash-attention kernels and
  its other kernels), read from the kernels' names.

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
RESNET_BATCH = 256      # tools/bench_models.py bench_resnet50
# kernel class -> name fragments, first match wins (the port's kernels by
# their csrc names)
CLASSES = (("port flash attention", ("flash_", "dkv_", "dq_tc", "dq_kernel",
                                     "delta_kernel", "dbias_kernel")),
           ("port kernels", ("adamw", "ln_kernel", "conv_bn_relu", "paged",
                             "int8")),
           ("convolution (cuDNN)", ("conv", "cudnn", "xmma", "implicit",
                                    "wgrad", "dgrad", "fprop", "winograd")),
           ("gemm", ("gemm", "cutlass", "cublas")),
           ("reduction", ("reduce", "norm", "softmax")),
           ("copy", ("copy", "memcpy", "memset", "cat", "transpose")),
           ("elementwise", ("elementwise", "vectorized", "unrolled",
                            "where", "fill")))


def _kernel_class(name):
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


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
    by_class = defaultdict(float)
    for k, ms, _ in rows:
        by_class[_kernel_class(k)] += ms
    return wall, sum(r[1] for r in rows), top, dict(by_class)


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


def _ernie(seq):
    """(program, startup, stepper(batch), model fields) of the ERNIE cell
    at ``seq``."""
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.models import bert

    batch_size, preds = CELLS[seq]
    cfg = bert.BertConfig(num_hidden_layers=LAYERS, dtype="bfloat16",
                          use_flash_attention=True,
                          max_position_embeddings=max(512, seq), **ERNIE)
    with unique_name.guard():
        main_prog, startup, _, fetches = bert.build_pretraining_program(
            cfg, seq_len=seq, optimizer_name="adamw",
            max_predictions_per_seq=preds)

    def batch(b):
        return bert.synthetic_pretraining_batch(
            cfg, b, seq, seed=0, max_predictions_per_seq=preds)

    info = {"model": "ernie_large", "layers": LAYERS, "batch": batch_size,
            "seq": seq, "dtype": "bfloat16"}
    return main_prog, startup, batch, [fetches["loss"]], info, \
        batch_size * seq


def _resnet50():
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.models import resnet

    cfg = resnet.resnet50()
    with unique_name.guard():
        main_prog, startup, _, fetches = resnet.build_classifier_program(
            cfg, batch_size=RESNET_BATCH, amp=True)

    def batch(b):
        return resnet.synthetic_batch(cfg, b, seed=0)

    info = {"model": "resnet50", "batch": RESNET_BATCH,
            "image": list(cfg.image_shape), "dtype": "bf16 AMP"}
    return main_prog, startup, batch, [fetches["loss"], fetches["acc1"]], \
        info, RESNET_BATCH


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", choices=("ernie_large", "resnet50"),
                        default="ernie_large")
    parser.add_argument("--seq", type=int, choices=sorted(CELLS),
                        default=512)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope

    if args.model == "resnet50":
        main_prog, startup, make_batch, fetch, info, per_step = _resnet50()
        rate_name = "images_per_s"
    else:
        main_prog, startup, make_batch, fetch, info, per_step = \
            _ernie(args.seq)
        rate_name = "tokens_per_s"
    batch_size = info["batch"]
    exe = executor_mod.Executor(device="cuda:0")
    scope = Scope()
    exe.run(startup, scope=scope)

    def stepper(b):
        feed = {k: torch.from_numpy(v).to("cuda:0")
                for k, v in make_batch(b).items()}
        return lambda: exe.run(main_prog, feed=feed, scope=scope,
                               fetch_list=fetch)

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
    traced_wall, busy, top, by_class = _traced(step, 2)
    by_op_sync = _ms_by_op(executor_mod, step, sync=True)
    small = stepper(1)
    small()
    by_op_host = _ms_by_op(executor_mod, small, sync=False)
    ops = main_prog.global_block().ops
    p50 = float(np.median(walls))
    print(json.dumps({
        **info, "ops": len(ops),
        "wall_ms": walls, "wall_ms_p50": p50,
        rate_name: per_step / (p50 / 1e3),
        "max_memory_allocated": peak, "kernel_launches_per_step": launches,
        "traced_wall_ms": traced_wall, "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy / traced_wall, "top_kernels": top,
        "device_ms_by_kernel_class": by_class,
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
