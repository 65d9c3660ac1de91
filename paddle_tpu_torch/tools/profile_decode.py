"""Where the decode engine's time goes on the card.

    python -m paddle_tpu_torch.tools.profile_decode

Builds the decoder LM at the README's full width (vocab 32000, d_model
1024, 12 layers, 16 heads, d_inner 4096, max_seq_len 2048; random weights
from seed 0) in a DecodeEngine on cuda:0, once per weight format (fp32,
int8), and measures, the first two without starting the engine's
thread:

* a decode step at 8 busy slots, each at position 512: host wall ms per
  step (ending in the host copy of the logits, as the engine does) over
  20 steps without the profiler; then, over 5 steps traced by
  torch.profiler, the wall ms per step and the device busy ms per step
  (the sum of kernel and copy times in the trace), and the device idle
  share 1 - busy / wall of those same traced steps; the top kernels by
  device time, the paged-attention kernel's device ms and calls a step
  and its share of the busy time, and the host ms each op type spends
  launching its work (no synchronisation);
* a prefill of a 1500-token prompt (bucket 2048): the same wall, traced
  wall, busy and idle figures over 3 and 2 prefills;
* the serving traffic of ``chip_smoke.py``'s serve phases (``serve``):
  eight prompts of 5 to 1500 tokens and one of 300, 32 new tokens each,
  submitted at once to the started engine, traced by torch.profiler
  from the first submission to the last result: the decode steps, the
  paged-attention kernel's device ms and calls, its ms a step, and each
  step's slot positions as the engine fed them.

The idle share is printed as computed, unclamped: wall and busy come from
the same traced runs, so busy > wall would be a fault of the measurement.
The traced wall includes the profiler's own host cost; the untraced wall
beside it shows how much that is.

Prints two JSON lines per weight format (the step and prefill, then
``serve``), then the card's name and power limit. Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

FULL = dict(vocab_size=32000, d_model=1024, n_head=16, n_layers=12,
            d_inner=4096, max_seq_len=2048)
STEPS = 20      # untraced decode steps timed, and op-by-op passes
# chip_smoke.py's serve phases: eight greedy prompts and one sampled one
SERVE_PROMPTS = (5, 37, 100, 250, 480, 700, 1100, 1500)


def _traced(run, reps):
    """(wall ms per run, device busy ms per run, top kernels, the paged
    attention kernel's ms and calls per run) over the same reps runs,
    traced by torch.profiler."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps * 1e3
    # device-side rows only: the CPU op that launched a kernel carries
    # the same device time again
    rows = [(e.key, e.self_device_time_total / reps / 1e3, e.count / reps)
            for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.self_device_time_total]
    rows.sort(key=lambda r: -r[1])
    top = [{"kernel": k[:80], "ms": ms, "calls": c} for k, ms, c in rows[:8]]
    paged = [r for r in rows if "paged_attention" in r[0]]
    return wall, sum(r[1] for r in rows), top, {
        "ms": sum(r[1] for r in paged), "calls": sum(r[2] for r in paged)}


def _engine(quant, cfg, params):
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    eng = DecodeEngine(cfg, params, DecodeConfig(
        max_slots=8, page_size=16, kv_pages=1024, weight_quant=quant,
        max_new_tokens=32), device="cuda:0")
    eng.warmup()
    return eng


def serve(quant, cfg, params):
    """The serve phases' requests through a started engine, traced:
    steps, the paged kernel's device ms and calls in all and a step, and
    each step's slot positions (padding slots at 0)."""
    eng = _engine(quant, cfg, params)
    rng = np.random.RandomState(3)
    reqs = [dict(prompt=rng.randint(3, cfg.vocab_size, n).astype(np.int32),
                 max_new_tokens=32, stop_at_eos=False)
            for n in SERVE_PROMPTS]
    reqs.append(dict(prompt=rng.randint(3, cfg.vocab_size, 300)
                     .astype(np.int32), max_new_tokens=32, temperature=0.8,
                     seed=7, stop_at_eos=False))
    positions = []
    run = eng._run

    def recording(phase, bucket, feed):
        if phase == "step":
            positions.append(feed["positions"].tolist())
        return run(phase, bucket, feed)

    eng._run = recording
    eng.start()
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for h in [eng.submit(**r) for r in reqs]:
                h.result(timeout=600)
            torch.cuda.synchronize()
    finally:
        eng.close(drain=True, timeout=60)
    paged = [e for e in prof.key_averages()
             if e.device_type != DeviceType.CPU and e.self_device_time_total
             and "paged_attention" in e.key]
    ms = sum(e.self_device_time_total for e in paged) / 1e3
    steps = len(positions)
    return {"weights": quant, "requests": len(reqs), "steps": steps,
            "paged_ms": ms, "paged_calls": sum(e.count for e in paged),
            "paged_ms_per_step": ms / steps, "positions": positions}


def profile_engine(quant, cfg, params):
    from paddle_tpu_torch.core.executor import run_op

    eng = _engine(quant, cfg, params)
    rng = np.random.RandomState(0)
    mp = cfg.max_seq_len // 16
    table = np.zeros((8, mp), np.int32)
    for i in range(8):
        table[i, :33] = 1 + 33 * i + np.arange(33)
    step_feed = {"tokens": rng.randint(3, cfg.vocab_size, 8).astype(np.int32),
                 "positions": np.full(8, 512, np.int32),
                 "page_table": table}

    def step():
        return eng._run("step", 8, step_feed)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step()
    wall = (time.perf_counter() - t0) / STEPS * 1e3
    traced_wall, busy, top, paged = _traced(step, 5)

    # host time each op type spends launching its work
    env = dict(eng._params)
    env.update(eng._pools)
    env.update({n: torch.from_numpy(v).to(eng.device)
                for n, v in step_feed.items()})
    op_ms = defaultdict(float)
    block = eng._block("step", 8)
    torch.cuda.synchronize()
    for _ in range(STEPS):
        for op in block.ops:
            t0 = time.perf_counter()
            run_op(op, env)
            op_ms[op.type] += (time.perf_counter() - t0) * 1e3 / STEPS
        torch.cuda.synchronize()

    L = 1500
    oh = np.zeros((1, 2048), np.float32)
    oh[0, L - 1] = 1.0
    ptable = np.zeros((1, mp), np.int32)
    ptable[0, :96] = np.arange(300, 396)
    tokens = np.zeros((1, 2048), np.int32)
    tokens[0, :L] = rng.randint(3, cfg.vocab_size, L)
    pre_feed = {"tokens": tokens, "lengths": np.array([L], np.int32),
                "last_onehot": oh, "page_table": ptable}

    def prefill():
        return eng._run("prefill", 2048, pre_feed)

    prefill()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        prefill()
    pre_wall = (time.perf_counter() - t0) / 3 * 1e3
    pre_traced, pre_busy, pre_top, _ = _traced(prefill, 2)
    return {"weights": quant, "step": {
        "slots": 8, "position": 512, "wall_ms": wall,
        "traced_wall_ms": traced_wall, "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy / traced_wall,
        "top_kernels": top, "paged_attention_device": paged,
        "paged_share_of_busy": paged["ms"] / busy,
        "host_launch_ms_by_op": dict(sorted(op_ms.items(),
                                            key=lambda kv: -kv[1]))},
        "prefill": {"prompt": L, "bucket": 2048, "wall_ms": pre_wall,
                    "traced_wall_ms": pre_traced,
                    "device_busy_ms": pre_busy,
                    "device_idle_share": 1.0 - pre_busy / pre_traced,
                    "top_kernels": pre_top}}


def main():
    if not torch.cuda.is_available():
        print("profile_decode: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from paddle_tpu_torch.models.decoder_lm import (DecoderLMConfig,
                                                    decoder_lm_params)

    cfg = DecoderLMConfig(**FULL)
    params = decoder_lm_params(cfg, seed=0)
    for quant in ("none", "int8"):
        print(json.dumps(profile_engine(quant, cfg, params)),
              flush=True)
        print(json.dumps({"serve": serve(quant, cfg, params)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
