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
  step's slot positions as the engine fed them;
* the chunked prefill of the prefix cache (``prefix``): a hit prefill of
  a 1024-token shared prompt plus a 150-token suffix (10 chunks of 16
  tokens) at chip_smoke's prefix configuration. First the chunk loop
  alone, before the engine's thread starts, two ways over the same
  feeds, interleaved (per-chunk, per-chunk, stacked, stacked, per-chunk):
  ``per_chunk`` copies each chunk's host feeds and reads its logits back
  (a host round trip a chunk), ``stacked`` is the engine's
  ``_run_chunks`` (the feeds sent once, only the last chunk's logits
  read); wall ms a chunk over 5 prefills each, then ``stacked`` traced
  over 3 prefills: traced wall and device busy ms a chunk, kernels a
  chunk and the top kernels. Then through the started engine (one new
  token, so no decode step runs): one cold prefill, then hits of fresh
  suffixes, 3 untraced and 2 traced: each hit's wall ms (the request's
  ``prefill_ms``), and over the traced ones the device busy ms.

The idle share is printed as computed, unclamped: wall and busy come from
the same traced runs, so busy > wall would be a fault of the measurement.
The traced wall includes the profiler's own host cost; the untraced wall
beside it shows how much that is.

Prints three JSON lines per weight format (the step and prefill,
``serve``, ``prefix``), then the card's name and power limit;
``--parts`` picks a subset of ``engine,serve,prefix``. Needs one CUDA
card; exits non-zero without one.
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

FULL = dict(vocab_size=32000, d_model=1024, n_head=16, n_layers=12,
            d_inner=4096, max_seq_len=2048)
STEPS = 20      # untraced decode steps timed, and op-by-op passes
# chip_smoke.py's serve phases: eight greedy prompts and one sampled one
SERVE_PROMPTS = (5, 37, 100, 250, 480, 700, 1100, 1500)
# the prefix profile: chip_smoke's shared system prompt, a hit's suffix
PREFIX_SYSTEM, PREFIX_SUFFIX = 1024, 150


def _traced(run, reps, kernel_calls=None):
    """(wall ms per run, device busy ms per run, top kernels, the paged
    attention kernel's ms and calls per run) over the same reps runs,
    traced by torch.profiler; ``kernel_calls`` (a list) receives the
    device events per run."""
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
    if kernel_calls is not None:
        kernel_calls.append(sum(r[2] for r in rows))
    top = [{"kernel": k[:80], "ms": ms, "calls": c} for k, ms, c in rows[:8]]
    paged = [r for r in rows if "paged_attention" in r[0]]
    return wall, sum(r[1] for r in rows), top, {
        "ms": sum(r[1] for r in paged), "calls": sum(r[2] for r in paged)}


def _engine(quant, cfg, params, prefix_cache=False):
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    eng = DecodeEngine(cfg, params, DecodeConfig(
        max_slots=8, page_size=16, kv_pages=1024, weight_quant=quant,
        max_new_tokens=32, prefix_cache=prefix_cache), device="cuda:0")
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

    def recording(phase, bucket, feed, fetch=True):
        if phase == "step":
            positions.append(feed["positions"].tolist())
        return run(phase, bucket, feed, fetch)

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


def prefix(quant, cfg, params):
    """The chunked prefill of a prefix hit: the chunk loop alone, per
    chunk against stacked feeds, then hits through the started engine
    (see the module docstring)."""
    eng = _engine(quant, cfg, params, prefix_cache=True)
    P = eng.config.page_size
    rng = np.random.RandomState(5)
    system = rng.randint(3, cfg.vocab_size, PREFIX_SYSTEM)

    def prompt():
        return np.concatenate([system, rng.randint(
            3, cfg.vocab_size, PREFIX_SUFFIX)]).astype(np.int32)

    seq = prompt()
    first = PREFIX_SYSTEM // P
    row = np.zeros(eng._mp, np.int32)
    row[:-(-seq.size // P)] = 1 + np.arange(-(-seq.size // P))
    feeds = eng._chunk_feeds(seq, row, first)
    chunks = len(feeds["tokens"])

    def per_chunk():
        for ci in range(chunks):
            eng._run("chunk", P, {n: v[ci] for n, v in feeds.items()})

    def stacked():
        eng._run_chunks(feeds)

    def wall_ms(run, reps=5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps / chunks * 1e3

    per_chunk(), stacked()
    walls = {"per_chunk": [], "stacked": []}
    for way in ("per_chunk", "per_chunk", "stacked", "stacked",
                "per_chunk"):
        walls[way].append(wall_ms(per_chunk if way == "per_chunk"
                                  else stacked))
    calls = []
    t_wall, t_busy, top, _ = _traced(stacked, 3, calls)

    hits, traced_hits = [], []
    eng.start()
    try:
        cold = eng.submit(prompt(), max_new_tokens=1)
        cold.result(timeout=600)
        for _ in range(3):
            h = eng.submit(prompt(), max_new_tokens=1)
            h.result(timeout=600)
            hits.append(h.prefill_ms)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                h = eng.submit(prompt(), max_new_tokens=1)
                h.result(timeout=600)
                traced_hits.append(h.prefill_ms)
            torch.cuda.synchronize()
        hit_busy = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type != DeviceType.CPU) / 2 / 1e3
        stats = eng.stats()
    finally:
        eng.close(drain=True, timeout=60)
    return {"weights": quant, "system": PREFIX_SYSTEM,
            "suffix": PREFIX_SUFFIX, "chunks": chunks,
            "chunk_wall_ms": walls,
            "stacked_traced": {
                "wall_ms_per_chunk": t_wall / chunks,
                "device_busy_ms_per_chunk": t_busy / chunks,
                "device_idle_share": 1.0 - t_busy / t_wall,
                "kernels_per_chunk": calls[0] / chunks,
                "top_kernels": top},
            "engine": {"cold_prefill_ms": cold.prefill_ms,
                       "hit_prefill_ms": hits,
                       "traced_hit_prefill_ms": traced_hits,
                       "traced_hit_device_busy_ms": hit_busy,
                       "prefix_hits": stats["prefix_store"].get(
                           "prefix_hits")}}


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", default="engine,serve,prefix",
                    help="comma-separated subset of engine,serve,prefix")
    parts = set(ap.parse_args(argv).parts.split(","))
    if not parts <= {"engine", "serve", "prefix"}:
        ap.error(f"unknown parts {sorted(parts)}")
    if not torch.cuda.is_available():
        print("profile_decode: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from paddle_tpu_torch.models.decoder_lm import (DecoderLMConfig,
                                                    decoder_lm_params)

    cfg = DecoderLMConfig(**FULL)
    params = decoder_lm_params(cfg, seed=0)
    for quant in ("none", "int8"):
        if "engine" in parts:
            print(json.dumps(profile_engine(quant, cfg, params)),
                  flush=True)
        if "serve" in parts:
            print(json.dumps({"serve": serve(quant, cfg, params)}),
                  flush=True)
        if "prefix" in parts:
            print(json.dumps({"prefix": prefix(quant, cfg, params)}),
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
