"""Where a training step's time goes on the card.

    python -m paddle_tpu_torch.tools.profile_train [--seq 512|2048|4096]
    python -m paddle_tpu_torch.tools.profile_train --model resnet50
    python -m paddle_tpu_torch.tools.profile_train --model transformer_big

``--model ernie_large`` (the default) builds the pre-training program the
reference's benchmark trains (ERNIE large: 24 layers, hidden 1024, 16
heads of 64, FFN 4096, vocab 18000, bf16 params, packed flash attention
with probs dropout 0.1, hidden dropout 0.1, NSP, AdamW) at one of its
three cells: seq 512 batch 40 with 80 masked predictions (the default),
or the long-context rows, seq 2048 batch 4 and seq 4096 batch 2 with
max(80, seq * 15 // 100) and the position table widened to the sequence.
``--model resnet50`` builds the reference benchmark's ResNet-50 row
(``tools/bench_models.py:157``: 224x224 images, batch 256, bf16 AMP,
Momentum lr 0.1, fuse_bn_act_pass). ``--model transformer_big`` builds
the reference benchmark's Transformer-big row (``tools/bench_models.py:243``:
WMT14 En-De, d_model 1024, 16 heads, d_inner 4096, 6+6 layers, vocab
32000 shared, label smoothing 0.1, dropout 0.1, b48 s256, bf16 AMP, Adam
under noam decay with its published warm-up of 4000 steps); its line
adds, for each mode, the model flops of a step counted with
``bench_transformer_big``'s formula and their share of 989 TFLOP/s (the
H100 SXM's dense bf16 rate) at the step's p50. It runs the startup on
cuda:0 and
measures on one synthetic batch, through ``timed_modes``, for the
op-by-op step (``use_compiled=False``) and for the compiled step (a CUDA
graph replay, ``Executor.run``'s default), each under ``eager`` and
``compiled`` and each from the same state:

* the step's host wall ms over 5 steps without the profiler (each ending
  in a synchronise); the peak device memory allocated over the second
  step (compiled: the capture) and those 5, and the memory the caching
  allocator holds after them (compiled: with the graph's pool);
* over 2 steps traced by torch.profiler: the wall ms per step, the device
  busy ms per step (the sum of kernel and copy times in the trace), the
  device idle share 1 - busy / wall of those same traced steps, the top
  kernels by device time and by kernel class, and the launches of the
  port's flash and AdamW kernels found in the trace by name;

and, op by op (a graph replay dispatches no op from the host):
* ms by op type over one step with a synchronise after every op (host
  launch plus device time of that op; the sum exceeds the step's wall by
  the overlap lost), ``__vjp_grad__`` split by the forward type it
  differentiates;
* host ms by op type over one unsynchronised step at batch 1, where the
  card is never the bottleneck: what the interpreter and PyTorch's
  dispatch cost per op.

Kernel classes (convolutions, GEMMs, reductions, elementwise, copies, the
port's flash-attention kernels and its other kernels) are read from the
kernels' names.

The idle share is printed as computed, unclamped. The traced wall
includes the profiler's own host cost; the untraced wall beside it shows
how much that is.

Prints one JSON line, then the card's name and power limit. Needs one
CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

ERNIE = dict(vocab_size=18000, hidden_size=1024, num_attention_heads=16,
             intermediate_size=4096)
LAYERS = 24
# seq -> (batch, masked predictions): tools/bench_models.py bench_ernie and
# bench_long_context
CELLS = {512: (40, 80), 2048: (4, 307), 4096: (2, 614)}
RESNET_BATCH = 256      # tools/bench_models.py bench_resnet50
WMT_BATCH, WMT_SEQ = 48, 256    # tools/bench_models.py bench_transformer_big
BF16_FLOPS_PER_S = 989e12       # H100 SXM data sheet, dense tensor cores
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


# the one device kernel (csrc name) that each counted launch of a port
# wrapper runs, by launch counter: a trace's count of it is the count of
# that wrapper's launches that really ran, captured or not
MARKERS = {"flash_attention_fwd": ("flash_fwd_tc<", "flash_fwd_tf32<"),
           "flash_attention_bwd": ("dq_tc<", "dq_tf32<"),
           "fused_adamw": ("adamw_kernel<",)}


def traced(run, reps, top_n=14):
    """Over ``reps`` runs traced by torch.profiler, a run's wall ms,
    device busy ms (kernels and copies), idle share 1 - busy / wall, top
    kernels, device ms by kernel class, int32 fill kernels (ms and
    count: a captured paged-attention or AdamW launch zeroes its own
    ticket in the graph with such a fill, ``torch.zeros`` of one int32)
    and the launches of each MARKERS counter seen in the trace.

    The profiler takes a warm-up step first (traced and discarded: a few
    small kernels, not a run, so the launch counters see only the
    counted runs), so the runs start with the device tracing already
    recording: two of five full chip_smoke runs without it lost the
    device record of one of the 18 flash forwards of Transformer-big's
    op-by-op step, whose launch counter and device busy time show it
    ran."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=reps,
                                   repeat=1)) as prof:
        warm = torch.zeros(1024, device="cuda")
        for _ in range(64):
            warm.add_(1.0)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for i in range(reps):
            run()
            if i == reps - 1:
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / reps * 1e3
            prof.step()
    # the schedule's step annotation has a device-side span over the
    # whole step: not a kernel
    rows = [(e.key, e.self_device_time_total / reps / 1e3, e.count / reps)
            for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.self_device_time_total
            and not e.key.startswith("ProfilerStep")]
    rows.sort(key=lambda r: -r[1])
    by_class = defaultdict(float)
    for k, ms, _ in rows:
        by_class[_kernel_class(k)] += ms
    fills = [r for r in rows if "FillFunctor<int>" in r[0]]
    busy = sum(r[1] for r in rows)
    return {"traced_wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall,
            "top_kernels": [{"kernel": k[:70], "ms": ms, "calls": c}
                            for k, ms, c in rows[:top_n]],
            "device_ms_by_kernel_class": dict(by_class),
            "int32_fills": {"ms": sum(r[1] for r in fills),
                            "count": sum(r[2] for r in fills)},
            "traced_launches": {
                name: sum(c for k, _, c in rows if any(m in k for m in ms))
                for name, ms in MARKERS.items()}}


def _loss(out) -> float:
    return float(np.asarray(out[0], np.float32).reshape(-1)[0])


def timed_modes(exe, program, feed, scope, fetch, timed, traced_reps=1):
    """One training program run in two legs on one scope and one batch:
    ``eager`` (``use_compiled=False``), then ``compiled``. Each leg
    starts from the state and step counter the scope held on entry (a
    host copy of it is put back before the compiled leg), so each can be
    held to its own start and both see the same dropout masks. A leg: a
    first run (compiled: the key's first, op by op), a second (compiled:
    the capture and a replay), ``timed`` runs on the host clock (each
    ending in a synchronise; no profiler) and ``traced_reps`` runs traced
    by ``traced``. For each mode: the loss (``fetch[0]``) of every run;
    the step ms of the timed runs and their p50; the launch counts over
    them (totals, by layout, by instance) and a step's; the peak device
    memory allocated from the second run on and what the caching
    allocator holds after the timed runs (compiled: with the graph's
    pool); the seconds of the second run; the compiled steps the leg
    built (``compiled_builds``: 1 for the compiled leg, whose capture no
    later run repeats); the later fetches of every run as floats
    (``fetched``, one list a run); and ``traced``'s figures."""
    from paddle_tpu_torch import kernels

    dev = exe.device
    start = {n: v.to("cpu", copy=True) if isinstance(v, torch.Tensor)
             else v for n, v in scope.items()}
    modes = {}
    for mode in ("eager", "compiled"):
        if mode == "compiled":
            for n, v in start.items():
                scope.set(n, v.to(dev) if isinstance(v, torch.Tensor)
                          else v)
        losses, fetched = [], []
        builds = exe.compiled_builds

        def step(comp=mode == "compiled"):
            out = exe.run(program, feed=feed, scope=scope, fetch_list=fetch,
                          use_compiled=comp)
            losses.append(_loss(out))
            fetched.append([float(np.asarray(o, np.float32).reshape(-1)[0])
                            for o in out[1:]])

        step()                  # compiled: the key's first run, op by op
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        step()                  # compiled: the capture and a replay
        torch.cuda.synchronize()
        second_s = time.perf_counter() - t0
        kernels.reset_launch_counts()
        step_ms = []
        for _ in range(timed):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = kernels.launch_counts()
        modes[mode] = dict(
            losses=losses, fetched=fetched,
            compiled_builds=exe.compiled_builds - builds, step_ms=step_ms,
            step_ms_p50=float(np.median(step_ms)),
            step_ms_range=[min(step_ms), max(step_ms)], second_s=second_s,
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            memory_reserved=torch.cuda.memory_reserved(),
            launches_per_step={k: v / timed for k, v in counts.items()
                               if v},
            launches=counts, layouts=kernels.layout_counts(),
            dtypes=kernels.dtype_counts(), **traced(step, traced_reps))
    return modes


def add_rates(modes, per_step, rate_name, model_flops=None):
    """Each mode's rate at its step's p50 (``per_step`` tokens or images
    a step) and, given a step's model flops, their share of the dense
    bf16 peak."""
    for r in modes.values():
        step_s = r["step_ms_p50"] / 1e3
        r[rate_name] = per_step / step_s
        if model_flops is not None:
            r["model_flops_share_of_bf16_peak"] = \
                model_flops / step_s / BF16_FLOPS_PER_S


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

    def timed(op, env, step=None, seed=None):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(op, env, step=step, seed=seed)
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


def _ernie(seq, layers=LAYERS):
    """(program, startup, batch(size, seed), fetches, model fields,
    tokens a step) of the ERNIE cell at ``seq``, ``layers`` deep."""
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.models import bert

    batch_size, preds = CELLS[seq]
    cfg = bert.BertConfig(num_hidden_layers=layers, dtype="bfloat16",
                          use_flash_attention=True,
                          max_position_embeddings=max(512, seq), **ERNIE)
    with unique_name.guard():
        main_prog, startup, _, fetches = bert.build_pretraining_program(
            cfg, seq_len=seq, optimizer_name="adamw",
            max_predictions_per_seq=preds)

    def batch(b, seed=0):
        return bert.synthetic_pretraining_batch(
            cfg, b, seq, seed=seed, max_predictions_per_seq=preds)

    info = {"model": "ernie_large", "layers": layers, "batch": batch_size,
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


def _transformer_big(layers=None, warmup_steps=4000, flash=True):
    """(program, startup, batch(size, seed), fetches [loss, learning
    rate], model fields, tokens a step) of Transformer-big at b48 s256,
    bf16 AMP, ``layers`` encoder and decoder layers each (6 by default),
    noam over ``warmup_steps``; ``flash=False`` builds the unfused
    attention branch."""
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.models import transformer

    cfg = transformer.transformer_big()
    cfg.use_flash_attention = flash
    if layers:
        cfg.n_encoder_layers = cfg.n_decoder_layers = layers
    with unique_name.guard():
        main_prog, startup, _, fetches = transformer.build_wmt_program(
            cfg, seq_len=WMT_SEQ, amp=True, warmup_steps=warmup_steps)
    lr = next(o for o in main_prog.global_block().ops
              if o.type == "lr_schedule").outputs["Out"][0]

    def batch(b, seed=0):
        return transformer.synthetic_batch(cfg, b, WMT_SEQ, seed=seed)

    info = {"model": "transformer_big", "layers": [cfg.n_encoder_layers,
                                                   cfg.n_decoder_layers],
            "batch": WMT_BATCH, "seq": WMT_SEQ, "dtype": "bf16 AMP",
            "warmup_steps": warmup_steps, "flash_attention": flash}
    return main_prog, startup, batch, [fetches["loss"], lr], info, \
        WMT_BATCH * WMT_SEQ


def transformer_big_flops(cfg, batch, seq):
    """A training step's model flops, as ``bench_transformer_big``
    (``tools/bench_models.py:265-270``) counts them: 6 flops a weight a
    token for the projections, FFNs and the tied output projection, and
    the attention products (encoder self, decoder self and cross)."""
    h, ff, v = cfg.d_model, cfg.d_inner, cfg.tgt_vocab_size
    l_enc, l_dec = cfg.n_encoder_layers, cfg.n_decoder_layers
    tokens = batch * seq
    enc = l_enc * (4 * h * h + 2 * h * ff)
    dec = l_dec * (8 * h * h + 2 * h * ff)
    matmul = 6.0 * (enc + dec) * tokens + 6.0 * h * v * tokens
    attn = 6.0 * 2 * (l_enc + 3 * l_dec) * batch * seq * seq * h
    return matmul + attn


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", choices=("ernie_large", "resnet50",
                                            "transformer_big"),
                        default="ernie_large")
    parser.add_argument("--seq", type=int, choices=sorted(CELLS),
                        default=512)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope

    model_flops = None
    if args.model == "resnet50":
        main_prog, startup, make_batch, fetch, info, per_step = _resnet50()
        rate_name = "images_per_s"
    elif args.model == "transformer_big":
        from paddle_tpu_torch.models import transformer

        main_prog, startup, make_batch, fetch, info, per_step = \
            _transformer_big()
        model_flops = transformer_big_flops(transformer.transformer_big(),
                                            WMT_BATCH, WMT_SEQ)
        rate_name = "tokens_per_s"
    else:
        main_prog, startup, make_batch, fetch, info, per_step = \
            _ernie(args.seq)
        rate_name = "tokens_per_s"
    batch_size = info["batch"]
    exe = executor_mod.Executor(device="cuda:0")
    scope = Scope()
    exe.run(startup, scope=scope)

    def feed_of(b):
        return {k: torch.from_numpy(v).to("cuda:0")
                for k, v in make_batch(b).items()}

    def stepper(b):
        feed = feed_of(b)
        return lambda: exe.run(main_prog, feed=feed, scope=scope,
                               fetch_list=fetch, use_compiled=False)

    modes = timed_modes(exe, main_prog, feed_of(batch_size), scope, fetch, 5,
                        traced_reps=2)
    add_rates(modes, per_step, rate_name, model_flops)
    exe.close()
    torch.cuda.empty_cache()
    step = stepper(batch_size)
    by_op_sync = _ms_by_op(executor_mod, step, sync=True)
    small = stepper(1)
    small()
    by_op_host = _ms_by_op(executor_mod, small, sync=False)
    ops = main_prog.global_block().ops
    print(json.dumps({
        **info, "ops": len(ops), **modes,
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
