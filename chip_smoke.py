"""Drive paddle_tpu_torch's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py

Needs a CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and the repo
checkout around this file; it builds the CUDA kernels itself. Each phase
prints one JSON line; any failure raises and the exit code is non-zero.

1. build     — nvcc builds every kernel of paddle_tpu_torch/csrc for sm_90a
               (one nvcc per source, in parallel); the card's name and
               power limit from nvidia-smi; ptxas's register and spill
               lines per source.
2. kernels   — each kernel against its plain PyTorch version on the card at
               the serving path's shapes: max abs/rel error, kernel ms
               (CUDA events over raw launches), plain ms, the one-call
               PyTorch yardstick where there is one (library_ms), and the
               least time the card could take (bound_ms, from bytes at
               3.35 TB/s and flops at 67 TFLOP/s for fp32 inputs, 989
               TFLOP/s, the dense bf16 tensor-core peak, for bf16 inputs).
               The training kernels at ERNIE-large's shapes: flash forward
               with dropout (and its keep mask read back bit for bit) and
               flash backward, compared and timed at the step's own B = 40,
               S = 512 and compared at S = 128 and 200; AdamW; each in bf16
               and fp32. A bf16 kernel is held against the plain version run
               in fp32 on the same values and rounded to bf16.
3. serve_fp32, serve_int8 — the decoder LM at the README's full width
               (vocab 32000, d_model 1024, 12 layers, 16 heads, d_inner
               4096, max_seq_len 2048), random weights from seed 0, through
               DecodeEngine: 9 concurrent requests, prompts of 5..1500
               tokens (both prefill lengths regimes), 32 new tokens, greedy
               plus one sampled at temperature 0.8. Continuous batching
               must equal one-at-a-time decode bit for bit, and every
               kernel of the phase must have launched. The launch counts
               are set to 0 just before the concurrent requests go in and
               read as soon as the last of them is answered, before the
               one-at-a-time rerun.
4. cpu_parity — one request at full width, prefill + 8 steps, on the card
               and on the CPU (plain versions): logits within rtol = atol
               = 1e-4 (12 layers of fp32 summed in different orders) and
               the same 5 top ids, in order, at every step.
5. train_parity — ERNIE at full width (hidden 1024, 16 heads, FFN 4096,
               vocab 18000, seq 512), batch 2, the same steps on the card
               and on the CPU from one scope_from_numpy state and on one
               batch: the same dropout masks bit for bit and the losses
               within rtol = atol = 1e-4 for fp32 at 2 layers (3 steps) and
               at all 24 layers (4 steps), within 1e-2 for bf16 at 2 layers
               (6 steps).
6. train_ernie — ERNIE-large as the reference's benchmark trains it (24
               layers, bf16 params, packed flash attention with probs
               dropout 0.1, hidden dropout 0.1, 80 masked predictions, NSP,
               AdamW lr 1e-4 / decay 0.01) through build_pretraining_program
               and Executor: startup on the card, one warm-up step, 8 timed
               steps on one synthetic batch (batch 40, or the largest of 32,
               24, 16, 8 that fits). Finite loss, the last below the
               warm-up's and the first step's (without a learning-rate
               warm-up AdamW's first steps overshoot at this depth: the
               24-layer train_parity leg shows the same rise on the CPU);
               exactly 24 flash forward, 24 flash backward and 398 AdamW
               launches a step; no NaN in any parameter. Its ms/step and
               tokens/s are smoke figures of a host-driven eager step.
The long-context and [B,H,S,D] slice adds, in the order they run:
   kernels  — check_flash_long: both flash kernels at the long step's
               shapes (packed, bias, dropout 0.1): bf16 B=4 S=2048 and B=2
               S=4096, fp32 B=4 S=2048, compared and timed. check_flash_bnsd:
               both in the [B,H,S,D] layout at the six bnsd TPU kernels'
               shapes (B=40 at S=512, 256, 128; Sq=512 Sk=256; causal; B=4
               S=2048; fp32), compared, the first three timed, and bit for
               bit equal to the packed layout on the same values.
7. train_parity_long — train_parity at seq 2048, batch 1, 2 layers, fp32,
               3 steps (position table widened to the sequence).
8. bnsd_ops  — a program with a 4-D layers.flash_attention ([40,16,512,64]
               bf16 q/k/v parameters, [B,1,1,S] key bias, dropout 0.1),
               append_backward, 3 Executor.run steps: one bnsd flash forward
               and one bnsd backward launch a step, finite gradients.
9. train_long_s2048, train_long_s4096 — train_ernie at the long-context
               benchmark rows (tools/bench_models.py bench_long_context):
               max_position_embeddings = seq, s2048 batch 4 with 307 masked
               predictions and s4096 batch 2 with 614, 1 warm-up + 5 timed
               steps; finite loss, the last timed loss below the warm-up's,
               24 / 24 / 398 launches a step.
Then one line with every ported kernel: ``launches_by_path`` gives each
phase's own count (set to 0 just before the phase, read just after),
``launches_by_layout`` the flash kernels' split by layout, and
``launches`` is serve_int8's for the serving kernels and train_ernie's
for the training kernels; ``variants`` are the flash kernels' other timed
shapes. Then the card's name and power limit, and last
{"ok": true, "device": {...}}.

TF32 is switched off: the fp32 projections stay torch.matmul in full
fp32, as the JAX package left them to XLA.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM data sheet, CUDA cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM data sheet, dense tensor cores

FULL = dict(vocab_size=32000, d_model=1024, n_head=16, n_layers=12,
            d_inner=4096, max_seq_len=2048)
REPLACES = {
    "flash_attention_fwd": "paddle_tpu/ops/pallas/flash_attention.py:948 "
                           "(_packed_fwd_kernel) + :311 (_fwd_kernel) + :377 "
                           "(_fused_fwd_kernel) + :822 (_fused_fwd_kernel_g)",
    "paged_attention": "paddle_tpu/ops/pallas/paged_attention.py:74",
    "int8_gemm": "paddle_tpu/ops/pallas/int8_gemm.py:82",
    "flash_attention_bwd": "paddle_tpu/ops/pallas/flash_attention.py:984 "
                           "(_packed_bwd_kernel) + :748 (_fused_bwd_kernel) "
                           "+ :860 (_fused_bwd_kernel_g) + :634 (_dkv_kernel) "
                           "+ :701 (_dq_kernel)",
    "fused_adamw": "paddle_tpu/ops/pallas/fused_adam.py:22",
}
ERNIE = dict(vocab_size=18000, hidden_size=1024, num_attention_heads=16,
             intermediate_size=4096)
SEQ, MAX_PREDS = 512, 80
# the long-context rows of tools/bench_models.py bench_long_context:
# (seq, batch), max(80, seq * 15 // 100) masked predictions
LONG = ((2048, 4), (4096, 2))
# check_flash_bnsd: (B, Sq, Sk, causal, dtype, timed) at the shapes the six
# bnsd TPU kernels take; bnsd_ops: the [B,H,S,D] of its program
BNSD_CASES = ((40, 512, 512, False, torch.bfloat16, True),
              (40, 256, 256, False, torch.bfloat16, True),
              (40, 128, 128, False, torch.bfloat16, True),
              (40, 512, 256, False, torch.bfloat16, False),
              (40, 512, 512, True, torch.bfloat16, False),
              (4, 2048, 2048, False, torch.bfloat16, False),
              (40, 512, 512, False, torch.float32, False))
BNSD_OPS = (40, 16, 512, 64)
SOURCES = {n: f"paddle_tpu_torch/csrc/{n}.cu" for n in REPLACES}


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def bound_ms(nbytes, flops, peak=FP32_FLOPS_PER_S):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def events_ms(fn, reps):
    """Device ms per call of fn over reps back-to-back calls."""
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


def errors(got, ref):
    diff = (got.double() - ref.double()).abs()
    return float(diff.max()), float((diff / ref.double().abs().clamp_min(
        1e-6)).max())


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------

def check_flash(dev, results):
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa

    n, hd = FULL["n_head"], FULL["d_model"] // FULL["n_head"]
    scale = hd ** -0.5
    lib = fa._lib()
    for s in (128, 512, 2048):
        g = torch.Generator(device=dev).manual_seed(s)
        q, k, v = (torch.randn(1, s, n * hd, device=dev, generator=g)
                   for _ in range(3))
        out, lse = fa.packed_flash_fwd(q, k, v, n, scale, True)
        ref_out, ref_lse = fa.plain_packed_flash_fwd(q, k, v, n, scale, True)
        torch.cuda.synchronize()
        e_out, r_out = errors(out, ref_out)
        e_lse, _ = errors(lse, ref_lse)
        if not (torch.allclose(out, ref_out, rtol=1e-4, atol=1e-5)
                and torch.allclose(lse, ref_lse, rtol=1e-5, atol=1e-4)):
            raise AssertionError(f"flash forward S={s}: out err {e_out}, "
                                 f"lse err {e_lse}")
        o2, l2 = torch.empty_like(q), torch.empty_like(lse)
        stream = torch.cuda.current_stream().cuda_stream
        strides = fa._stride_array("flash forward", hd, "packed", (
            ("q", q), ("k", k), ("v", v), ("out", o2)))
        # fp32 (dtype 0), no dropout (threshold 0)
        ms = events_ms(lambda i: lib.pt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None, o2.data_ptr(),
            l2.data_ptr(), strides, 1, s, s, n, hd, scale, 1, 0, 0, 0, 1.0,
            stream), 20)
        plain = events_ms(lambda i: fa.plain_packed_flash_fwd(
            q, k, v, n, scale, True), 10)
        q4, k4, v4 = (t.reshape(1, s, n, hd).transpose(1, 2).contiguous()
                      for t in (q, k, v))
        library = events_ms(lambda i: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, scale=scale), 10)
        pairs = s * (s + 1) // 2
        bms, by = bound_ms(4 * (4 * s * n * hd) + 4 * n * s,
                           n * pairs * 4 * hd)
        results.append(dict(name="flash_attention_fwd",
                            shape=f"B=1 S={s} n=16 hd=64 causal",
                            max_abs_err=max(e_out, e_lse), max_rel_err=r_out,
                            ms=ms, plain_ms=plain, library_ms=library,
                            bound_ms=bms, bound_by=by))


def check_paged(dev, results):
    from paddle_tpu_torch.kernels import paged_attention as pa

    n, hd = FULL["n_head"], FULL["d_model"] // FULL["n_head"]
    b, page, mp = 8, 16, 128
    kvdim = n * hd
    pos_list = [0, 5, 100, 517, 1023, 1500, 2047, 300]
    num_pages = 1 + sum(p // page + 1 for p in pos_list)
    g = torch.Generator(device=dev).manual_seed(1)
    # several pool copies, > 50 MB L2 in all, so timing reads cold pools
    copies = []
    for c in range(3):
        pk = torch.randn(num_pages, page, kvdim, device=dev, generator=g)
        pv = torch.randn(num_pages, page, kvdim, device=dev, generator=g)
        copies.append((pk, pv))
    table = torch.zeros(b, mp, dtype=torch.int32)
    nxt = 1
    for i, p in enumerate(pos_list):
        need = p // page + 1
        table[i, :need] = torch.arange(nxt, nxt + need, dtype=torch.int32)
        nxt += need
        for pk, pv in copies:   # stale tail of the last page: poison
            last = int(table[i, p // page])
            pk[last, p % page + 1:] = 3e4
            pv[last, p % page + 1:] = 1e6
    table = table.to(dev)
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    q = torch.randn(b, kvdim, device=dev, generator=g)
    pk, pv = copies[0]
    scale = hd ** -0.5
    out = pa.paged_decode_attention(q, pk, pv, table, pos, n, hd, scale)
    ref = pa.plain_paged_attention(q, pk, pv, table, pos, n, hd, scale)
    torch.cuda.synchronize()
    e_abs, e_rel = errors(out, ref)
    if not torch.allclose(out, ref, rtol=1e-4, atol=1e-5) \
            or float(out.abs().max()) > 100.0:
        raise AssertionError(f"paged attention: err {e_abs}, "
                             f"max |out| {float(out.abs().max())}")
    lib = pa._lib()
    o2 = torch.empty_like(out)
    stream = torch.cuda.current_stream().cuda_stream
    ms = events_ms(lambda i: lib.pt_paged_attention(
        q.data_ptr(), copies[i % 3][0].data_ptr(),
        copies[i % 3][1].data_ptr(), table.data_ptr(), pos.data_ptr(),
        o2.data_ptr(), b, n, hd, page, mp, kvdim, scale, stream), 30)
    plain = events_ms(lambda i: pa.plain_paged_attention(
        q, copies[i % 3][0], copies[i % 3][1], table, pos, n, hd, scale), 10)
    ctx = sum(p + 1 for p in pos_list)
    bms, by = bound_ms(2 * ctx * kvdim * 4 + 2 * b * kvdim * 4
                       + table.numel() * 4 + b * 4, 4 * ctx * kvdim)
    results.append(dict(name="paged_attention",
                        shape=f"B=8 P=16 MP=128 n=16 hd=64 pos={pos_list}",
                        max_abs_err=e_abs, max_rel_err=e_rel, ms=ms,
                        plain_ms=plain, library_ms=None, bound_ms=bms,
                        bound_by=by))


def check_int8(dev, results):
    from paddle_tpu_torch.kernels import int8_gemm as ig

    lib = ig._lib()
    stream = torch.cuda.current_stream().cuda_stream
    for m in (8, 512):
        for k, n in ((1024, 1024), (1024, 4096), (4096, 1024)):
            for with_bias, act in ((False, None), (True, "relu")):
                g = torch.Generator(device=dev).manual_seed(m + k + n)
                # weight copies rotated through, > 50 MB L2 in all: a
                # decode step reads its 72 weights cold
                reps = max(1, (64 << 20) // (k * n))
                w8s = [torch.randint(-127, 128, (k, n), device=dev,
                                     dtype=torch.int8, generator=g)
                       for _ in range(reps)]
                x = torch.randn(m, k, device=dev, generator=g)
                sc = (torch.rand(n, device=dev, generator=g) + 0.5) / 127.0
                bias = torch.randn(n, device=dev, generator=g) \
                    if with_bias else None
                out = ig.int8_weight_only_gemm(x, w8s[0], sc, bias, act)
                ref = ig.plain_int8_gemm(x, w8s[0], sc, bias, act)
                torch.cuda.synchronize()
                e_abs, e_rel = errors(out, ref)
                tol = 1e-5 * float(ref.abs().max()) + 1e-5
                if not torch.allclose(out, ref, rtol=1e-4, atol=tol):
                    raise AssertionError(f"int8 GEMM {m}x{k}x{n}: err "
                                         f"{e_abs}")
                o2 = torch.empty_like(out)
                bp = bias.data_ptr() if bias is not None else None
                relu = int(act == "relu")
                ksplit, kc = ig.split_plan(m, n, k)
                part = torch.empty(ksplit, m, n, device=dev)
                ms = events_ms(lambda i: lib.pt_int8_gemm(
                    x.data_ptr(), w8s[i % reps].data_ptr(), sc.data_ptr(),
                    bp, o2.data_ptr(), part.data_ptr(), m, n, k, ksplit, kc,
                    relu, stream), 30)
                plain = events_ms(lambda i: ig.plain_int8_gemm(
                    x, w8s[i % reps], sc, bias, act), 10)
                bb = bias if bias is not None else 0.0
                library = events_ms(
                    lambda i: x @ (w8s[i % reps].float() * sc) + bb, 10)
                nbytes = m * k * 4 + k * n + n * 4 * (2 if with_bias else 1) \
                    + m * n * 4
                bms, by = bound_ms(nbytes, 2 * m * k * n)
                results.append(dict(
                    name="int8_gemm", ksplit=ksplit,
                    shape=f"M={m} K={k} N={n} bias={with_bias} act={act}",
                    max_abs_err=e_abs, max_rel_err=e_rel, ms=ms,
                    plain_ms=plain, library_ms=library, bound_ms=bms,
                    bound_by=by))


def _train_attn_inputs(dev, b, s, dtype, seed):
    n, hd = ERNIE["num_attention_heads"], 64
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(b, s, n * hd, device=dev, generator=g)
                   .to(dtype) for _ in range(4))
    bias = torch.where(torch.rand(b, s, device=dev, generator=g) < 0.1,
                       -1e4, 0.0)
    return q, k, v, do, bias


# fp32: the kernels sum in another order than the plain versions. bf16: the
# kernels compute in fp32 from the bf16 inputs, so they are held against the
# plain versions run in fp32 on the same values and rounded to bf16 once:
# one bf16 ulp (2^-7 relative) plus 1e-3, about 2 % of a typical |out| or
# |dq| at S = 512 with N(0, 1) inputs. dbias is fp32 in both, |dbias| ~ 1.
TRAIN_TOL = {torch.float32: dict(rtol=1e-4, atol=2e-5),
             torch.bfloat16: dict(rtol=2 ** -7, atol=1e-3)}
DBIAS_TOL = dict(rtol=1e-3, atol=1e-3)
RATE, ATTN_SEED = 0.1, 20261016


def _compare_flash(fa, what, q, k, v, do, bias, n, scale, causal=False,
                   layout="packed"):
    """The forward with dropout and the backward against the plain
    versions computed in fp32 from the same values; returns the kernel's
    (out, lse) and the largest absolute error of each output."""
    dtype = q.dtype
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    out, lse = fa.flash_fwd(q, k, v, n, scale, causal, bias, RATE, ATTN_SEED,
                            layout)
    r_out, r_lse = fa.plain_flash_fwd(q32, k32, v32, n, scale, causal, bias,
                                      RATE, ATTN_SEED, layout)
    r_out = r_out.to(dtype)
    torch.cuda.synchronize()
    if not (torch.allclose(out.float(), r_out.float(), **TRAIN_TOL[dtype])
            and torch.allclose(lse, r_lse, rtol=1e-5, atol=1e-4)):
        raise AssertionError(f"flash forward+dropout {what}: "
                             f"{errors(out, r_out)} {errors(lse, r_lse)}")
    err = {"out": errors(out, r_out)[0], "lse": errors(lse, r_lse)[0]}
    # both backwards start from the same saved (out, lse)
    got = fa.flash_bwd(q, k, v, r_out, r_lse, do, n, scale, causal, bias,
                       RATE, ATTN_SEED, layout)
    ref = fa.plain_flash_bwd(q32, k32, v32, r_out.float(), r_lse, do32, n,
                             scale, causal, bias, RATE, ATTN_SEED, layout)
    torch.cuda.synchronize()
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        if r is None:
            continue
        if name == "dbias":
            tol = DBIAS_TOL
        else:
            tol, r = TRAIN_TOL[dtype], r.to(dtype)
        err[name] = errors(a, r)[0]
        if not torch.allclose(a.float(), r.float(), **tol):
            raise AssertionError(f"flash backward {what} {name}: "
                                 f"{errors(a, r)}")
    return out, lse, err


def _time_flash(fa, q, k, v, do, bias, n, scale, out, lse, layout, peak,
                plain_reps=3):
    """(forward, backward) timings: kernel ms, plain ms, SDPA ms (its
    forward; its backward through autograd) and the bound, for the
    non-causal, key-bias, dropout call of the training step."""
    import torch.nn.functional as F

    esz = q.element_size()
    nq, nk = q.numel(), k.numel()
    b, sk = bias.shape
    sq = lse.shape[-1]
    heads, hd = b * n, q.shape[-1] if layout == "bnsd" else q.shape[-1] // n
    q4, k4, v4, do4 = (fa._heads(t, n, layout).contiguous()
                       for t in (q, k, v, do))
    m4 = bias.to(q.dtype).reshape(b, 1, 1, sk).expand(b, 1, sq, sk)
    fwd = dict(
        ms=events_ms(lambda i: fa.flash_fwd(
            q, k, v, n, scale, False, bias, RATE, ATTN_SEED, layout), 10),
        plain_ms=events_ms(lambda i: fa.plain_flash_fwd(
            q, k, v, n, scale, False, bias, RATE, ATTN_SEED, layout),
            plain_reps),
        library_ms=events_ms(lambda i: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=m4, dropout_p=RATE, scale=scale), 10))
    fwd["bound_ms"], fwd["bound_by"] = bound_ms(
        (2 * nq + 2 * nk) * esz + bias.numel() * 4 + lse.numel() * 4,
        heads * 2 * 2 * sq * sk * hd, peak)
    bwd = dict(
        ms=events_ms(lambda i: fa.flash_bwd(
            q, k, v, out, lse, do, n, scale, False, bias, RATE, ATTN_SEED,
            layout), 10),
        plain_ms=events_ms(lambda i: fa.plain_flash_bwd(
            q, k, v, out, lse, do, n, scale, False, bias, RATE, ATTN_SEED,
            layout), plain_reps))
    q4, k4, v4 = (t.requires_grad_(True) for t in (q4, k4, v4))
    o4 = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4,
                                        dropout_p=RATE, scale=scale)
    bwd["library_ms"] = events_ms(lambda i: torch.autograd.grad(
        o4, (q4, k4, v4), do4, retain_graph=True), 10)
    bwd["bound_ms"], bwd["bound_by"] = bound_ms(
        (4 * nq + 4 * nk) * esz + lse.numel() * 4 + 2 * bias.numel() * 4,
        heads * 5 * 2 * sq * sk * hd, peak)
    return fwd, bwd


def _flash_rows(results, shape, err, timing):
    """Append and return one result row per flash kernel; err from
    _compare_flash, timing from _time_flash (or None: compared only)."""
    rows = []
    for i, (name, keys) in enumerate((
            ("flash_attention_fwd", ("out", "lse")),
            ("flash_attention_bwd", ("dq", "dk", "dv", "dbias")))):
        row = dict(name=name, shape=shape, max_rel_err=None,
                   max_abs_err=max(err[k_] for k_ in keys if k_ != "dbias"),
                   errors={k_: err[k_] for k_ in keys if k_ in err})
        row.update(timing[i] if timing else dict(
            ms=None, plain_ms=None, library_ms=None, bound_ms=None,
            bound_by=None))
        rows.append(row)
    results.extend(rows)
    return rows


def check_flash_train(dev, results):
    """Flash forward with dropout and flash backward, compared and timed at
    the training step's attention shape (B = 40, S = 512, 16 heads of 64,
    key bias, rate 0.1), and compared at S = 128 and at S = 200 (not a
    multiple of the 64-row tile) with B = 4."""
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.kernels import flash_attention as fa

    n, hd = ERNIE["num_attention_heads"], 64
    scale = hd ** -0.5
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        small = {}
        for s in (128, 200):
            q, k, v, do, bias = _train_attn_inputs(dev, 4, s, dtype, s)
            small[f"S={s}"] = _compare_flash(
                fa, f"{name} B=4 S={s}", q, k, v, do, bias, n, scale)[2]
        b, s = 40, SEQ
        q, k, v, do, bias = _train_attn_inputs(dev, b, s, dtype, 1)
        out, lse, err = _compare_flash(fa, f"{name} B={b} S={s}", q, k, v,
                                       do, bias, n, scale)
        peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 \
            else FP32_FLOPS_PER_S
        timing = _time_flash(fa, q, k, v, do, bias, n, scale, out, lse,
                             "packed", peak)
        fwd, bwd = _flash_rows(
            results, f"B={b} S={s} n=16 hd=64 bias dropout={RATE} {name}",
            err, timing)
        fwd["max_abs_err_at_b4"] = {k_: e["out"] for k_, e in small.items()}
        bwd["max_abs_err_at_b4"] = {k_: max(e["dq"], e["dk"], e["dv"])
                                    for k_, e in small.items()}
        del out, lse

    # the kernel's keep mask, read back exactly: q = 0 makes every
    # probability 1/S, and v one-hot over a 64-key chunk makes
    # out[q, d] = keep(q, chunk + d) / ((1 - rate) S)
    b, s = 2, SEQ
    q = torch.zeros(b, s, n * hd, device=dev)
    want = rng.attn_keep(ATTN_SEED, RATE, b, n, s, s, dev)
    for c in range(s // hd):
        v = torch.zeros(b, s, n, hd, device=dev)
        v[:, c * hd:(c + 1) * hd] = torch.eye(hd, device=dev)[None, :, None]
        out, _ = fa.packed_flash_fwd(q, q, v.reshape(b, s, n * hd), n, 1.0,
                                     False, None, RATE, ATTN_SEED)
        got = out.reshape(b, s, n, hd).permute(0, 2, 1, 3) != 0
        if not torch.equal(got, want[..., c * hd:(c + 1) * hd]):
            raise AssertionError("flash forward: the kernel's dropout keep "
                                 "mask differs from the plain mask")
    return dict(mask_bits_checked=int(want.numel()),
                keep_fraction=float(want.float().mean()))


def check_flash_long(dev, results):
    """Both flash kernels at the long-context step's own attention shapes
    (packed [B,S,16*64] projections read in place, key bias, dropout 0.1):
    bf16 at B = 4, S = 2048 and B = 2, S = 4096, fp32 at B = 4, S = 2048.
    Compared with the plain version run in fp32 on the same values (its
    [B,16,S,S] temporaries, 2 GiB each at S = 4096, fit the card) and
    timed."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    n, hd = ERNIE["num_attention_heads"], 64
    for (s, b), dtype in ((LONG[0], torch.bfloat16),
                          (LONG[1], torch.bfloat16),
                          (LONG[0], torch.float32)):
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        q, k, v, do, bias = _train_attn_inputs(dev, b, s, dtype, s + b)
        out, lse, err = _compare_flash(fa, f"long {name} B={b} S={s}", q, k,
                                       v, do, bias, n, hd ** -0.5)
        torch.cuda.empty_cache()
        peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 \
            else FP32_FLOPS_PER_S
        timing = _time_flash(fa, q, k, v, do, bias, n, hd ** -0.5, out, lse,
                             "packed", peak, plain_reps=2)
        _flash_rows(results, f"B={b} S={s} n=16 hd=64 bias dropout={RATE} "
                             f"{name} long", err, timing)
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()


def _bnsd_inputs(dev, b, sq, sk, dtype, seed):
    n, hd = ERNIE["num_attention_heads"], 64
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(b, n, sq, hd, device=dev, generator=g).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, n, sk, hd, device=dev, generator=g).to(dtype)
            for _ in range(2))
    bias = torch.where(torch.rand(b, sk, device=dev, generator=g) < 0.1,
                       -1e4, 0.0)
    return q, k, v, do, bias


def check_flash_bnsd(dev, results):
    """Both flash kernels in the [B,H,S,D] layout at the shapes the six
    bnsd TPU kernels take, 16 heads of 64, key bias and dropout 0.1, bf16:
    B = 40 at S = 512 and 256 (rows 5, 6, 9) and 128 (rows 6, 7), timed;
    cross-attention Sq = 512, Sk = 256; causal at S = 512; B = 4 at S =
    2048 (rows 10, 11, 2); fp32 at S = 512. Each against its plain version,
    and against the packed layout on the same values, bit for bit: the
    same arithmetic through other strides."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    n, hd = ERNIE["num_attention_heads"], 64
    scale = hd ** -0.5
    same_bits = 0
    for b, sq, sk, causal, dtype, timed in BNSD_CASES:
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        shape = (f"B={b} Sq={sq} Sk={sk} n=16 hd=64 bias dropout={RATE}"
                 f"{' causal' if causal else ''} {name} bnsd")
        q, k, v, do, bias = _bnsd_inputs(dev, b, sq, sk, dtype, sq + sk + b)
        out, lse, err = _compare_flash(fa, shape, q, k, v, do, bias, n,
                                       scale, causal, "bnsd")
        # the same values through the packed layout: the same bits
        runs = {}
        for layout in ("bnsd", "packed"):
            args = [t if layout == "bnsd" else
                    t.transpose(1, 2).reshape(b, t.shape[2], n * hd)
                    .contiguous() for t in (q, k, v, do)]
            o, l_ = fa.flash_fwd(*args[:3], n, scale, causal, bias, RATE,
                                 ATTN_SEED, layout)
            g = fa.flash_bwd(*args[:3], o, l_, args[3], n, scale, causal,
                             bias, RATE, ATTN_SEED, layout)
            runs[layout] = [fa._heads(t, n, layout) for t in (o, *g[:3])] + \
                [l_, g[3]]
        torch.cuda.synchronize()
        for what, x, y in zip(("out", "dq", "dk", "dv", "lse", "dbias"),
                              runs["bnsd"], runs["packed"]):
            if not torch.equal(x, y):
                raise AssertionError(f"flash {shape}: {what} differs between "
                                     f"the bnsd and packed layouts")
        same_bits += sum(t.numel() for t in runs["bnsd"])
        del runs
        timing = None
        if timed:
            timing = _time_flash(fa, q, k, v, do, bias, n, scale, out, lse,
                                 "bnsd", BF16_FLOPS_PER_S)
        _flash_rows(results, shape, err, timing)
        del q, k, v, do, out, lse
    torch.cuda.empty_cache()
    return dict(bnsd_equals_packed_bitwise=True, elements_compared=same_bits)


def check_adamw(dev, results):
    from paddle_tpu_torch.kernels import fused_adam as fad

    lr = torch.tensor([1e-4], device=dev)
    b1p, b2p = (torch.tensor([x], device=dev) for x in (0.9 ** 3, 0.999 ** 3))
    hyper = (0.9, 0.999, 1e-8, 0.01)
    for shape in ((1024, 4096), (18000, 1024)):
        for dtype in (torch.bfloat16, torch.float32):
            name = "bf16" if dtype == torch.bfloat16 else "fp32"
            g = torch.Generator(device=dev).manual_seed(shape[0])
            # several copies, > 50 MB L2 in all: a step reads each
            # parameter cold
            reps = 4
            ps = [(torch.randn(shape, device=dev, generator=g) * 0.02)
                  .to(dtype) for _ in range(reps)]
            gr = (torch.randn(shape, device=dev, generator=g) * 1e-2) \
                .to(dtype)
            ms_ = [torch.randn(shape, device=dev, generator=g) * 1e-3
                   for _ in range(reps)]
            vs = [torch.rand(shape, device=dev, generator=g) * 1e-5
                  for _ in range(reps)]
            want = fad.plain_fused_adamw(ps[0], gr, ms_[0], vs[0], lr, *hyper,
                                         b1p, b2p)
            p0, m0, v0 = ps[0].clone(), ms_[0].clone(), vs[0].clone()
            fad.fused_adamw_(p0, gr, m0, v0, lr, *hyper, b1p, b2p)
            torch.cuda.synchronize()
            # fp32: nvcc contracts a * b + c into one fma where the plain
            # version rounds twice; bf16 params: one bf16 ulp (2^-8)
            ptol = dict(rtol=1e-6, atol=1e-7) if dtype == torch.float32 \
                else dict(rtol=8e-3, atol=1e-7)
            if not (torch.allclose(p0.float(), want[0].float(), **ptol)
                    and torch.allclose(m0, want[1], rtol=1e-6, atol=1e-9)
                    and torch.allclose(v0, want[2], rtol=1e-6, atol=1e-12)):
                raise AssertionError(f"AdamW {shape} {name}: "
                                     f"{errors(p0, want[0])}")
            e_abs = max(errors(p0, want[0])[0], errors(m0, want[1])[0],
                        errors(v0, want[2])[0])
            ms = events_ms(lambda i: fad.fused_adamw_(
                ps[i % reps], gr, ms_[i % reps], vs[i % reps], lr, *hyper,
                b1p, b2p), 20)
            plain = events_ms(lambda i: fad.plain_fused_adamw(
                ps[i % reps], gr, ms_[i % reps], vs[i % reps], lr, *hyper,
                b1p, b2p), 5)
            library = None
            if dtype == torch.float32:
                # the library's fused update wants one dtype throughout,
                # so it is a yardstick for the fp32 rows only
                steps = [torch.tensor(3.0, device=dev) for _ in range(reps)]
                library = events_ms(lambda i: torch._fused_adamw_(
                    [ps[i % reps]], [gr], [ms_[i % reps]], [vs[i % reps]],
                    [], [steps[i % reps]], lr=1e-4, beta1=0.9, beta2=0.999,
                    weight_decay=0.01, eps=1e-8, amsgrad=False,
                    maximize=False), 20)
            esz = ps[0].element_size()
            numel = ps[0].numel()
            bms, by = bound_ms(numel * (3 * esz + 16), numel * 12,
                               FP32_FLOPS_PER_S)
            results.append(dict(
                name="fused_adamw", shape=f"{list(shape)} {name}",
                max_abs_err=e_abs, max_rel_err=None, ms=ms, plain_ms=plain,
                library_ms=library, bound_ms=bms, bound_by=by))


# ---------------------------------------------------------------------------
# 3. serving at full width
# ---------------------------------------------------------------------------

def serve(phase, cfg, params, quant, dev):
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core import telemetry
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    eng = DecodeEngine(cfg, params, DecodeConfig(
        max_slots=8, page_size=16, kv_pages=1024, weight_quant=quant,
        max_new_tokens=32), device=dev)
    t0 = time.perf_counter()
    built = eng.warmup()
    warm_s = time.perf_counter() - t0
    rng = np.random.RandomState(3)
    lengths = [5, 37, 100, 250, 480, 700, 1100, 1500]
    reqs = [dict(prompt=rng.randint(3, cfg.vocab_size, n).astype(np.int32),
                 max_new_tokens=32, stop_at_eos=False) for n in lengths]
    reqs.append(dict(prompt=rng.randint(3, cfg.vocab_size, 300)
                     .astype(np.int32), max_new_tokens=32, temperature=0.8,
                     seed=7, stop_at_eos=False))
    kernels.reset_launch_counts()
    telemetry.reset()
    eng.start()
    try:
        t0 = time.perf_counter()
        handles = [eng.submit(**r) for r in reqs]
        together = [np.asarray(h.result(timeout=600)) for h in handles]
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        layouts = kernels.layout_counts()
        stats = eng.stats()
        alone = [np.asarray(eng.generate(timeout=600, **r)) for r in reqs]
    finally:
        eng.close(drain=True, timeout=60)
    if not all(np.array_equal(a, b) for a, b in zip(together, alone)):
        raise AssertionError(f"{phase}: continuous != sequential")
    if any(len(t) != 32 for t in together):
        raise AssertionError(f"{phase}: short generation")
    need = ["flash_attention_fwd", "paged_attention"] + \
        (["int8_gemm"] if quant == "int8" else [])
    if any(launches[n] == 0 for n in need):
        raise AssertionError(f"{phase}: a kernel never launched: {launches}")
    tokens = sum(len(t) for t in together)
    emit(phase, requests=len(reqs), prompt_lengths=lengths + [300],
         tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
         prefill_ms_p50=stats["prefill_ms"]["p50"],
         step_ms_p50=stats["step_ms"]["p50"],
         steps=stats.get("steps"), programs_built=built, warmup_s=warm_s,
         continuous_equals_sequential=True, launches=launches,
         flash_launches_by_layout=layouts,
         kv_high_water_pages=stats["kv_cache"]["high_water_pages"])
    return launches, layouts


# ---------------------------------------------------------------------------
# 4. card vs CPU at full width
# ---------------------------------------------------------------------------

def cpu_parity(cfg, params, dev):
    from paddle_tpu_torch.core.executor import run_block
    from paddle_tpu_torch.models.decoder_lm import (build_prefill_program,
                                                    build_step_program,
                                                    params_from_numpy)

    pages, page = 16, 16
    mp = cfg.max_seq_len // page
    prompt = np.random.RandomState(4).randint(3, cfg.vocab_size, 100)
    bucket = 128
    prefill = build_prefill_program(cfg, 1, bucket, pages, page)[0]
    step = build_step_program(cfg, 1, pages, page)[0]
    table = np.zeros((1, mp), np.int32)
    table[0, :8] = np.arange(1, 9)
    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, :100] = prompt
    oh = np.zeros((1, bucket), np.float32)
    oh[0, 99] = 1.0
    runs = {}
    for device in (dev, torch.device("cpu")):
        p = params_from_numpy(params, device)
        pools = {f"kv_{kv}_{i}": torch.zeros(pages, page, cfg.d_model,
                                             device=device)
                 for i in range(cfg.n_layers) for kv in "kv"}

        def run(block, feed):
            env = dict(p, **pools)
            env.update({n: torch.from_numpy(v).to(device)
                        for n, v in feed.items()})
            run_block(block, env)
            pools.update({n: env[n + "_out"] for n in list(pools)})
            return env["logits"].cpu()

        logits = [run(prefill.global_block(),
                      {"tokens": tokens, "lengths": np.array([100], np.int32),
                       "last_onehot": oh, "page_table": table})]
        for i in range(8):
            logits.append(run(step.global_block(), {
                "tokens": np.array([int(logits[-1].argmax())], np.int32),
                "positions": np.array([100 + i], np.int32),
                "page_table": table}))
        lg = torch.stack(logits).reshape(9, -1)
        runs[device.type] = (lg, lg.topk(5).indices.tolist())
    (lg, top_gpu), (lc, top_cpu) = runs["cuda"], runs["cpu"]
    err = float((lg - lc).abs().max())
    ok = torch.allclose(lg, lc, rtol=1e-4, atol=1e-4) and top_gpu == top_cpu
    emit("cpu_parity", prompt_len=100, steps=8, max_abs_err=err,
         max_abs_logit=float(lc.abs().max()), tolerance="rtol=atol=1e-4",
         top5_ids_gpu=top_gpu, top5_ids_cpu=top_cpu, ok=ok)
    if not ok:
        raise AssertionError("card and CPU disagree at full width")


# ---------------------------------------------------------------------------
# 5, 6. training at full width
# ---------------------------------------------------------------------------

def _preds(seq):
    return MAX_PREDS if seq == SEQ else max(80, seq * 15 // 100)


def _ernie_programs(layers, dtype, seq=SEQ):
    """ERNIE at full width; above 512 with the position table widened to
    the sequence, as the long-context benchmark configures it."""
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig(num_hidden_layers=layers, dtype=dtype,
                          use_flash_attention=True,
                          max_position_embeddings=max(512, seq), **ERNIE)
    with unique_name.guard():
        main_prog, startup, _, fetches = bert.build_pretraining_program(
            cfg, seq_len=seq, optimizer_name="adamw",
            max_predictions_per_seq=_preds(seq))
    return cfg, main_prog, startup, fetches


def _state_arrays(scope):
    """A scope's state as scope_from_numpy takes it (bf16 as uint16 bits)."""
    out = {}
    for name, val in scope.items():
        if isinstance(val, torch.Tensor) and val.dtype == torch.bfloat16:
            val = (val.view(torch.int16).numpy().view(np.uint16), "bfloat16")
        elif isinstance(val, torch.Tensor):
            val = val.numpy()
        out[name] = val
    return out


def train_parity(dev, layers, dtype, steps, tol, seq=SEQ, batch_size=2):
    """``steps`` steps of ERNIE at full width, ``layers`` deep, on the card
    and on the CPU from one state and on one batch: the same dropout masks
    bit for bit, losses within rtol = atol = ``tol``."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.models import bert

    cfg, main_prog, startup, fetches = _ernie_programs(layers, dtype, seq)
    scope = Scope()
    Executor(device="cpu").run(startup, scope=scope)
    state = _state_arrays(scope)
    batch = bert.synthetic_pretraining_batch(
        cfg, batch_size, seq, seed=2, max_predictions_per_seq=_preds(seq))
    ops = main_prog.global_block().ops
    masks = [o.outputs["Mask"][0] for o in ops if o.type == "dropout"]
    runs, counts, layouts, seconds = {}, {}, {}, {}
    for device in (dev, torch.device("cpu")):
        sc = bert.scope_from_numpy(state, device)
        exe = Executor(device=device)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        runs[device.type] = [exe.run(main_prog, feed=batch, scope=sc,
                                     fetch_list=[fetches["loss"]] + masks)
                             for _ in range(steps)]
        seconds[device.type] = time.perf_counter() - t0
        counts[device.type] = kernels.launch_counts()
        layouts[device.type] = kernels.layout_counts()
    loss_gpu = [float(r[0].reshape(-1)[0]) for r in runs["cuda"]]
    loss_cpu = [float(r[0].reshape(-1)[0]) for r in runs["cpu"]]
    masks_equal = all(np.array_equal(x, y)
                      for a, b in zip(runs["cuda"], runs["cpu"])
                      for x, y in zip(a[1:], b[1:]))
    ok = masks_equal and np.allclose(loss_gpu, loss_cpu, rtol=tol, atol=tol)
    per_step = {k: v / steps for k, v in counts["cuda"].items() if v}
    emit("train_parity", layers=layers, batch=batch_size, seq=seq,
         dtype=dtype,
         steps=steps, loss_gpu=loss_gpu, loss_cpu=loss_cpu,
         dropout_masks=len(masks), masks_bitwise_equal=masks_equal,
         tolerance=f"rtol=atol={tol}", launches_per_step=per_step,
         seconds=seconds, ok=bool(ok))
    if not ok:
        raise AssertionError("training: card and CPU disagree")
    if any(counts["cpu"].values()):
        raise AssertionError("a CPU run launched a kernel")
    n_adamw = sum(o.type == "adamw" for o in ops)
    if per_step != {"flash_attention_fwd": layers,
                    "flash_attention_bwd": layers, "fused_adamw": n_adamw}:
        raise AssertionError(f"train_parity: launches per step {per_step}")
    return counts["cuda"], layouts["cuda"]


def train_ernie(dev, smi, phase="train_ernie", seq=SEQ,
                batches=(40, 32, 24, 16, 8), timed=8):
    """ERNIE-large, 24 layers, bf16: startup, one warm-up step and
    ``timed`` timed steps on one batch, at the first batch size of
    ``batches`` that fits."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.models import bert

    layers = 24
    cfg, main_prog, startup, fetches = _ernie_programs(layers, "bfloat16",
                                                       seq)
    ops = main_prog.global_block().ops
    n_adamw = sum(o.type == "adamw" for o in ops)
    exe = Executor(device=dev)
    tried = []
    for batch_size in batches:
        scope = Scope()
        t0 = time.perf_counter()
        exe.run(startup, scope=scope)
        torch.cuda.synchronize()
        startup_s = time.perf_counter() - t0
        batch = bert.synthetic_pretraining_batch(
            cfg, batch_size, seq, seed=0,
            max_predictions_per_seq=_preds(seq))
        torch.cuda.reset_peak_memory_stats()
        try:
            warm = exe.run(main_prog, feed=batch, scope=scope,
                           fetch_list=[fetches["loss"]])
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError as e:
            # the one failure this phase answers: take the next batch size
            tried.append(dict(batch=batch_size, why=str(e).split(".")[0]))
            del scope
            torch.cuda.empty_cache()
    else:
        raise AssertionError(f"{phase}: no batch size fits: {tried}")
    kernels.reset_launch_counts()
    losses, step_ms = [float(warm[0].reshape(-1)[0])], []
    for _ in range(timed):
        t0 = time.perf_counter()
        out = exe.run(main_prog, feed=batch, scope=scope,
                      fetch_list=[fetches["loss"]])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out[0].reshape(-1)[0]))
    counts = kernels.launch_counts()
    layouts = kernels.layout_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: counts[k] / timed for k in
                ("flash_attention_fwd", "flash_attention_bwd", "fused_adamw")}
    params = [scope.find_var(p.name) for p in main_prog.all_parameters()]
    finite = all(bool(torch.isfinite(p.float()).all()) for p in params)
    p50 = float(np.median(step_ms))
    emit(phase, model="ernie_large", layers=layers, dtype="bfloat16",
         seq=seq, max_predictions=_preds(seq), batch=batch_size,
         batches_that_did_not_fit=tried, ops=len(ops),
         op_types=len({o.type for o in ops}), parameters=len(params),
         parameter_elements=int(sum(p.numel() for p in params)),
         startup_s=startup_s, warmup_loss=losses[0], losses=losses[1:],
         step_ms=step_ms, step_ms_p50=p50,
         step_ms_range=[min(step_ms), max(step_ms)],
         tokens_per_s=batch_size * seq / (p50 / 1e3),
         max_memory_allocated=peak, launches_per_step=per_step,
         flash_launches_by_layout=layouts,
         params_finite=finite, nvidia_smi=smi,
         note="smoke figures of a host-driven eager step, not a benchmark")
    # one batch every step: the last loss lies below the warm-up's, which
    # no update preceded, and at S = 512 (8 timed steps) below the first
    # step's too
    first = losses[:2] if seq == SEQ else losses[:1]
    if not all(np.isfinite(losses)) or not losses[timed] < min(first):
        raise AssertionError(f"{phase}: loss did not fall: {losses}")
    if per_step != {"flash_attention_fwd": layers,
                    "flash_attention_bwd": layers, "fused_adamw": n_adamw} \
            or n_adamw != 398:
        raise AssertionError(f"{phase}: launches per step {per_step}, "
                             f"{n_adamw} adamw ops")
    if not finite:
        raise AssertionError(f"{phase}: a parameter is not finite")
    return counts, layouts


def bnsd_ops(dev):
    """The 4-D branch of the flash_attention op through the program path: a
    program built with layers.flash_attention on [40,16,512,64] bf16 q/k/v
    parameters with a [B,1,1,S] key bias from a fed mask and attention
    dropout 0.1, append_backward, and 3 Executor.run steps on the card
    fetching the loss and the three gradients. Each step must launch one
    flash forward and one flash backward, both in the bnsd layout."""
    from paddle_tpu_torch import kernels, layers
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.backward import append_backward
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.ir import Program, program_guard
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.initializer import TruncatedNormal

    (b, n, s, hd), steps = BNSD_OPS, 3
    main_prog, startup = Program(), Program()
    with unique_name.guard(), program_guard(main_prog, startup):
        q, k, v = (layers.create_parameter(
            [b, n, s, hd], "bfloat16", name=f"attn_{c}",
            default_initializer=TruncatedNormal(0.0, 1.0)) for c in "qkv")
        mask = layers.static_data("mask", [b, s], "float32")
        bias = layers.unsqueeze(layers.scale(
            mask, scale=10000.0, bias=-1.0, bias_after_scale=False), [1, 2])
        bias.stop_gradient = True
        out = layers.flash_attention(q, k, v, bias=bias, dropout_rate=RATE)
        loss = layers.mean(layers.elementwise_mul(out, out))
        append_backward(loss)
    exe = Executor(device=dev)
    scope = Scope()
    exe.run(startup, scope=scope)
    feed = {"mask": (np.random.RandomState(5).rand(b, s) > 0.1)
            .astype(np.float32)}
    fetch = [loss.name] + [f"attn_{c}@GRAD" for c in "qkv"]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    runs = [exe.run(main_prog, feed=feed, fetch_list=fetch, scope=scope)
            for _ in range(steps)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts, layouts = kernels.launch_counts(), kernels.layout_counts()
    losses = [float(r[0].reshape(-1)[0]) for r in runs]
    grads_ok = all(g.shape == (b, n, s, hd) and np.isfinite(
        g.astype(np.float32)).all() and np.abs(g.astype(np.float32)).max()
        > 0 for r in runs for g in r[1:])
    want = {"flash_attention_fwd": {"packed": 0, "bnsd": steps},
            "flash_attention_bwd": {"packed": 0, "bnsd": steps}}
    emit("bnsd_ops", shape=[b, n, s, hd], dtype="bfloat16", steps=steps,
         losses=losses, grads_finite_nonzero=grads_ok, seconds=seconds,
         launches=counts, launches_by_layout=layouts,
         ops=[o.type for o in main_prog.global_block().ops])
    if layouts != want or not grads_ok or not np.isfinite(losses).all():
        raise AssertionError(f"bnsd_ops: launches {layouts}, losses "
                             f"{losses}, grads finite {grads_ok}")
    return counts, layouts


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script needs "
              "an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models.decoder_lm import (DecoderLMConfig,
                                                    decoder_lm_params)

    dev = torch.device("cuda:0")
    smi = nvidia_smi()
    t0 = time.perf_counter()
    per_source = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in (_build.BUILD_DIR /
                                       f"{n}.ptxas.txt").read_text()
                 .splitlines() if "registers" in ln or "spill" in ln]
             for n in _build.SOURCES
             if (_build.BUILD_DIR / f"{n}.ptxas.txt").exists()}
    emit("build", seconds=build_s, per_source_s=per_source, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), ptxas=ptxas)

    results = []
    check_flash(dev, results)
    check_paged(dev, results)
    check_int8(dev, results)
    mask_check = check_flash_train(dev, results)
    check_flash_long(dev, results)
    bnsd_check = check_flash_bnsd(dev, results)
    check_adamw(dev, results)
    emit("kernels", results=results, dropout_mask=mask_check,
         bnsd_layout=bnsd_check)

    cfg = DecoderLMConfig(**FULL)
    t0 = time.perf_counter()
    params = decoder_lm_params(cfg, seed=0)
    emit("params", seconds=time.perf_counter() - t0,
         tensors=len(params), elements=int(sum(v.size
                                               for v in params.values())))
    # each path's own launch counts, and the flash kernels' by layout
    runs = {phase: serve(phase, cfg, params, quant, dev)
            for phase, quant in (("serve_fp32", "none"),
                                 ("serve_int8", "int8"))}
    cpu_parity(cfg, params, dev)
    del params
    runs["train_parity"] = train_parity(dev, 2, "float32", 3, 1e-4)
    runs["train_parity_bf16"] = train_parity(dev, 2, "bfloat16", 6, 1e-2)
    runs["train_parity_24"] = train_parity(dev, 24, "float32", 4, 1e-4)
    runs["train_parity_long"] = train_parity(dev, 2, "float32", 3, 1e-4,
                                             seq=LONG[0][0], batch_size=1)
    runs["train_ernie"] = train_ernie(dev, smi)
    runs["bnsd_ops"] = bnsd_ops(dev)
    for seq, batch_size in LONG:
        torch.cuda.empty_cache()
        runs[f"train_long_s{seq}"] = train_ernie(
            dev, smi, f"train_long_s{seq}", seq, (batch_size,), timed=5)

    rep = {"flash_attention_fwd": "B=1 S=2048 n=16 hd=64 causal",
           "int8_gemm": "M=8 K=1024 N=4096 bias=True act=relu",
           "flash_attention_bwd": f"B=40 S={SEQ} n=16 hd=64 bias "
                                  f"dropout={RATE} bf16",
           "fused_adamw": "[1024, 4096] bf16"}
    main_path = {"flash_attention_bwd": "train_ernie",
                 "fused_adamw": "train_ernie"}
    timing = ("shape", "ms", "plain_ms", "library_ms", "bound_ms",
              "bound_by", "max_abs_err")
    line = []
    for name in kernels.MODULES:
        rows = [r for r in results if r["name"] == name]
        main_row = next((r for r in rows if r["shape"] == rep.get(name)),
                        rows[0])
        line.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name],
            launches=runs[main_path.get(name, "serve_int8")][0][name],
            launches_by_path={p: c[0][name] for p, c in runs.items()},
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"], shape=main_row["shape"]))
        if name.startswith("flash"):
            # the same kernel at every timed shape (training, long context,
            # the bnsd rows), and each path's launches by layout
            line[-1]["variants"] = [{k_: r[k_] for k_ in timing}
                                    for r in rows if r["ms"] is not None
                                    and r is not main_row]
            line[-1]["launches_by_layout"] = {p: c[1][name]
                                              for p, c in runs.items()}
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
