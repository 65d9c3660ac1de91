"""Drive paddle_tpu_torch's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py

Needs a CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and the repo
checkout around this file; it builds the CUDA kernels itself. Each phase
prints one JSON line; any failure raises and the exit code is non-zero.

1. build     — nvcc builds every kernel of paddle_tpu_torch/csrc for sm_90a
               (one nvcc per source, in parallel); the card's name and
               power limit from nvidia-smi; ptxas's register and spill
               lines per source; the number of HGMMA (wgmma) instructions
               in the SASS of the two flash libraries (cuobjdump -sass),
               which must not be 0: their bf16 instances run on the
               tensor cores.
2. kernels   — each kernel against its plain PyTorch version on the card at
               the serving path's shapes: max abs/rel error, kernel ms
               (CUDA events over raw launches), plain ms, the one-call
               PyTorch yardstick where there is one (library_ms), and the
               least time the card could take (bound_ms, from bytes at
               3.35 TB/s and flops at 67 TFLOP/s for fp32 inputs, 989
               TFLOP/s, the dense bf16 tensor-core peak, for bf16 inputs).
               The training kernels at ERNIE-large's shapes: flash forward
               with dropout and flash backward (their keep masks read back
               bit for bit in bf16 and fp32), compared and timed at the
               step's own B = 40, S = 512 and compared at S = 128 and 200;
               AdamW; each in bf16 and fp32. A bf16 kernel is held against
               the plain version run in fp32 on the same values and rounded
               to bf16; beside it, how many elements of the plain version
               run on the bf16 values (rounding p and ds where the
               reference does) fall outside that tolerance.
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
               launches a step, every flash launch on the bf16 tensor-core
               instance; no NaN in any parameter. Its ms/step and
               tokens/s are smoke figures of a host-driven eager step.
The long-context and [B,H,S,D] slice adds, in the order they run:
   kernels  — check_flash_long: both flash kernels at the long step's
               shapes (packed, bias, dropout 0.1): bf16 B=4 S=2048 and B=2
               S=4096, fp32 B=4 S=2048, compared and timed. check_flash_bnsd:
               both in the [B,H,S,D] layout at the six bnsd TPU kernels'
               shapes (B=40 at S=512, 256, 128; Sq=512 Sk=256; causal; B=4
               S=2048; fp32), compared, the first four timed, and bit for
               bit equal to the packed layout on the same values.
7. train_parity_long — train_parity at seq 2048, batch 1, 2 layers, fp32,
               3 steps (position table widened to the sequence).
8. bnsd_ops  — a program with a 4-D layers.flash_attention ([40,16,512,64]
               bf16 q/k/v parameters, [B,1,1,S] key bias, dropout 0.1),
               append_backward, 3 Executor.run steps: one bnsd flash forward
               and one bnsd backward launch a step, both on the bf16
               tensor-core instance, finite gradients.
9. train_long_s2048, train_long_s4096 — train_ernie at the long-context
               benchmark rows (tools/bench_models.py bench_long_context):
               max_position_embeddings = seq, s2048 batch 4 with 307 masked
               predictions and s4096 batch 2 with 614, 1 warm-up + 5 timed
               steps; finite loss, the last timed loss below the warm-up's,
               24 / 24 / 398 launches a step.
The ResNet-50 slice adds, in the order they run:
   kernels  — check_layer_norm: the layer_norm kernel at ERNIE-large's LN
               rows [20480, 1024] bf16 and fp32 and the decoder LM's [1500,
               1024] fp32, timed with F.layer_norm as the library.
               check_conv: the conv_bn_relu kernel at the conv tool's shape
               (N=256, 14x14, 256 -> 256, NHWC bf16).
10. exp_conv — paddle_tpu_torch/tools/exp_conv.py: the conv kernel, the
               cuDNN route and the plain version, timed.
11. fused_ln_ops — a program with fused_layer_norm at [40, 512, 1024] bf16,
               append_backward, 3 steps: two layer_norm launches a step
               (the op and its grad op's recomputed forward); Y and the
               gradients equal those of the same program with layer_norm.
12. resnet_parity — a tiny ResNet-50 (one bottleneck a stage, 32x32, 10
               classes), batch 4, 3 Momentum steps, card against CPU from
               one state: losses within 1e-4 (fp32) and 1e-2 (bf16 AMP);
               parameters and running statistics after each step, the
               card starting it from the CPU's state, within the same
               times max(1, the tensor's largest magnitude).
13. train_resnet50 — ResNet-50 as tools/bench_models.py bench_resnet50
               trains it (224x224, batch 256, bf16 AMP, Momentum lr 0.1,
               fuse_bn_act_pass), not cut: 1 warm-up + 5 timed steps on one
               synthetic batch; finite losses, the last timed one below the
               warm-up's; 616 ops of 17 types. No hand-written kernel runs
               on this path (its convs are cuDNN's, as the reference's are
               XLA's): its launch counts are all 0.
14. check_conv_real_layer — the conv kernel on the input, filter and
               folded BN running statistics of res4b_c2 from that step,
               against the port's conv2d -> batch_norm(is_test) -> relu.
Then one line with every ported kernel: ``launches_by_path`` gives each
phase's own count (set to 0 just before the phase, read just after),
``launches_by_layout`` and ``launches_by_dtype`` the flash kernels'
split by layout and by dtype instance, and
``launches`` is serve_int8's for the serving kernels, train_ernie's
for the training kernels, fused_ln_ops's for layer_norm and exp_conv's
for conv_bn_relu; ``variants`` are the flash kernels' other timed
shapes. Then the card's name and power limit, and last
{"ok": true, "device": {...}}.

TF32 is switched off for matmuls and cuDNN convs: the fp32 projections
stay torch.matmul in full fp32, as the JAX package left them to XLA.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

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
    "layer_norm": "paddle_tpu/ops/pallas/layer_norm.py:21",
    "conv_bn_relu": "tools/exp_pallas_conv.py:31",
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
              (40, 512, 256, False, torch.bfloat16, True),
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


def sass_count(lib, opcode):
    """How many instructions of ``opcode`` the SASS of a built library
    holds (cuobjdump -sass, from the toolkit that built it)."""
    from paddle_tpu_torch.kernels import _build

    tool = str(Path(_build.nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return sum(opcode in ln for ln in sass.splitlines())


def outside_tol(got, ref, tol):
    """How many elements of got lie outside allclose(ref, **tol)."""
    got, ref = got.double(), ref.double()
    return int(((got - ref).abs() > tol["atol"] + tol["rtol"] * ref.abs())
               .sum())


def ptxas_by_kernel(log, marker):
    """{kernel<head_dim,dropout>: its ptxas register and spill lines} for
    the entry functions of a ptxas -v log whose name holds ``marker``."""
    import re

    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"([a-z_]+)ILi(\d+)ELb(\d)", ln)
            name = (f"{m.group(1)}<{m.group(2)},{m.group(3)}>"
                    if m and marker in m.group(1) else None)
        elif name and ("spill" in ln or "registers" in ln):
            out.setdefault(name, []).append(ln.strip())
    return out


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
# tensor-core kernels multiply bf16 inputs with fp32 accumulation and carry
# p, p * mask and ds * scale as bf16 hi + lo pairs (16 significant bits), so
# they are held against the plain versions run in fp32 on the same values
# and rounded to bf16 once: one bf16 ulp (2^-7 relative) plus 1e-3, about
# 2 % of a typical |out| or |dq| at S = 512 with N(0, 1) inputs. The plain
# versions on the bf16 values round those three to bf16 once, as the
# reference does; how many of their elements fall outside this tolerance
# is counted beside (reference_rounding_outside_tol). dbias is fp32 in
# both, |dbias| ~ 1.
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
    tol = TRAIN_TOL[dtype]
    outside = {"out": outside_tol(
        fa.plain_flash_fwd(q, k, v, n, scale, causal, bias, RATE, ATTN_SEED,
                           layout)[0], r_out, tol)}
    # both backwards start from the same saved (out, lse)
    got = fa.flash_bwd(q, k, v, r_out, r_lse, do, n, scale, causal, bias,
                       RATE, ATTN_SEED, layout)
    ref = fa.plain_flash_bwd(q32, k32, v32, r_out.float(), r_lse, do32, n,
                             scale, causal, bias, RATE, ATTN_SEED, layout)
    ref_rounded = fa.plain_flash_bwd(q, k, v, r_out, r_lse, do, n, scale,
                                     causal, bias, RATE, ATTN_SEED, layout)
    torch.cuda.synchronize()
    for name, a, r, rr in zip(("dq", "dk", "dv", "dbias"), got, ref,
                              ref_rounded):
        if r is None:
            continue
        if name == "dbias":
            tol = DBIAS_TOL
        else:
            tol, r = TRAIN_TOL[dtype], r.to(dtype)
            outside[name] = outside_tol(rr, r, tol)
        err[name] = errors(a, r)[0]
        if not torch.allclose(a.float(), r.float(), **tol):
            raise AssertionError(f"flash backward {what} {name}: "
                                 f"{errors(a, r)}")
    err["reference_rounding_outside_tol"] = outside
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
                   errors={k_: err[k_] for k_ in keys if k_ in err},
                   reference_rounding_outside_tol={
                       k_: n_ for k_, n_ in
                       err["reference_rounding_outside_tol"].items()
                       if k_ in keys})
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

    # the kernels' keep masks, read back exactly, in both dtypes. Forward:
    # q = 0 makes every probability 1/S, and v one-hot over a 64-key chunk
    # makes out[q, d] = keep(q, chunk + d) / ((1 - rate) S). Backward:
    # q = k = v = 0 and lse = log S make p = 1/S and ds = 0, and do
    # one-hot over a 64-row chunk makes dv[k, d] = keep(chunk + d, k) /
    # ((1 - rate) S).
    b, s = 2, SEQ
    want = rng.attn_keep(ATTN_SEED, RATE, b, n, s, s, dev)
    eye = torch.eye(hd, device=dev)[None, :, None]
    checked = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        zero = torch.zeros(b, s, n * hd, device=dev, dtype=dtype)
        lse = torch.full((b, n, s), float(np.log(s)), device=dev)
        for c in range(s // hd):
            chunk = torch.zeros(b, s, n, hd, device=dev, dtype=dtype)
            chunk[:, c * hd:(c + 1) * hd] = eye
            chunk = chunk.reshape(b, s, n * hd)
            out, _ = fa.packed_flash_fwd(zero, zero, chunk, n, 1.0, False,
                                         None, RATE, ATTN_SEED)
            got = out.reshape(b, s, n, hd).permute(0, 2, 1, 3) != 0
            if not torch.equal(got, want[..., c * hd:(c + 1) * hd]):
                raise AssertionError(f"flash forward {name}: the kernel's "
                                     f"dropout keep mask differs from the "
                                     f"plain mask")
            dv = fa.packed_flash_bwd(zero, zero, zero, zero, lse, chunk, n,
                                     1.0, False, None, RATE, ATTN_SEED)[2]
            got = dv.reshape(b, s, n, hd).permute(0, 2, 3, 1) != 0
            if not torch.equal(got, want[:, :, c * hd:(c + 1) * hd]):
                raise AssertionError(f"flash backward {name}: the kernel's "
                                     f"dropout keep mask differs from the "
                                     f"plain mask")
        checked[name] = {"forward": int(want.numel()),
                         "backward": int(want.numel())}
    return dict(mask_bits_checked=checked,
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
    dtypes = kernels.dtype_counts()
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
         flash_launches_by_layout=layouts, flash_launches_by_dtype=dtypes,
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
    # every flash launch of the step ran the bf16 tensor-core instance
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        if dtypes[name] != {"fp32_cuda_cores": 0,
                            "bf16_wgmma": counts[name]}:
            raise AssertionError(f"{phase}: {name} launches by instance "
                                 f"{dtypes[name]}")
    if not finite:
        raise AssertionError(f"{phase}: a parameter is not finite")
    return counts, layouts, dtypes


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
    dtypes = kernels.dtype_counts()
    losses = [float(r[0].reshape(-1)[0]) for r in runs]
    grads_ok = all(g.shape == (b, n, s, hd) and np.isfinite(
        g.astype(np.float32)).all() and np.abs(g.astype(np.float32)).max()
        > 0 for r in runs for g in r[1:])
    want = {"flash_attention_fwd": {"packed": 0, "bnsd": steps},
            "flash_attention_bwd": {"packed": 0, "bnsd": steps}}
    want_dtypes = {k_: {"fp32_cuda_cores": 0, "bf16_wgmma": steps}
                   for k_ in want}
    emit("bnsd_ops", shape=[b, n, s, hd], dtype="bfloat16", steps=steps,
         losses=losses, grads_finite_nonzero=grads_ok, seconds=seconds,
         launches=counts, launches_by_layout=layouts,
         launches_by_dtype=dtypes,
         ops=[o.type for o in main_prog.global_block().ops])
    if layouts != want or dtypes != want_dtypes or not grads_ok \
            or not np.isfinite(losses).all():
        raise AssertionError(f"bnsd_ops: launches {layouts} {dtypes}, "
                             f"losses {losses}, grads finite {grads_ok}")
    return counts, layouts, dtypes


# ---------------------------------------------------------------------------
# the ResNet-50 slice: the last two TPU kernels and the ResNet-50 step
# ---------------------------------------------------------------------------

# check_layer_norm: (rows, h, dtype) -- ERNIE-large's [40*512, 1024] rows in
# bf16 and fp32, and the decoder LM's 1500-token prefill in fp32
LN_CASES = ((SEQ * 40, 1024, torch.bfloat16),
            (SEQ * 40, 1024, torch.float32), (1500, 1024, torch.float32))
LN_OPS = (40, SEQ, 1024)          # fused_ln_ops: X [B, S, H] bf16
# a bf16 kernel against its plain version run in fp32 on the same values
# and rounded once: one bf16 ulp (2^-7 relative) + 1e-3
BF16_TOL = dict(rtol=2 ** -7, atol=1e-3)
RESNET_BATCH = 256                # tools/bench_models.py bench_resnet50
RES4_CONV = "res4b_c2"            # a 3x3 stride-1 256 -> 256 conv at 14x14


def check_layer_norm(dev, results):
    """The layer_norm kernel against its plain version at ERNIE-large's
    LN rows ([20480, 1024], bf16 and fp32) and the decoder LM's prefill
    ([1500, 1024] fp32), with scale and bias; timed with F.layer_norm as
    the library. Inputs are rotated through more than the 50 MB L2."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import layer_norm as ln

    for rows, h, dtype in LN_CASES:
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        g = torch.Generator(device=dev).manual_seed(rows + h)
        esz = torch.finfo(dtype).bits // 8
        reps = max(1, -(-(64 << 20) // (rows * h * esz)))
        xs = [(torch.randn(rows, h, device=dev, generator=g) * 2 + 0.5)
              .to(dtype) for _ in range(reps)]
        sc = torch.rand(h, device=dev, generator=g) + 0.5
        bi = torch.randn(h, device=dev, generator=g)
        y, mean, rstd = ln.layer_norm_fwd(xs[0], sc, bi, 1e-5)
        ry, rmean, rrstd = ln.plain_layer_norm(xs[0].float(), sc, bi, 1e-5)
        ry = ry.to(dtype)
        torch.cuda.synchronize()
        tol = BF16_TOL if dtype == torch.bfloat16 \
            else dict(rtol=1e-5, atol=1e-5)
        if not (torch.allclose(y.float(), ry.float(), **tol)
                and torch.allclose(mean, rmean, rtol=1e-5, atol=1e-5)
                and torch.allclose(rstd, rrstd, rtol=1e-5, atol=1e-5)):
            raise AssertionError(f"layer norm [{rows}, {h}] {name}: "
                                 f"{errors(y, ry)} {errors(rstd, rrstd)}")
        err = max(errors(y, ry)[0], errors(mean, rmean)[0],
                  errors(rstd, rrstd)[0])
        ms = events_ms(lambda i: ln.layer_norm_fwd(xs[i % reps], sc, bi,
                                                   1e-5), 30)
        plain = events_ms(lambda i: ln.plain_layer_norm(xs[i % reps], sc, bi,
                                                        1e-5), 10)
        library = events_ms(lambda i: F.layer_norm(
            xs[i % reps], (h,), sc.to(dtype), bi.to(dtype), 1e-5), 30)
        bms, by = bound_ms(2 * rows * h * esz + 2 * h * 4 + 2 * rows * 4,
                           8 * rows * h, FP32_FLOPS_PER_S)
        results.append(dict(name="layer_norm", shape=f"[{rows}, {h}] {name}",
                            max_abs_err=err, max_rel_err=None, ms=ms,
                            plain_ms=plain, library_ms=library, bound_ms=bms,
                            bound_by=by))
        del xs
    torch.cuda.empty_cache()


def check_conv(dev, results):
    """The conv_bn_relu kernel against its plain version (the 9 products
    of the bf16 values summed in fp32, the epilogue in fp32, rounded
    once) at the tool's shape: N = 256, 14x14, 256 -> 256, NHWC bf16.
    Timed in the exp_conv phase."""
    from paddle_tpu_torch.kernels import conv_bn_relu as cbr
    from paddle_tpu_torch.tools import exp_conv

    _, xp, w, scale, shift = exp_conv.make_inputs(256, dev, seed=0)
    out = cbr.conv_bn_relu(xp, w, scale, shift)
    ref = cbr.plain_conv_bn_relu(xp, w, scale, shift)
    torch.cuda.synchronize()
    if not torch.allclose(out.float(), ref.float(), **BF16_TOL):
        raise AssertionError(f"conv_bn_relu N=256: {errors(out, ref)}")
    flops = 2.0 * 256 * 14 * 14 * 256 * 9 * 256
    bms, by = bound_ms(xp.numel() * 2 + w.numel() * 2 + out.numel() * 2
                       + 2 * 256 * 4, flops, BF16_FLOPS_PER_S)
    results.append(dict(name="conv_bn_relu",
                        shape="N=256 H=W=14 C=256 Co=256 3x3 NHWC bf16",
                        max_abs_err=errors(out, ref)[0],
                        max_rel_err=errors(out, ref)[1], ms=None,
                        plain_ms=None, library_ms=None, bound_ms=bms,
                        bound_by=by, relu_kept_share=float(
                            (ref.float() > 0).float().mean())))


def exp_conv_phase(dev, results):
    """tools/exp_conv.py's three timings at its shape: the kernel, the
    cuDNN route and the plain version; their times go into the
    conv_bn_relu row of the kernels line. Launch counts: this phase's."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.tools import exp_conv

    kernels.reset_launch_counts()
    out = exp_conv.run(dev, batch=256, reps=20)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    emit("exp_conv", launches=counts["conv_bn_relu"], **out)
    row = next(r for r in results if r["name"] == "conv_bn_relu")
    row.update(ms=out["kernel_ms"], plain_ms=out["plain_ms"],
               library_ms=out["library_ms"])
    if counts["conv_bn_relu"] == 0:
        raise AssertionError("exp_conv: the conv kernel never launched")
    return counts, kernels.layout_counts()


def _ln_program(op_type):
    """[40, 512, 1024] bf16 X (a parameter), fp32 Scale and Bias, the
    normalisation over the last axis by ``op_type`` (fused_layer_norm, or
    layer_norm at begin_norm_axis 2), loss = sum(y * c) with c a fed bf16
    tensor, append_backward. The loss's cotangent on Y is c itself, the
    same in both programs whatever Y's rounding."""
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.backward import append_backward
    from paddle_tpu_torch.core.ir import Program, program_guard
    from paddle_tpu_torch.initializer import Normal, TruncatedNormal
    from paddle_tpu_torch.layer_helper import LayerHelper
    from paddle_tpu_torch.param_attr import ParamAttr

    b, s, h = LN_OPS
    main_prog, startup = Program(), Program()
    with unique_name.guard(), program_guard(main_prog, startup):
        x = layers.create_parameter([b, s, h], "bfloat16", name="ln_x",
                                    default_initializer=TruncatedNormal(
                                        0.5, 2.0))
        sattr = ParamAttr(name="ln_scale", initializer=Normal(1.0, 0.2))
        battr = ParamAttr(name="ln_bias", initializer=Normal(0.0, 0.2))
        if op_type == "layer_norm":
            y = layers.layer_norm(x, begin_norm_axis=2, param_attr=sattr,
                                  bias_attr=battr)
        else:
            helper = LayerHelper("fused_layer_norm")
            sc = helper.create_parameter(sattr, [h], "float32")
            bi = helper.create_parameter(battr, [h], "float32", is_bias=True)
            y = helper.create_variable_for_type_inference("bfloat16")
            mean = helper.create_variable_for_type_inference("float32", True)
            var = helper.create_variable_for_type_inference("float32", True)
            helper.append_op("fused_layer_norm",
                             {"X": [x], "Scale": [sc], "Bias": [bi]},
                             {"Y": [y], "Mean": [mean], "Variance": [var]},
                             {"epsilon": 1e-5})
        c = layers.static_data("ln_c", [b, s, h], "bfloat16")
        loss = layers.reduce_sum(layers.elementwise_mul(y, c))
        append_backward(loss)
    return main_prog, startup, [loss.name, y.name, "ln_x@GRAD",
                                "ln_scale@GRAD", "ln_bias@GRAD"]


def fused_ln_ops(dev):
    """The fused_layer_norm op through the program path: [40, 512, 1024]
    bf16, append_backward, 3 Executor.run steps on the card. Two layer_norm
    kernel launches a step: the op's, and the one in its grad op, whose
    ``__vjp_grad__`` re-runs the forward lowering (as the reference's
    default grad maker does) to get mean and rstd. Y and the gradients of
    X, Scale and Bias equal
    those of the same program with layer_norm (begin_norm_axis 2, torch's
    own layer norm) from one state: Y and dX within the bf16 tolerance,
    dScale and dBias (fp32 sums over 20480 rows of bf16 cotangents) within
    2^-7 relative + 1e-3 of their largest magnitude."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope

    steps = 3
    fused, startup, fetch = _ln_program("fused_layer_norm")
    plain, _, pfetch = _ln_program("layer_norm")
    exe = Executor(device=dev)
    scope = Scope()
    exe.run(startup, scope=scope)
    twin = Scope()
    for n, v in scope.items():
        twin.set(n, v.clone() if isinstance(v, torch.Tensor) else v)
    g = torch.Generator(device=dev).manual_seed(6)
    feed = {"ln_c": torch.randn(LN_OPS, device=dev, generator=g)
            .to(torch.bfloat16)}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = [exe.run(fused, feed=feed, fetch_list=fetch, scope=scope,
                   return_numpy=False) for _ in range(steps)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = [exe.run(plain, feed=feed, fetch_list=pfetch, scope=twin,
                    return_numpy=False) for _ in range(steps)]
    torch.cuda.synchronize()
    err, ok = {}, True
    for g_run, w_run in zip(got, want):
        for name, g, w in zip(("Y", "dX", "dScale", "dBias"), g_run[1:],
                              w_run[1:]):
            g, w = g.float(), w.float()
            if name in ("Y", "dX"):
                close = torch.allclose(g, w, **BF16_TOL)
            else:
                close = float((g - w).abs().max()) <= \
                    2 ** -7 * float(w.abs().max()) + 1e-3
            ok = ok and close and bool(torch.isfinite(g).all())
            err[name] = max(err.get(name, 0.0), float((g - w).abs().max()))
    emit("fused_ln_ops", shape=list(LN_OPS), dtype="bfloat16", steps=steps,
         seconds=seconds, launches=counts, max_abs_err_vs_layer_norm=err,
         losses=[float(r[0].float().reshape(-1)[0]) for r in got],
         ops=[o.type for o in fused.global_block().ops], ok=ok)
    if counts["layer_norm"] != 2 * steps or not ok:
        raise AssertionError(f"fused_ln_ops: launches {counts}, errors {err}")
    return counts, kernels.layout_counts()


def _resnet_programs(cfg, batch_size, amp, lr=0.1):
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.models import resnet

    with unique_name.guard():
        return resnet.build_classifier_program(cfg, batch_size=batch_size,
                                               amp=amp, lr=lr)


def resnet_parity(dev, amp, tol, steps=3):
    """A tiny ResNet-50 (every stage's bottleneck once, 32x32 images, 10
    classes), batch 4, Momentum lr 0.01: ``steps`` steps on the card and
    on the CPU from one state and one batch, losses within rtol = atol =
    ``tol``. Then every parameter and running statistic after each step,
    the card starting that step from the CPU's state: batch norm over 4
    images amplifies the order of fp32 sums (cuDNN's against the CPU's),
    so two free runs drift apart over steps however right each step is.
    Each tensor within tol * max(1, max |CPU's|). The velocities, each
    step's raw gradient, are not held here: near a loss of 1e-2 the
    gradient through batch norm over 4 values cancels to a few 1e-4 of
    the velocity's scale on the card as on the CPU (tests/test_torch_resnet
    holds them against the reference from one state)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope, scope_from_numpy
    from paddle_tpu_torch.models import resnet

    t0 = time.perf_counter()
    cfg = resnet.ResNetConfig(50, 10, (3, 32, 32), stages=[1, 1, 1, 1])
    main_prog, startup, _, fetches = _resnet_programs(cfg, 4, amp, lr=0.01)
    scope = Scope()
    Executor(device="cpu").run(startup, scope=scope)
    state = _state_arrays(scope)
    batch = resnet.synthetic_batch(cfg, 4, seed=1)
    fetch = [fetches["loss"], fetches["acc1"]]
    names = [v.name for v in main_prog.global_block().vars.values()
             if v.persistable and not v.name.endswith("_velocity_0")]
    card, cpu = Executor(device=dev), Executor(device="cpu")
    free_card, free_cpu = (scope_from_numpy(state, d) for d in (dev, "cpu"))
    kernels.reset_launch_counts()
    losses, worst, bad = [], {}, []
    for step in range(steps):
        # a copy: the optimizer ops update the CPU tensors in place
        before = scope_from_numpy(_state_arrays(free_cpu), "cpu")
        want = cpu.run(main_prog, feed=batch, scope=free_cpu,
                       fetch_list=fetch)
        got = card.run(main_prog, feed=batch, scope=free_card,
                       fetch_list=fetch)
        losses.append((float(got[0].reshape(-1)[0]),
                       float(want[0].reshape(-1)[0])))
        synced = scope_from_numpy(_state_arrays(before), dev)
        card.run(main_prog, feed=batch, scope=synced, fetch_list=fetch)
        for n in names:
            ref = free_cpu.find_var(n).float()
            err = float((synced.find_var(n).float().cpu() - ref).abs().max())
            worst[n] = max(worst.get(n, 0.0), err)
            if err > tol * max(1.0, float(ref.abs().max())):
                bad.append(f"step {step} {n}: {err}")
    counts = kernels.launch_counts()
    loss_gpu, loss_cpu = ([p[i] for p in losses] for i in (0, 1))
    ok = np.allclose(loss_gpu, loss_cpu, rtol=tol, atol=tol) and not bad
    top = sorted(worst, key=lambda n: -worst[n])[:3]
    emit("resnet_parity", amp=amp, batch=4, steps=steps,
         seconds=time.perf_counter() - t0, loss_gpu=loss_gpu,
         loss_cpu=loss_cpu, state_vars=len(names),
         largest_state_errors={n: worst[n] for n in top},
         outside_tolerance=bad[:10], tolerance=f"{tol}", launches=counts,
         ok=bool(ok))
    if not ok:
        raise AssertionError("resnet: card and CPU disagree")


def train_resnet50(dev, smi, timed=5):
    """ResNet-50 as the reference's benchmark trains it: 224x224, batch
    256, bf16 AMP, Momentum lr 0.1, fuse_bn_act_pass; not cut. Startup on
    the card, one warm-up step and ``timed`` timed steps on one synthetic
    batch; then one more step fetching the input of RES4_CONV for the
    real-layer conv check. Finite losses, the last timed one below the
    warm-up's. No hand-written kernel is on this path: the reference runs
    its convs through XLA, the port through cuDNN."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.models import resnet

    cfg = resnet.resnet50()
    t0 = time.perf_counter()
    main_prog, startup, _, fetches = _resnet_programs(cfg, RESNET_BATCH,
                                                      amp=True)
    build_s = time.perf_counter() - t0
    ops = main_prog.global_block().ops
    exe = Executor(device=dev)
    scope = Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    batch = resnet.synthetic_batch(cfg, RESNET_BATCH, seed=0)
    feed = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    fetch = [fetches["loss"], fetches["acc1"]]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = exe.run(main_prog, feed=feed, scope=scope, fetch_list=fetch)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    losses, acc1, step_ms = [float(warm[0].reshape(-1)[0])], \
        [float(warm[1].reshape(-1)[0])], []
    for _ in range(timed):
        t0 = time.perf_counter()
        out = exe.run(main_prog, feed=feed, scope=scope, fetch_list=fetch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out[0].reshape(-1)[0]))
        acc1.append(float(out[1].reshape(-1)[0]))
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    conv_op = next(o for o in ops if o.type == "conv2d" and
                   o.inputs["Filter"][0].startswith(RES4_CONV + "_w"))
    layer_in = exe.run(main_prog, feed=feed, scope=scope,
                       fetch_list=[conv_op.inputs["Input"][0]],
                       return_numpy=False)[0]
    params = [scope.find_var(p.name) for p in main_prog.all_parameters()]
    finite = all(bool(torch.isfinite(p.float()).all()) for p in params)
    p50 = float(np.median(step_ms))
    types = {}
    for o in ops:
        types[o.type] = types.get(o.type, 0) + 1
    emit("train_resnet50", model="resnet50", image=list(cfg.image_shape),
         batch=RESNET_BATCH, amp="bf16", optimizer="momentum lr 0.1 mu 0.9",
         fuse_bn_act=True, ops=len(ops), op_types=len(types),
         op_counts=types, startup_ops=len(startup.global_block().ops),
         parameters=len(params),
         parameter_elements=int(sum(p.numel() for p in params)),
         build_s=build_s, startup_s=startup_s, warmup_s=warm_s,
         warmup_loss=losses[0], losses=losses[1:], acc1=acc1,
         step_ms=step_ms, step_ms_p50=p50,
         step_ms_range=[min(step_ms), max(step_ms)],
         images_per_s=RESNET_BATCH / (p50 / 1e3),
         max_memory_allocated=peak, launches=counts,
         params_finite=finite, nvidia_smi=smi,
         note="smoke figures of a host-driven eager step, not a benchmark")
    if not all(np.isfinite(losses)) or not losses[timed] < losses[0]:
        raise AssertionError(f"train_resnet50: loss did not fall: {losses}")
    if not finite:
        raise AssertionError("train_resnet50: a parameter is not finite")
    if len(ops) != 616 or len(types) != 17:
        raise AssertionError(f"train_resnet50: {len(ops)} ops of "
                             f"{len(types)} types")
    return (counts, kernels.layout_counts()), scope, layer_in


def check_conv_real_layer(dev, scope, layer_in):
    """The conv kernel at the shape and on the values of a real layer:
    the input of RES4_CONV from the ResNet-50 step (bf16 NCHW [256, 256,
    14, 14]), its filter in bf16, its BN running statistics folded into
    scale = bn_scale / sqrt(var + eps) and shift = bn_bias - mean *
    scale. Held against the port's own conv2d -> batch_norm(is_test) ->
    relu lowerings on the same values, (a) run in fp32 and rounded once:
    the bf16 tolerance; (b) run as the AMP program runs them, in bf16:
    within the sum of their roundings, 2^-6 (|a| (|conv| + |mean|) +
    |bias|) + 2^-7 |out| + 1e-3 elementwise, a = bn_scale / sqrt(var +
    eps) (four roundings of at most 2^-9 relative each, doubled)."""
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.kernels import conv_bn_relu as cbr

    name = RES4_CONV
    w = scope.find_var(name + "_w")
    gamma, beta = scope.find_var(name + "_bn_scale"), \
        scope.find_var(name + "_bn_bias")
    mean, var = scope.find_var(name + "_bn_mean"), \
        scope.find_var(name + "_bn_var")
    x = layer_in.to(torch.bfloat16)
    wb = w.to(torch.bfloat16)
    a = gamma / torch.sqrt(var + 1e-5)
    shift = beta - mean * a
    xp = torch.nn.functional.pad(x.permute(0, 2, 3, 1), (0, 0, 1, 1, 1, 1)) \
        .contiguous()
    got = cbr.conv_bn_relu(xp, wb.permute(2, 3, 1, 0).contiguous(),
                           a.contiguous(), shift.contiguous())
    got = got.permute(0, 3, 1, 2)

    def chain(xx, ww):
        conv = registry.get("conv2d").forward(
            {"Input": [xx], "Filter": [ww]},
            {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
             "groups": 1})["Output"]
        bn = registry.get("batch_norm").forward(
            {"X": [conv], "Scale": [gamma], "Bias": [beta], "Mean": [mean],
             "Variance": [var]}, {"is_test": True, "epsilon": 1e-5})["Y"]
        return conv, registry.get("relu").forward({"X": [bn]}, {})["Out"]

    with torch.no_grad():
        conv32, ref32 = chain(x.float(), wb.float())
        _, ref16 = chain(x, wb)
    torch.cuda.synchronize()
    ok32 = torch.allclose(got.float(), ref32.to(torch.bfloat16).float(),
                          **BF16_TOL)
    bshape = (1, -1, 1, 1)
    bound = 2 ** -6 * (a.abs().reshape(bshape) * (
        conv32.abs() + mean.abs().reshape(bshape))
        + beta.abs().reshape(bshape)) + 2 ** -7 * ref32.abs() + 1e-3
    diff16 = (got.float() - ref16.float()).abs()
    ok16 = bool((diff16 <= bound).all())
    emit("check_conv_real_layer", layer=name, input_shape=list(x.shape),
         max_abs_err_vs_fp32_ops=errors(got, ref32.to(torch.bfloat16))[0],
         max_abs_err_vs_bf16_ops=float(diff16.max()),
         worst_share_of_bf16_bound=float((diff16 / bound).max()),
         relu_kept_share=float((ref32 > 0).float().mean()),
         ok=bool(ok32 and ok16))
    if not (ok32 and ok16):
        raise AssertionError(f"conv kernel on {name}: fp32 ops {ok32}, "
                             f"bf16 ops {ok16}")


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
    flash = ("flash_attention_fwd", "flash_attention_bwd")
    hgmma = {n: sass_count(_build.lib_path(n), "HGMMA") for n in flash}
    tc_ptxas = {n: ptxas_by_kernel((_build.BUILD_DIR / f"{n}.ptxas.txt")
                                   .read_text(), "_tc") for n in flash}
    emit("build", seconds=build_s, per_source_s=per_source, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), ptxas=ptxas,
         hgmma_instructions=hgmma, tensor_core_kernels_ptxas=tc_ptxas)
    if not all(hgmma.values()):
        raise AssertionError(f"build: a flash library has no HGMMA "
                             f"instruction: {hgmma}")

    results = []
    check_flash(dev, results)
    check_paged(dev, results)
    check_int8(dev, results)
    mask_check = check_flash_train(dev, results)
    check_flash_long(dev, results)
    bnsd_check = check_flash_bnsd(dev, results)
    check_adamw(dev, results)
    check_layer_norm(dev, results)
    check_conv(dev, results)
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
    torch.cuda.empty_cache()
    runs["exp_conv"] = exp_conv_phase(dev, results)
    runs["fused_ln_ops"] = fused_ln_ops(dev)
    resnet_parity(dev, False, 1e-4)
    resnet_parity(dev, True, 1e-2)
    torch.cuda.empty_cache()
    runs["train_resnet50"], scope, layer_in = train_resnet50(dev, smi)
    check_conv_real_layer(dev, scope, layer_in)
    del scope, layer_in

    rep = {"flash_attention_fwd": "B=1 S=2048 n=16 hd=64 causal",
           "int8_gemm": "M=8 K=1024 N=4096 bias=True act=relu",
           "flash_attention_bwd": f"B=40 S={SEQ} n=16 hd=64 bias "
                                  f"dropout={RATE} bf16",
           "fused_adamw": "[1024, 4096] bf16",
           "layer_norm": "[20480, 1024] bf16"}
    main_path = {"flash_attention_bwd": "train_ernie",
                 "fused_adamw": "train_ernie", "layer_norm": "fused_ln_ops",
                 "conv_bn_relu": "exp_conv"}
    timing = ("shape", "ms", "plain_ms", "library_ms", "bound_ms",
              "bound_by", "max_abs_err")
    line = []
    for name in kernels.MODULES:
        rows = [r for r in results if r["name"] == name]
        main_row = next((r for r in rows if r["shape"] == rep.get(name)),
                        rows[0])
        path = main_path.get(name, "serve_int8")
        line.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], path=path, launches=runs[path][0][name],
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
            line[-1]["launches_by_dtype"] = {p: c[2][name]
                                             for p, c in runs.items()
                                             if len(c) > 2}
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
