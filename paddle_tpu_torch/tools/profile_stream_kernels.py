"""The paged-attention and AdamW kernels on the device alone, built as
they are and with one design choice changed at a time.

    python -m paddle_tpu_torch.tools.profile_stream_kernels

Builds ``csrc/paged_attention.cu`` and ``csrc/fused_adamw.cu`` several
ways from copies of ``csrc/`` (under ``build/torch_kernels/ablation/``,
one nvcc per build, all at once; ``profile_tc_pace.build_variants``) and
times each on the device alone (the same calls captured in a CUDA graph
and replayed, ``profile_layer_norm.graph_ms``):

* paged attention, ``chunk128`` (the source as it is), ``chunk256`` and
  ``chunk512``: the context chunk a block takes; ``unroll16``: 16 tokens
  a lane group in flight, not 8; ``threads256``: blocks of 256 threads,
  not 128 (twice the lane groups a chunk). At chip_smoke's shape
  (8 rows at pos 0, 5, 100, 517, 1023, 1500, 2047, 300), at
  ``profile_decode``'s step (8 rows at pos 512), and over the serving
  traffic of chip_smoke's serve phases (``serve``: each decode step's
  slot positions as ``profile_decode.serve`` records them from the
  engine, fp32 weights, one call a step in order); n = 16, hd = 64,
  P = 16, MP = 128, fp32 pools rotated through more than the 50 MB L2.
  The device ms is a call's (one layer's); a decode step makes 12.
* AdamW, ``base`` (the source as it is: evict-first 16-byte loads and
  stores, one vector a thread, a block for every 256 vectors, the beta
  powers advanced in the launch, as the ``adamw`` op calls it);
  ``no_hints``: plain loads and stores; ``unroll2`` and ``unroll4``: 2 or 4
  vectors a thread, all loaded before any is used (the body patched in);
  ``persistent``: the grid capped at 4 blocks an SM of the 132, striding
  over the rest; ``scalar``: the base build with every element through
  its scalar loop (the split's head = n). At fp32 [18000, 1024], bf16
  [18000, 1024] and bf16 [1024, 4096], four copies of the state rotated
  (more than the L2), beside ``torch._fused_adamw_`` at fp32; and
  ERNIE-large's 398 parameters (``profile_train``'s s512 program), one
  launch each, as a training step makes them, by variant, and
  ``powers_apart``: the update with the power write cut out, then the
  two multiplies an op made before the powers were folded in.

Each row carries its bound (each input read once, each output written
once, at 3.35 TB/s) and, for the wrappers as the main path calls them
(paged attention at chip_smoke's shape; AdamW at bf16 [1024, 4096]),
``host_us``: the host's microseconds a call. Prints one JSON line per
shape, then the card's name and power limit. Needs one CUDA card and
nvcc; exits non-zero without them.
"""

from __future__ import annotations

import ctypes
import json
import sys

import torch

PAGED_CHUNK = "constexpr int CHUNK = 128;"
# paged variant -> (its edits, its chunk)
PAGED = {f"chunk{c}": ([(PAGED_CHUNK, PAGED_CHUNK.replace("128", str(c)))],
                       c) for c in (128, 256, 512)}
PAGED["unroll16"] = ([("constexpr int UNROLL = 8;",
                       "constexpr int UNROLL = 16;")], 128)
PAGED["threads256"] = ([("constexpr int THREADS = 128;",
                         "constexpr int THREADS = 256;")], 128)
ADAMW_GRID = "  if (blocks < 1) blocks = 1;"
# the AdamW body's loads of one vector, and in their place U vectors a
# thread, all loaded before the first is used
ADAMW_LOADS = """  for (long long k = tid; k < nvec; k += nthreads) {
    uint4 wp = ld16(pw + k), wg = ld16(gw + k), wm[V::MW], wv[V::MW];
#pragma unroll
    for (int j = 0; j < V::MW; ++j) {
      wm[j] = ld16(mw + k * V::MW + j);
      wv[j] = ld16(vw + k * V::MW + j);
    }
"""
ADAMW_LOADS_U = """  for (long long k0 = (long long)blockIdx.x * THREADS * {U} + threadIdx.x;
       k0 < nvec; k0 += nthreads * {U}) {
    uint4 up[{U}], ug[{U}], um[{U}][V::MW], uv[{U}][V::MW];
#pragma unroll
    for (int u = 0; u < {U}; ++u) {
      const long long k = k0 + (long long)u * THREADS;
      if (k < nvec) {
        up[u] = ld16(pw + k);
        ug[u] = ld16(gw + k);
#pragma unroll
        for (int j = 0; j < V::MW; ++j) {
          um[u][j] = ld16(mw + k * V::MW + j);
          uv[u][j] = ld16(vw + k * V::MW + j);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < {U}; ++u) {
    const long long k = k0 + (long long)u * THREADS;
    if (k >= nvec) break;
    uint4 wp = up[u], wg = ug[u], wm[V::MW], wv[V::MW];
#pragma unroll
    for (int j = 0; j < V::MW; ++j) {
      wm[j] = um[u][j];
      wv[j] = uv[u][j];
    }
"""
ADAMW_BODY_END = "    }\n  }\n  // the powers"
ADAMW_BLOCKS = "  long long blocks = (nvec + THREADS - 1) / THREADS;"


def _unroll(u):
    return [(ADAMW_LOADS, ADAMW_LOADS_U.replace("{U}", str(u))),
            (ADAMW_BODY_END, "    }\n    }\n  }\n  // the powers"),
            (ADAMW_BLOCKS, ADAMW_BLOCKS.replace(
                "(nvec + THREADS - 1) / THREADS",
                f"(nvec + THREADS * {u} - 1) / (THREADS * {u})"))]


SOURCES = {
    "paged_attention": {var: edits for var, (edits, _) in PAGED.items()},
    "fused_adamw": {
        "base": [],
        "no_hints": [("{ return __ldcs(p); }", "{ return *p; }"),
                     ("{ __stcs(p, v); }", "{ *p = v; }")],
        "unroll2": _unroll(2),
        "unroll4": _unroll(4),
        "persistent": [(ADAMW_GRID, ADAMW_GRID + "\n  if (blocks > 132 * 4) "
                                    "blocks = 132 * 4;")],
        "powers_apart": [("  __syncthreads();\n  if (threadIdx.x != 0) "
                          "return;\n", "  return;\n")],
    },
}
PAGED_CASES = {"chip_smoke": [[0, 5, 100, 517, 1023, 1500, 2047, 300]],
               "profile_decode": [[512] * 8]}
ADAMW_CASES = (((18000, 1024), torch.float32), ((18000, 1024), torch.bfloat16),
               ((1024, 4096), torch.bfloat16))
HBM = 3.35e12


def _stream():
    return torch.cuda.current_stream().cuda_stream


def serve_positions():
    """Each decode step's slot positions over the serve phases' traffic,
    from the engine (``profile_decode.serve``, fp32 weights)."""
    from ..models.decoder_lm import DecoderLMConfig, decoder_lm_params
    from .profile_decode import FULL, serve

    cfg = DecoderLMConfig(**FULL)
    out = serve("none", cfg, decoder_lm_params(cfg, seed=0))["positions"]
    torch.cuda.empty_cache()
    return out


def paged(libs, dev, graph_ms, host_us, cases):
    """Each case is a list of steps, each the rows' positions: the calls
    go through the steps in order, the pools rotated."""
    from ..kernels import paged_attention as pa

    n, hd, page, mp = 16, 64, 16, 128
    kvdim = n * hd
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for case, steps in cases.items():
        b = len(steps[0])
        g = torch.Generator(device=dev).manual_seed(1)
        # slot i holds pages 1 + i * per .. for its longest context
        per = max(p for st in steps for p in st) // page + 1
        copies = [tuple(torch.randn(1 + b * per, page, kvdim, device=dev,
                                    generator=g) for _ in range(2))
                  for _ in range(3)]
        table = (1 + torch.arange(b * per, dtype=torch.int32)
                 .reshape(b, per))
        table = torch.nn.functional.pad(table, (0, mp - per)).to(dev)
        pos = [torch.tensor(st, dtype=torch.int32, device=dev)
               for st in steps]
        q = torch.randn(b, kvdim, device=dev, generator=g)
        out = torch.empty(b, kvdim, device=dev)
        ctx = sum(p + 1 for st in steps for p in st) / len(steps)
        nbytes = 2 * ctx * kvdim * 4 + 2 * b * kvdim * 4 + b * mp * 4 + b * 4
        row = dict(kernel="paged_attention", case=case, steps=len(steps),
                   bound_ms=nbytes / HBM * 1e3)
        if len(steps) == 1:
            row["pos"] = steps[0]
        reps = max(30, len(steps))
        for var, (_, chunk) in PAGED.items():
            fn = libs["paged_attention", var].pt_paged_attention
            fn.argtypes = [vp] * 8 + [ci] * 6 + [ctypes.c_float, vp]
            part = torch.empty(b * n * -(-mp * page // chunk) * (hd + 2),
                               device=dev)
            tickets = torch.zeros(b * n, dtype=torch.int32, device=dev)

            def call(i, fn=fn, part=part, tickets=tickets):
                pk, pv = copies[i % 3]
                return fn(q.data_ptr(), pk.data_ptr(), pv.data_ptr(),
                          table.data_ptr(), pos[i % len(pos)].data_ptr(),
                          out.data_ptr(), part.data_ptr(), tickets.data_ptr(),
                          b, n, hd, page, mp, kvdim, hd ** -0.5, _stream())

            err = 0.0
            for i in range(len(steps)):
                if call(i) != 0:
                    raise RuntimeError(f"paged {var} launch failed")
                want = pa.plain_paged_attention(q, *copies[i % 3], table,
                                                pos[i], n, hd, hd ** -0.5)
                err = max(err, float((out - want).abs().max()))
            torch.cuda.synchronize()
            row[f"{var}_max_abs_err"] = err
            row[f"{var}_device_ms"] = graph_ms(call, reps)
        if case == "chip_smoke":
            row["wrapper_host_us"] = host_us(
                lambda i: pa.paged_decode_attention(
                    q, *copies[i % 3], table, pos[0], n, hd, hd ** -0.5))
        print(json.dumps(row), flush=True)
        del copies


def _adamw_args():
    vp, cf, ll = ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong
    return [vp] * 8 + [ll] * 3 + [cf] * 6 + [ctypes.c_int, vp]


def adamw(libs, dev, graph_ms, host_us):
    from ..kernels import fused_adam as fad

    lr = torch.tensor([1e-4], device=dev)
    for shape, dtype in ADAMW_CASES:
        g = torch.Generator(device=dev).manual_seed(shape[0])
        reps = 4
        ps = [(torch.randn(shape, device=dev, generator=g) * 0.02).to(dtype)
              for _ in range(reps)]
        gr = (torch.randn(shape, device=dev, generator=g) * 1e-2).to(dtype)
        ms_ = [torch.randn(shape, device=dev, generator=g) * 1e-3
               for _ in range(reps)]
        vs = [torch.rand(shape, device=dev, generator=g) * 1e-5
              for _ in range(reps)]
        numel, esz = gr.numel(), gr.element_size()
        row = dict(kernel="fused_adamw", shape=list(shape), dtype=str(dtype),
                   bound_ms=numel * (3 * esz + 16) / HBM * 1e3)
        head, nvec = fad.split(numel, esz, fad.VEC[dtype], ps[0].data_ptr(),
                               gr.data_ptr(), ms_[0].data_ptr(),
                               vs[0].data_ptr())
        ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        pows = [torch.tensor([x], device=dev) for x in (0.9, 0.999)]
        runs = [(var, var, head, nvec) for var in SOURCES["fused_adamw"]
                if var != "powers_apart"]
        runs.append(("scalar", "base", numel, 0))
        for name, var, hd_, nv in runs:
            fn = libs["fused_adamw", var].pt_fused_adamw
            fn.argtypes = _adamw_args()

            def call(i, fn=fn, hd_=hd_, nv=nv):
                k = i % reps
                return fn(ps[k].data_ptr(), gr.data_ptr(), ms_[k].data_ptr(),
                          vs[k].data_ptr(), lr.data_ptr(), pows[0].data_ptr(),
                          pows[1].data_ptr(), ticket.data_ptr(), numel, hd_,
                          nv, 0.9, 0.1, 0.999, 1.0 - 0.999, 1e-8, 0.01,
                          fad.DTYPES[dtype], _stream())

            if call(0) != 0:
                raise RuntimeError(f"AdamW {name} launch failed")
            row[f"{name}_device_ms"] = graph_ms(call, 20)
        if dtype == torch.float32:
            steps = [torch.tensor(3.0, device=dev) for _ in range(reps)]

            def lib_call(i):
                k = i % reps
                return torch._fused_adamw_(
                    [ps[k]], [gr], [ms_[k]], [vs[k]], [], [steps[k]],
                    lr=1e-4, beta1=0.9, beta2=0.999, weight_decay=0.01,
                    eps=1e-8, amsgrad=False, maximize=False)

            row["library_device_ms"] = graph_ms(lib_call, 20)
        if shape == (1024, 4096):
            row["wrapper_host_us"] = host_us(
                lambda i: fad.fused_adamw_(ps[i % reps], gr, ms_[i % reps],
                                           vs[i % reps], lr, 0.9, 0.999,
                                           1e-8, 0.01, *pows))
        print(json.dumps(row), flush=True)
        del ps, ms_, vs


def adamw_ernie_step(libs, dev, graph_ms):
    """Every parameter of ERNIE-large (the 398 of ``profile_train``'s s512
    program, bf16 but for the fp32 ones it declares) updated once with its
    beta powers advanced, as a training step's adamw ops launch them: the
    device ms of the 398 launches, by variant."""
    from ..kernels import fused_adam as fad
    from .profile_train import _ernie

    block = _ernie(512)[0].global_block()
    params = []
    for op in block.ops:
        if op.type != "adamw":
            continue
        var = block.var(op.inputs["Param"][0])
        dtype = getattr(torch, str(var.dtype).replace("torch.", ""))
        shape = tuple(var.shape)
        params.append((torch.zeros(shape, dtype=dtype, device=dev),
                       torch.full(shape, 1e-3, dtype=dtype, device=dev),
                       torch.zeros(shape, device=dev),
                       torch.zeros(shape, device=dev),
                       torch.tensor([0.9], device=dev),
                       torch.tensor([0.999], device=dev)))
    lr = torch.tensor([1e-4], device=dev)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    nbytes = sum(p.numel() * (3 * p.element_size() + 16)
                 for p, *_ in params)
    row = dict(kernel="fused_adamw", case="ernie_large_step",
               params=len(params), elements=sum(p.numel() for p, *_ in params),
               bound_ms=nbytes / HBM * 1e3)
    for var in SOURCES["fused_adamw"]:
        fn = libs["fused_adamw", var].pt_fused_adamw
        fn.argtypes = _adamw_args()

        def step(i, fn=fn, apart=var == "powers_apart"):
            for p, g, m, v, b1p, b2p in params:
                head, nvec = fad.split(p.numel(), p.element_size(),
                                       fad.VEC[p.dtype], p.data_ptr(),
                                       g.data_ptr(), m.data_ptr(),
                                       v.data_ptr())
                if fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                      lr.data_ptr(), b1p.data_ptr(), b2p.data_ptr(),
                      ticket.data_ptr(), p.numel(), head, nvec, 0.9, 0.1,
                      0.999, 1.0 - 0.999, 1e-8, 0.01, fad.DTYPES[p.dtype],
                      _stream()):
                    raise RuntimeError(f"AdamW {var} launch failed")
                if apart:   # the two multiplies, launched apart
                    b1p.mul_(0.9)
                    b2p.mul_(0.999)

        row[f"{var}_device_ms"] = graph_ms(step, 3)
    print(json.dumps(row), flush=True)


def main():
    if not torch.cuda.is_available():
        print("profile_stream_kernels needs a CUDA card", file=sys.stderr)
        return 2
    from .profile_layer_norm import graph_ms, host_us, smi
    from .profile_tc_pace import build_variants

    libs = build_variants(SOURCES)
    dev = torch.device("cuda:0")
    paged(libs, dev, graph_ms, host_us,
          {**PAGED_CASES, "serve": serve_positions()})
    adamw(libs, dev, graph_ms, host_us)
    adamw_ernie_step(libs, dev, graph_ms)
    print(smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
