"""What sets the pace of the conv and int8 GEMM tensor-core kernels.

    python -m paddle_tpu_torch.tools.profile_tc_pace

Builds ``csrc/int8_gemm.cu`` and ``csrc/conv_bn_relu.cu`` three ways from
copies of ``csrc/`` (under ``build/torch_kernels/ablation/``, one nvcc per
build, all at once) and times each on the device alone (the same calls
captured in a CUDA graph and replayed, ``profile_layer_norm.graph_ms``):

* ``base``: the source as it is;
* ``hi_only`` (int8 GEMM): one of the three bf16 products a 16-deep step
  (hi), the other two cut: a third of the tensor-core work;
* ``no_mma``: every ``wgmma`` cut: the copies, the int8 conversion, the
  three-piece split, the barriers and the epilogue alone.

If ``hi_only`` is near ``base``, the tensor cores do not set the pace;
``no_mma`` is the floor that the copies and the CUDA-core work leave. The
ablated builds compute wrong results and are only timed. Shapes: the int8
GEMM at decode's M = 8 and at prefill's M = 64, 512 and 2048 on the
decoder LM's weight shapes; the conv at the tool's N = 256, 14x14,
256 -> 256. Prints one JSON line per shape, then the card's name and power
limit. Needs one CUDA card and nvcc; exits non-zero without them.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys

import torch

INT8_CASES = ((8, 1024, 4096), (64, 4096, 1024), (512, 1024, 4096),
              (512, 4096, 1024), (2048, 1024, 4096))
INT8_PRODUCTS = ("      wgmma_rs<P_BN>(acc, lo[j], db);\n"
                 "      wgmma_rs<P_BN>(acc, mid[j], db);\n")
INT8_HI = "      wgmma_rs<P_BN>(acc, hi[j], db);\n"
DECODE_LOOP = "for (int p = 0; p < 3; ++p)   // lo, mid, hi"
CONV_LOOP = "for (int j = 0; j < BK / 16; ++j)\n      wgmma_ss_tb_n128"
VARIANTS = {
    "int8_gemm": {
        "base": [],
        "hi_only": [(INT8_PRODUCTS, ""),
                    (DECODE_LOOP, "for (int p = 2; p < 3; ++p)")],
        "no_mma": [(INT8_PRODUCTS + INT8_HI, ""),
                   (DECODE_LOOP, "for (int p = 3; p < 3; ++p)")],
    },
    "conv_bn_relu": {
        "base": [],
        "no_mma": [(CONV_LOOP, CONV_LOOP.replace("j < BK / 16", "j < 0"))],
    },
}


def build_variants(sources=None):
    """{(source, variant): loaded library}, every build started at once:
    ``sources`` maps a csrc name to {variant: [(old text, new text)]}
    (VARIANTS by default)."""
    from ..kernels import _build

    root = _build.BUILD_DIR / "ablation"
    procs = {}
    for name, variants in (sources or VARIANTS).items():
        for var, edits in variants.items():
            d = root / f"{name}.{var}"
            shutil.rmtree(d, ignore_errors=True)
            shutil.copytree(_build.CSRC, d)
            src = d / f"{name}.cu"
            text = src.read_text()
            for old, new in edits:
                if old not in text:
                    raise RuntimeError(f"{name}.{var}: the source no longer "
                                       f"holds {old[:40]!r}")
                text = text.replace(old, new)
            src.write_text(text)
            lib = d / "lib.so"
            procs[name, var] = lib, subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                 str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def main():
    if not torch.cuda.is_available():
        print("profile_tc_pace needs a CUDA card", file=sys.stderr)
        return 2
    from ..kernels import int8_gemm as ig
    from . import exp_conv
    from .profile_layer_norm import graph_ms, smi

    libs = build_variants()
    dev = torch.device("cuda:0")
    vp, ci = ctypes.c_void_p, ctypes.c_int

    def stream():
        return torch.cuda.current_stream().cuda_stream

    for m, k, n in INT8_CASES:
        g = torch.Generator(device=dev).manual_seed(m + k + n)
        reps = max(1, (64 << 20) // (k * n))   # > 50 MB L2: weights cold
        w8s = [torch.randint(-127, 128, (k, n), device=dev, dtype=torch.int8,
                             generator=g) for _ in range(reps)]
        x = torch.randn(m, k, device=dev, generator=g)
        sc = torch.rand(n, device=dev, generator=g)
        bias = torch.randn(n, device=dev, generator=g)
        out = torch.empty(m, n, device=dev)
        inst, tile, ksplit, kc = ig.plan(m, n, k)
        row = dict(kernel="int8_gemm", shape=f"M={m} K={k} N={n}",
                   instance=inst, tile=tile, ksplit=ksplit, kc=kc)
        for var in VARIANTS["int8_gemm"]:
            fn = libs["int8_gemm", var].pt_int8_gemm
            fn.argtypes = [vp] * 5 + [ci] * 9 + [vp]

            def call(i, fn=fn):
                return fn(x.data_ptr(), w8s[i % reps].data_ptr(),
                          sc.data_ptr(), bias.data_ptr(), out.data_ptr(), m,
                          n, k, k, n, tile, ksplit, kc, 1, stream())

            if call(0) != 0:
                raise RuntimeError(f"int8 {var} launch failed at {row}")
            row[f"{var}_device_ms"] = graph_ms(call, 30)
        print(json.dumps(row), flush=True)
        del w8s

    _, xp, w, sc, sh = exp_conv.make_inputs(256, dev, seed=0)
    out = torch.empty(256, 14, 14, 256, device=dev, dtype=torch.bfloat16)
    row = dict(kernel="conv_bn_relu",
               shape="N=256 H=W=14 C=256 Co=256 3x3 NHWC bf16")
    for var in VARIANTS["conv_bn_relu"]:
        fn = libs["conv_bn_relu", var].pt_conv_bn_relu
        fn.argtypes = [vp] * 5 + [ci] * 6 + [vp]

        def call(i, fn=fn):
            return fn(xp.data_ptr(), w.data_ptr(), sc.data_ptr(),
                      sh.data_ptr(), out.data_ptr(), 256, 14, 14, 256, 256,
                      256, stream())

        if call(0) != 0:
            raise RuntimeError(f"conv {var} launch failed")
        row[f"{var}_device_ms"] = graph_ms(call, 20)
    print(json.dumps(row), flush=True)
    print(smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
