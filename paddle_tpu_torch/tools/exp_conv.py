"""3x3 conv + BN scale/shift + ReLU at ResNet-50's dominant shape, three
ways, on the card.

    python -m paddle_tpu_torch.tools.exp_conv [--batch 256] [--reps 20]

The port of ``tools/exp_pallas_conv.py``: shape "s3_c2" (a 3x3 stride-1
conv at 14x14, 256 -> 256 channels, batch 256, NHWC bf16; six such convs
in ResNet-50's res4 stage), the input padded once. It times, with CUDA
events over back-to-back calls:

* the hand-written kernel (``kernels/conv_bn_relu.py``);
* the library route: ``F.conv2d`` (cuDNN) on the channels-last bf16
  tensor, then the fp32 scale/shift and ReLU, rounded to bf16;
* the plain version (the kernel's arithmetic in plain PyTorch);

and reports each as ms and as a share of the card's dense bf16 peak, the
kernel and the library route also on the device alone (``*_device_ms``:
the same calls captured in a CUDA graph and replayed)
(989 TFLOP/s for 2 * N*H*W * Co * 9*C flops, 5.92e10 at batch 256), the
kernel's largest difference from the plain version, and its launches. The
reference's ``slope_time`` trick (chained steps timed on the host) is a
TPU necessity; CUDA events time the device directly.

Runs on cuda:0 unless ``--device cpu`` is given (then at a small batch:
the numbers are the CPU's and name no device metric). Prints one JSON
line and, on the card, its name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch
import torch.nn.functional as F

H = W = 14
C = CO = 256
BF16_FLOPS_PER_S = 989e12      # H100 SXM data sheet, dense tensor cores


def make_inputs(batch, device, seed=0):
    """x NHWC bf16 and its padded copy, HWIO bf16 weight, fp32 scale and
    shift, from ``seed``."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = (torch.randn(batch, H, W, C, generator=g) * 0.5).bfloat16()
    w = (torch.randn(3, 3, C, CO, generator=g) * 0.05).bfloat16()
    scale = torch.randn(CO, generator=g) * 0.1 + 1.0
    shift = torch.randn(CO, generator=g) * 0.1
    x, w, scale, shift = (t.to(device) for t in (x, w, scale, shift))
    xp = F.pad(x, (0, 0, 1, 1, 1, 1)).contiguous()
    return x, xp, w, scale, shift


def library_conv_bn_relu(x, w, scale, shift):
    """One cuDNN conv over the channels-last bf16 tensor, then the
    epilogue in fp32: the same function, NHWC in and out."""
    xc = x.permute(0, 3, 1, 2)                       # NCHW view, NHWC memory
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    y = F.conv2d(xc, wc, padding=1)
    y = torch.relu(y.float() * scale[:, None, None] + shift[:, None, None])
    return y.to(torch.bfloat16).permute(0, 2, 3, 1)


def _events_ms(fn, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run(device="cuda:0", batch=256, reps=20, seed=0):
    """The three timings (CUDA) or one pass of each route (CPU) as a
    dict. Raises without CUDA unless device="cpu"."""
    from ..kernels import conv_bn_relu as cbr
    from .profile_layer_norm import graph_ms

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("exp_conv runs on the GPU by default and no CUDA "
                           "device is available; pass device='cpu'")
    x, xp, w, scale, shift = make_inputs(batch, device, seed)
    flops = 2.0 * batch * H * W * CO * 9 * C
    got = cbr.conv_bn_relu(xp, w, scale, shift)
    ref = cbr.plain_conv_bn_relu(xp, w, scale, shift)
    lib = library_conv_bn_relu(x, w, scale, shift)
    out = dict(shape=f"N={batch} H=W={H} C={C} Co={CO} 3x3 NHWC bf16",
               flops=flops, device=str(device),
               max_abs_err=float((got.float() - ref.float()).abs().max()),
               library_max_abs_err=float((lib.float() - ref.float())
                                         .abs().max()))
    if device.type != "cuda":
        return out
    # cuDNN picks its fastest algorithm for the library route
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        for name, fn in (
                ("kernel", lambda: cbr.conv_bn_relu(xp, w, scale, shift)),
                ("library", lambda: library_conv_bn_relu(x, w, scale,
                                                         shift)),
                ("plain", lambda: cbr.plain_conv_bn_relu(xp, w, scale,
                                                         shift))):
            ms = _events_ms(fn, reps if name != "plain"
                            else max(2, reps // 4))
            out[f"{name}_ms"] = ms
            out[f"{name}_share_of_bf16_peak"] = flops / (ms * 1e-3) \
                / BF16_FLOPS_PER_S
            if name != "plain":   # the device alone: a CUDA-graph replay
                out[f"{name}_device_ms"] = graph_ms(lambda i: fn(), reps)
    finally:
        torch.backends.cudnn.benchmark = benchmark
    out["device_name"] = torch.cuda.get_device_name(device)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda:0")
    parser.add_argument("--batch", type=int, default=None,
                        help="256 on the card, 2 on the CPU")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    cpu = torch.device(args.device).type == "cpu"
    batch = args.batch or (2 if cpu else 256)
    print(json.dumps(run(args.device, batch, args.reps)), flush=True)
    if not cpu:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip(),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
