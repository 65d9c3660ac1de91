"""Weight-only int8 GEMM: ``act(x @ (w8 * scale[col]) + bias)``.

Replaces ``paddle_tpu/ops/pallas/int8_gemm.py`` ``_gemm_kernel`` (:82,
launched at :125) with ``csrc/int8_gemm.cu``: a GEMM on the bf16 tensor
cores whose int8 weight becomes bf16 only in shared memory (every int8
value is exact in bf16), whose fp32 activations are carried as three bf16
pieces (``hi + mid + lo = x``), so three products into an fp32
accumulator compute the fp32 GEMM, and whose epilogue is ``acc * scale``,
then ``+ bias``, then relu — ``_epilogue``'s order. Any K and N are
accepted (the TPU's VMEM cap on K does not apply): ragged rows are padded
here to the kernel's 16-byte copies. Activations stay fp32: int8 tensor
cores would need quantized activations, a different function.

``plan`` picks the instance and the split of K, a pure function of the
shape: ``prefill`` (M > 16) gives each block a 128 x 128 output tile, or
a 64 x 64 one where those would leave SMs idle, and splits K (below M =
512) where even those would; ``decode`` (M <= 16) swaps the operands and
splits K. The K slices of an output tile form one thread-block cluster,
whose blocks add them in rank order.

On a CPU or meta tensor the wrapper runs ``plain_int8_gemm``; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

launches = 0   # kernel launches since the last reset (not plain calls)
launches_by_instance = {"prefill": 0, "decode": 0}

TARGET_BLOCKS = 264   # two blocks per SM of an H100
PREFILL_WAVE = 128    # 128 x 128 tiles that keep the card's SMs busy
MAX_CLUSTER = 8       # the portable thread-block cluster size
DECODE_M = 16         # the decode instance takes M <= 16
DECODE_BN, DECODE_BK = 64, 64   # its output columns a block, K slab
PREFILL_BK = 32       # the prefill instance's K slab
LDX_MULTIPLE, LDW_MULTIPLE = 4, 16   # x and w8 rows, in 16-byte copies


def _split(tiles: int, k: int, slab: int):
    """(ksplit, kc): K in slices of kc rows, a multiple of ``slab``, over
    at most MAX_CLUSTER blocks, so that tiles * ksplit comes near
    TARGET_BLOCKS."""
    slabs = max(1, -(-k // slab))
    want = max(1, min(MAX_CLUSTER, -(-TARGET_BLOCKS // tiles), slabs))
    kc = -(-slabs // want) * slab
    return max(1, -(-k // kc)), kc


@functools.lru_cache(maxsize=None)
def plan(m: int, n: int, k: int):
    """(instance, tile, ksplit, kc) for an [m, k] x [k, n] product: K in
    ``ksplit`` slices of ``kc`` rows, none empty, the slices of one output
    tile summed in order across a thread-block cluster. ``prefill`` takes
    128 x 128 output tiles where they make a wave of the card
    (PREFILL_WAVE of them or more), else 64 x 64 ones, and splits K only
    where even those leave SMs idle and M < 512; ``decode`` takes 64
    output columns a block and always splits K. A pure function of the
    shape, so a given shape always sums in one order (and is cached: the
    decode step asks it 72 times for three shapes)."""
    if m > DECODE_M:
        if -(-m // 128) * -(-n // 128) >= PREFILL_WAVE:
            return "prefill", 128, 1, max(1, -(-k // PREFILL_BK)) * PREFILL_BK
        tiles = -(-m // 64) * -(-n // 64)
        if m >= 512 or tiles >= PREFILL_WAVE:
            return "prefill", 64, 1, max(1, -(-k // PREFILL_BK)) * PREFILL_BK
        return ("prefill", 64) + _split(tiles, k, PREFILL_BK)
    return ("decode", DECODE_BN) + _split(max(1, -(-n // DECODE_BN)), k,
                                          DECODE_BK)


def plain_int8_gemm(x2, w8, scale, bias=None, act=None):
    """The same function in plain PyTorch: x2 [M,K] fp32, w8 [K,N] int8,
    scale/bias [N] fp32."""
    out = torch.matmul(x2, w8.to(torch.float32)) * scale
    if bias is not None:
        out = out + bias
    if act == "relu":
        out = torch.relu(out)
    return out


def _lib():
    lib = _build.load("int8_gemm")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.pt_int8_gemm.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                     ci, ci, ci, ci, vp]
        lib.pt_int8_gemm.restype = ci
        lib._typed = True
    return lib


def _ld(cols, multiple):
    """cols rounded up to a multiple of ``multiple`` elements."""
    return -(-cols // multiple) * multiple


def _launch(x2, w8, scale, bias, relu: bool):
    global launches
    m, k = x2.shape
    n = w8.shape[1]
    dev = x2.device
    for name, t, dt, shape in (("w8", w8, torch.int8, (k, n)),
                               ("scale", scale, torch.float32, (n,)),
                               ("bias", bias, torch.float32, (n,))):
        if t is None:
            continue
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"int8 GEMM kernel: {name} must be a "
                             f"contiguous {dt} {shape} tensor on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    # rows padded by zeros to 16-byte multiples, bases 16-byte aligned: a
    # copy only where the shape is ragged or the base is not aligned
    ldx, ldw = _ld(k, LDX_MULTIPLE), _ld(n, LDW_MULTIPLE)
    if ldx != k or x2.data_ptr() % 16:
        x2 = torch.nn.functional.pad(x2, (0, ldx - k))
    if ldw != n or w8.data_ptr() % 16:
        w8 = torch.nn.functional.pad(w8, (0, ldw - n))
    instance, tile, ksplit, kc = plan(m, n, k)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    rc = _lib().pt_int8_gemm(
        x2.data_ptr(), w8.data_ptr(), scale.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        m, n, k, ldx, ldw, tile, ksplit, kc, int(relu),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "int8 GEMM")
    launches += 1
    launches_by_instance[instance] += 1
    return out


def reset_instance_counts():
    for key in launches_by_instance:
        launches_by_instance[key] = 0


def int8_weight_only_gemm(x, w8, scale, bias=None, act=None):
    """x fp32 [..., K]; w8 int8 [K, N]; scale fp32 [N]; bias [N] or None;
    act None or 'relu'. Leading axes of x are flattened for the kernel
    and restored on the way out."""
    if act not in (None, "relu"):
        raise NotImplementedError(f"int8 GEMM epilogue act={act!r}")
    lead = tuple(x.shape[:-1])
    k = x.shape[-1]
    n = w8.shape[-1]
    x2 = x.reshape(math.prod(lead), k)
    scale = scale.reshape(-1)
    bias = bias.reshape(-1) if bias is not None else None
    if x2.device.type in ("cpu", "meta"):
        out = plain_int8_gemm(x2.float(), w8, scale.float(),
                              None if bias is None else bias.float(), act)
    elif x2.device.type == "cuda":
        if x2.dtype != torch.float32:
            raise ValueError(f"int8 GEMM kernel takes fp32 activations, "
                             f"got {x2.dtype}")
        out = _launch(x2.contiguous(), w8, scale, bias, act == "relu")
    else:
        raise ValueError(f"int8 GEMM: unsupported device {x2.device}")
    return out.reshape(lead + (n,))
