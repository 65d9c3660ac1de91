"""Build the CUDA kernels of ``paddle_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc -gencode
arch=compute_90a,code=sm_90a`` into its own shared library with a plain C
interface, loaded through ``ctypes``. Libraries go to
``build/torch_kernels/`` at the repo root, named by a hash of their
source and the shared headers (``csrc/*.cuh``), so an edited source or
header never loads a stale build. ``build_all``
starts one ``nvcc`` per source at once; ``load`` builds on first use.

Nothing here runs at import: the CPU tests import every module, and a
machine without ``nvcc`` must never try to build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("flash_attention_fwd", "paged_attention", "int8_gemm",
           "flash_attention_bwd", "fused_adamw", "layer_norm",
           "conv_bn_relu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built on the machine with the card")


def lib_path(name: str) -> Path:
    """The library's path, named by a hash of its source and of every
    shared header (``csrc/*.cuh``) it may include."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}.{h.hexdigest()[:12]}.so"


def sources_fingerprint() -> str:
    """A hash of every kernel source and shared header (``csrc/``): what a
    tuned profile records as the kernels it was tuned against."""
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:12]


def _start(name: str):
    out = lib_path(name)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)


def _finish(name: str, out: Path, tmp: Path, proc) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    (BUILD_DIR / f"{name}.ptxas.txt").write_text(log)
    return log


def build_all() -> Dict[str, float]:
    """Compile every source that lacks a current build, one nvcc each,
    all started together. Returns {name: seconds until its build ended}
    for the builds run."""
    with _LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        running = {n: _start(n) for n in SOURCES if not lib_path(n).exists()}
        done = {}
        for n, (out, tmp, proc) in running.items():
            _finish(n, out, tmp, proc)
            done[n] = time.perf_counter() - t0
        return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            path = lib_path(name)
            if not path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                _finish(name, *_start(name))
            _LIBS[name] = ctypes.CDLL(str(path))
        return _LIBS[name]


def check(rc: int, what: str):
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
