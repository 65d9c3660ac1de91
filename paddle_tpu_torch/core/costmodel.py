"""Cost and memory observability: a flop and byte count per capture key,
the memory ledger, the live MFU gauge and OOM forensics (port of
``paddle_tpu/core/costmodel.py``).

* **Per-capture cost.** The reference takes flops and bytes from XLA's
  cost analysis of each compile. The port's compile is the capture of a
  compiled step (``core/executor.py``), and its count comes from one run
  of the step's lowerings on ``meta`` tensors under
  ``torch.utils.flop_counter.FlopCounterMode``, once per capture key
  (``count_ops``). On ``meta`` tensors every kernel wrapper takes its
  plain version, so a flash op counts as its two products forward (five
  backward), an int8 GEMM as 2MKN and paged attention as its two
  products, whichever route runs on the card. XLA sees only the
  ``CostEstimate`` a Pallas call declares, and the reference's flash
  sites declare none, so its count leaves the attention out where this
  one does not (ROADMAP queue C). Bytes are the sum of each program op's
  input and output bytes at its ``meta`` shapes: the same model as XLA's
  pre-optimisation "bytes accessed". The peak a program is held against
  is chosen by the dtype that carries most of its GEMM flops.
* **Memory at level ``full``.** ``torch.cuda.memory_stats`` around the
  CUDA-graph capture: ``arg_bytes`` what was allocated before it (the
  state, the feeds, whatever else the process holds), ``peak_bytes``
  the allocator's peak during it, ``temp_bytes`` the difference, and
  ``out_bytes`` the step's outputs. On the CPU there is no capture and
  no allocator statistics: the analysis is counted as unavailable
  (``costmodel.unavailable``), as the reference counts a backend
  without the analysis APIs. On a CUDA device a capture that fails
  raises.
* **The ledger and the live gauges.** ``mem.param_bytes`` /
  ``mem.opt_state_bytes`` (the persistable split at capture),
  ``mem.peak_temp_bytes``, ``mem.hbm_total_bytes``, the serving side's
  ``mem.serving.*`` gauges (KV pool, bucket footprints), and
  ``cost.live_mfu``: the windowed ``cost.dispatch_flops`` rate over the
  peak (``peak_device_flops``: a table keyed by the device name, the
  flags overriding), with a roofline verdict per program.
* **OOM forensics.** ``torch.OutOfMemoryError`` in a capture or a
  dispatch becomes ``OutOfMemoryError`` after a ``kind:"oom"`` record
  bundling the ledger and the top programs by peak bytes, routed through
  the incident pipeline (``core/incidents.py``).

Capture levels (``FLAGS_cost_capture``): ``off`` | ``cost`` | ``full`` |
``auto`` (``cost`` when a telemetry sink or a metrics server is active,
else ``off``). ``tools/mem_report.py`` renders the ledger and the
per-program table; ``tools/perf_report.py`` its "Memory & cost" section.
"""

from __future__ import annotations

import threading
import time
import zlib
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import telemetry
from .flags import flag as _flag


class OutOfMemoryError(RuntimeError):
    """A device allocation failure, raised after its forensics record
    landed in the run log."""


_OOM_MARKERS = ("resource_exhausted", "out of memory", "allocation failure")


def is_oom_error(err: BaseException) -> bool:
    if isinstance(err, torch.OutOfMemoryError):
        return True
    msg = f"{type(err).__name__}: {err}".lower()
    return any(m in msg for m in _OOM_MARKERS)


# -- the device table ---------------------------------------------------------
# (device-name substring, peak dense flops/s by GEMM operand dtype, peak
# memory bytes/s); first match wins. The H100 figures are its SXM data
# sheet's (dense tensor cores for bf16/fp16/int8, CUDA cores for fp32);
# an unknown device (the CPU) reads the H100 row, the port's target.
_DEVICE_TABLE: List[Tuple[str, Dict[str, float], float]] = [
    ("h100", {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
              "int8": 1979e12}, 3.35e12),
]
_DEFAULT_ROW = _DEVICE_TABLE[0]


def _device_name() -> str:
    if torch.cuda.is_available():
        return torch.cuda.get_device_name().lower()
    return "cpu"


def _row():
    name = _device_name()
    for row in _DEVICE_TABLE:
        if row[0] in name:
            return row
    return _DEFAULT_ROW


def peak_device_flops(dtype: Optional[str] = None) -> float:
    """Peak dense flops/s of one device for GEMM operands of ``dtype``
    (default bfloat16): FLAGS_device_peak_flops when > 0, else the
    table."""
    override = float(_flag("device_peak_flops"))
    if override > 0:
        return override
    peaks = _row()[1]
    return peaks.get(dtype or "bfloat16", peaks["bfloat16"])


def peak_device_bandwidth() -> float:
    """Peak memory bytes/s of one device: FLAGS_device_peak_bw when > 0,
    else the table."""
    override = float(_flag("device_peak_bw"))
    if override > 0:
        return override
    return _row()[2]


# -- counting a step on meta tensors ----------------------------------------

_GEMMS = None


def _gemm_flops(func, args) -> Optional[Tuple[float, torch.dtype]]:
    """(2MKN-style flops, operand dtype) of one aten GEMM call, or None
    for any other op (only to pick the peak's dtype)."""
    global _GEMMS
    if _GEMMS is None:
        a = torch.ops.aten
        _GEMMS = {a.mm.default: (0, 1), a.bmm.default: (0, 1),
                  a.addmm.default: (1, 2), a.baddbmm.default: (1, 2)}
    where = _GEMMS.get(func)
    if where is None:
        return None
    x, w = args[where[0]], args[where[1]]
    flops = 2.0 * x.numel() * w.shape[-1]
    return flops, x.dtype


class _GemmDtypes(TorchDispatchMode):
    """Flops of the GEMMs by operand dtype."""

    def __init__(self):
        super().__init__()
        self.by_dtype: Dict[str, float] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        got = _gemm_flops(func, args)
        if got is not None:
            name = str(got[1]).replace("torch.", "")
            self.by_dtype[name] = self.by_dtype.get(name, 0.0) + got[0]
        return func(*args, **(kwargs or {}))


def _nbytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    values = getattr(v, "values", None)    # a SelectedRows
    if isinstance(values, torch.Tensor):
        return _nbytes(values) + _nbytes(getattr(v, "rows", None))
    return 0


def count_ops(run: Callable[[Callable], None]) -> Tuple[float, float, str]:
    """(flops, bytes accessed, GEMM dtype) of one call of ``run``, which
    runs a step's ops on meta tensors and calls ``each(values)`` with
    every program op's inputs and again with its outputs, whose bytes are
    summed.
    Flops are FlopCounterMode's total; the dtype carrying most GEMM
    flops picks the peak."""
    from torch.utils.flop_counter import FlopCounterMode

    total_bytes = [0]

    def each(values):
        total_bytes[0] += sum(_nbytes(v) for v in values)

    counter = FlopCounterMode(display=False)
    dtypes = _GemmDtypes()
    with counter, dtypes:
        run(each)
    gemm = max(dtypes.by_dtype.items(), key=lambda kv: kv[1],
               default=("bfloat16", 0.0))[0]
    return float(counter.get_total_flops()), float(total_bytes[0]), gemm


# -- per-program cost records ------------------------------------------------


class ProgramCost:
    """One capture key's cost and memory record."""

    __slots__ = ("key_id", "kind", "program", "steps_per_dispatch",
                 "flops", "bytes_accessed", "transcendentals",
                 "arg_bytes", "out_bytes", "temp_bytes", "peak_bytes",
                 "generated_code_bytes", "source", "devices", "gemm_dtype")

    def __init__(self, key_id: str, kind: str, program: Any,
                 steps_per_dispatch: int = 1):
        self.key_id = key_id
        self.kind = kind            # "executor" | "predictor"
        self.program = program      # program label / bucket label
        self.steps_per_dispatch = int(steps_per_dispatch)
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.transcendentals = 0.0
        self.arg_bytes = 0
        self.out_bytes = 0
        self.temp_bytes = 0
        self.peak_bytes = 0
        self.generated_code_bytes = 0
        self.source = "none"        # "meta" | "captured" | "none"
        self.devices = 1
        self.gemm_dtype = "bfloat16"

    def flops_per_dispatch(self) -> float:
        return self.flops * max(1, self.steps_per_dispatch)

    def bytes_per_dispatch(self) -> float:
        return self.bytes_accessed * max(1, self.steps_per_dispatch)

    def peak_flops(self) -> float:
        return peak_device_flops(self.gemm_dtype)

    def intensity(self) -> float:
        return self.flops / self.bytes_accessed if self.bytes_accessed \
            else 0.0

    def roofline(self) -> str:
        """compute_bound or memory_bound: the arithmetic intensity
        against the device's ridge point for this program's dtype."""
        if not self.flops or not self.bytes_accessed:
            return "unknown"
        ridge = self.peak_flops() / max(peak_device_bandwidth(), 1.0)
        return "compute_bound" if self.intensity() >= ridge \
            else "memory_bound"

    def as_attrs(self) -> Dict[str, Any]:
        return {"key": self.key_id, "kind": self.kind,
                "program": self.program,
                "steps_per_dispatch": self.steps_per_dispatch,
                "flops": self.flops,
                "flops_per_dispatch": self.flops_per_dispatch(),
                "bytes_accessed": self.bytes_accessed,
                "transcendentals": self.transcendentals,
                "arg_bytes": self.arg_bytes, "out_bytes": self.out_bytes,
                "temp_bytes": self.temp_bytes,
                "peak_bytes": self.peak_bytes,
                "generated_code_bytes": self.generated_code_bytes,
                "source": self.source, "devices": self.devices,
                "gemm_dtype": self.gemm_dtype,
                "intensity": round(self.intensity(), 4),
                "roofline": self.roofline()}


_PROGRAM_CAP = 256
_programs: "OrderedDict[str, ProgramCost]" = OrderedDict()
_lock = threading.Lock()
_last_mfu_set = [0.0]
_last_peak = [0.0]      # the peak of the last booked program


def key_id_for(key: tuple) -> str:
    """A short id of a capture key, stable within the run (crc32)."""
    return f"{zlib.crc32(repr(key).encode()):08x}"


def capture_mode() -> str:
    """FLAGS_cost_capture resolved: 'auto' is 'cost' when a telemetry
    sink or a metrics server is active, else 'off'."""
    m = str(_flag("cost_capture")).strip().lower()
    if m == "auto":
        if telemetry.enabled() or telemetry.metrics_server_active():
            return "cost"
        return "off"
    return m if m in ("off", "cost", "full") else "off"


def _unavailable(stage: str, err: BaseException):
    telemetry.counter_add("costmodel.unavailable", 1, stage=stage,
                          error=f"{type(err).__name__}: {err}"[:200])


def programs() -> List[ProgramCost]:
    with _lock:
        return list(_programs.values())


def reset():
    """Clear the captured program records (tests)."""
    with _lock:
        _programs.clear()
    _last_mfu_set[0] = 0.0
    _last_peak[0] = 0.0


def _remember(rec: ProgramCost):
    with _lock:
        _programs[rec.key_id] = rec
        _programs.move_to_end(rec.key_id)
        while len(_programs) > _PROGRAM_CAP:
            _programs.popitem(last=False)
        peak = max((r.temp_bytes for r in _programs.values()), default=0)
    telemetry.counter_add("cost.captures", 1, kind=rec.kind,
                          source=rec.source)
    if peak:
        telemetry.gauge_set("mem.peak_temp_bytes", int(peak))
    telemetry.event("cost", f"costmodel.{rec.kind}", rec.flops,
                    rec.as_attrs())


def capture(count_fn: Callable[[], Tuple[float, float, str]], *,
            key_id: str, kind: str, program: Any, device,
            memory: Optional[Dict[str, int]] = None,
            steps_per_dispatch: int = 1) -> Optional[ProgramCost]:
    """The cost record of one fresh capture key: ``count_fn()`` gives
    (flops, bytes, GEMM dtype) from a meta run; at level ``full``,
    ``memory`` holds the allocator's figures around the capture
    (``memory_around``). None when capture is off. On the CPU a count or
    a memory analysis that is unavailable is counted; on a CUDA device
    it raises."""
    mode = capture_mode()
    if mode == "off":
        return None
    cuda = torch.device(device).type == "cuda"
    rec = ProgramCost(key_id, kind, program,
                      steps_per_dispatch=steps_per_dispatch)
    try:
        rec.flops, rec.bytes_accessed, rec.gemm_dtype = count_fn()
        rec.source = "meta"
    except Exception as e:   # noqa: BLE001 - sorted below
        if cuda:
            raise
        _unavailable("meta_count", e)
        return None
    if mode == "full":
        if memory is None:
            if cuda:
                raise RuntimeError(
                    f"cost capture 'full' of {kind} {program!r}: no "
                    f"memory statistics were taken around the capture")
            _unavailable("memory_analysis", RuntimeError(
                "no CUDA allocator statistics on the CPU"))
        else:
            rec.arg_bytes = int(memory["arg_bytes"])
            rec.peak_bytes = int(memory["peak_bytes"])
            rec.temp_bytes = max(0, rec.peak_bytes - rec.arg_bytes)
            rec.out_bytes = int(memory.get("out_bytes", 0))
            rec.source = "captured"
    _remember(rec)
    return rec


def memory_around(fn: Callable[[], Any], device) -> Tuple[Any, Dict[str, int]]:
    """Run ``fn`` (a CUDA-graph capture) between two reads of the
    allocator's statistics: (its result, {arg_bytes: allocated before,
    peak_bytes: the peak during it}). Resets the device's peak
    counter."""
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn()
    torch.cuda.synchronize(device)
    return out, {"arg_bytes": int(before),
                 "peak_bytes": int(torch.cuda.max_memory_allocated(device))}


# -- the ledger ----------------------------------------------------------------

def record_model_bytes(param_bytes: int, opt_state_bytes: int):
    """The persistable split measured at capture: parameters against
    optimizer and run state."""
    if param_bytes:
        telemetry.gauge_set("mem.param_bytes", int(param_bytes))
    if opt_state_bytes:
        telemetry.gauge_set("mem.opt_state_bytes", int(opt_state_bytes))
    refresh_ledger()


def split_persistable_bytes(block, names, values) -> Tuple[int, int]:
    """(parameter bytes, other state bytes) over the named scope
    residents: an ``is_parameter`` persistable is a weight, the rest
    (moments, counters, rates) optimizer or run state."""
    params = other = 0
    for n, v in zip(names, values):
        nbytes = _nbytes(v)
        if not nbytes:
            continue
        if block is not None and block.has_var(n):
            var = block.var(n)
            if not var.persistable:
                continue
            if var.desc.is_parameter:
                params += nbytes
                continue
        other += nbytes
    return params, other


def ledger() -> Dict[str, Any]:
    """The composed memory ledger: parameters, optimizer state, the
    largest captured scratch, the serving buckets and the KV pool."""
    g = telemetry.gauges()
    param_bytes = int(g.get("mem.param_bytes", 0) or 0)
    opt_bytes = int(g.get("mem.opt_state_bytes", 0) or 0)
    with _lock:
        recs = list(_programs.values())
    peak_temp = max((r.temp_bytes for r in recs), default=0)
    buckets = {n[len("mem.serving.bucket"):-len("_peak_bytes")]: int(v)
               for n, v in g.items()
               if n.startswith("mem.serving.bucket")
               and n.endswith("_peak_bytes")}
    kv_pool = int(g.get("mem.serving.kv_pool_bytes", 0) or 0)
    out = {"param_bytes": param_bytes, "opt_state_bytes": opt_bytes,
           "peak_temp_bytes": int(peak_temp),
           "total_bytes": param_bytes + opt_bytes + int(peak_temp)
           + kv_pool,
           "programs": len(recs)}
    if buckets:
        out["serving_bucket_bytes"] = buckets
        out["serving_peak_bytes"] = max(buckets.values())
    if kv_pool:
        out["serving_kv_pool_bytes"] = kv_pool
        out["serving_kv_used_bytes"] = int(
            g.get("mem.serving.kv_used_bytes", 0) or 0)
        out["serving_kv_high_water_bytes"] = int(
            g.get("mem.serving.kv_high_water_bytes", 0) or 0)
    # pool bytes prefix-cache hits did not allocate (serving/
    # prefix_store.py): savings, not residency, so not in the total
    kv_saved = int(g.get("mem.serving.kv_prefix_saved_bytes", 0) or 0)
    if kv_saved:
        out["serving_kv_prefix_saved_bytes"] = kv_saved
    return out


def refresh_ledger():
    """Publish the composed total (after any of its gauges moved)."""
    led = ledger()
    if led["total_bytes"]:
        telemetry.gauge_set("mem.hbm_total_bytes", led["total_bytes"])


# -- dispatch accounting and the live MFU --------------------------------------

def book_dispatch(rec: Optional[ProgramCost], steps: int = 1):
    """Book one dispatch of a captured program that ran ``steps`` steps
    (k for ``run_steps``): quiet flop and byte counters feed the rolling
    window the live MFU gauge reads (refreshed at most once a second)."""
    if rec is None or not rec.flops:
        return
    steps = max(1, int(steps))
    telemetry.counter_quiet("cost.dispatch_flops",
                            int(rec.flops_per_dispatch()) * steps)
    if rec.bytes_accessed:
        telemetry.counter_quiet("cost.dispatch_bytes",
                                int(rec.bytes_per_dispatch()) * steps)
    _last_peak[0] = rec.peak_flops()
    now = time.time()
    if now - _last_mfu_set[0] >= 1.0:
        _last_mfu_set[0] = now
        telemetry.gauge_set("cost.live_mfu", float(live_mfu()))


def live_mfu(window_s: Optional[float] = None) -> float:
    """Windowed achieved flops/s (the ``cost.dispatch_flops`` rate) over
    the peak of the last booked program's GEMM dtype."""
    win = telemetry.windowed(window_s)
    wc = win["counters"].get("cost.dispatch_flops")
    if not wc:
        return 0.0
    return float(wc["rate"]) / max(_last_peak[0] or peak_device_flops(),
                                   1.0)


# -- OOM forensics -------------------------------------------------------------

def oom_forensics(program: Any, err: BaseException,
                  where: str = "dispatch", top_n: int = 8) -> OutOfMemoryError:
    """Write the forensics of an allocation failure (the ledger, the top
    programs by peak bytes, the offending program) as a ``kind:"oom"``
    record through the incident pipeline, count ``mem.oom_events``, and
    return the typed error to raise."""
    with _lock:
        recs = sorted(_programs.values(),
                      key=lambda r: -(r.peak_bytes or r.temp_bytes))[:top_n]
    top = [{"key": r.key_id, "kind": r.kind, "program": r.program,
            "peak_bytes": r.peak_bytes, "temp_bytes": r.temp_bytes,
            "arg_bytes": r.arg_bytes, "flops": r.flops} for r in recs]
    led = ledger()
    telemetry.counter_add("mem.oom_events", 1, where=where)
    from . import incidents

    incidents.report_incident(
        "oom", "costmodel.oom", None,
        context={"where": where, "program": program,
                 "error": f"{type(err).__name__}: {err}"[:500],
                 "ledger": led, "top_programs": top},
        legacy_kind="oom")
    telemetry.flush_sink()
    return OutOfMemoryError(
        f"device allocation failure in {where} of program {program!r} "
        f"(memory ledger: {led['total_bytes']} bytes across "
        f"{led['programs']} captured programs; forensics record written "
        f"to the run log): {err}")
