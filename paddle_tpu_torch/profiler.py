"""Profiler: host spans, summary tables, chrome-trace export and device
traces on torch.profiler (port of ``paddle_tpu/profiler.py``).

* ``RecordEvent`` / ``record_event``: a host span pushed into a bounded
  ring (``FLAGS_profiler_max_events``; the oldest span goes first,
  counted as ``profiler.events_dropped``) while the profiler is on. The
  executor pushes one per op in the op-by-op path (``run_op``) and
  ``executor::compile`` / ``executor::run`` around a compiled step's
  capture and replay. While a torch.profiler trace runs (``trace`` or
  ``device_profile``), each span is also a ``record_function`` range, so
  the kernels an op launches sit under its name in the trace.
* ``start_profiler`` / ``stop_profiler`` / ``reset_profiler``, the
  ``profiler()`` context with its sorted summary table, ``summarize``,
  ``events`` and ``export_chrome_tracing`` (chrome://tracing JSON).
* ``start_trace`` / ``stop_trace`` / ``trace``: a torch.profiler trace
  of the CPU and the CUDA device, exported as a chrome trace into
  ``log_dir`` (the reference's jax.profiler XPlane dump).
* ``device_profile(run_step, steps)``: device time of ``steps`` calls of
  ``run_step`` by source. A kernel launched under an op's range (the
  op-by-op path) lies inside that range's span on the device timeline
  and is attributed to the op's type (one that a range's thread did not
  launch, as the autograd engine's backward of a ``__vjp_grad__``, to
  the op whose span began last before it); a kernel under no op range
  (a replayed CUDA graph: a replay has no CPU parent) to its kernel
  class.
  The result also counts each kernel by name under its source, so a
  launch counter can be held against the trace.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .core import flags as _flags
from .core import telemetry as _telemetry

_lock = threading.Lock()
_enabled = False
# {name, ts, dur, tid}; bounded by FLAGS_profiler_max_events
_events: "collections.deque[dict]" = collections.deque()
# the op ranges of a running torch.profiler trace: the names RecordEvent
# opened as record_function ranges
_traced_names: Optional[set] = None


def _now_us() -> float:
    return time.perf_counter() * 1e6


class RecordEvent:
    """A span: a context manager, or ``begin()`` / ``end()``."""

    def __init__(self, name: str):
        self.name = name
        self._t0 = None
        self._range = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()

    def begin(self):
        if _traced_names is not None:
            import torch

            _traced_names.add(self.name)
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if _enabled:
            self._t0 = _now_us()

    def end(self):
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if self._t0 is None:
            return
        dur = _now_us() - self._t0
        dropped = 0
        cap = int(_flags.flag("profiler_max_events"))
        with _lock:
            while cap > 0 and len(_events) >= cap:
                _events.popleft()
                dropped += 1
            _events.append({"name": self.name, "ts": self._t0, "dur": dur,
                            "tid": threading.get_ident()})
        self._t0 = None
        if dropped:
            # outside _lock: telemetry.flush takes the locks the other way
            _telemetry.counter_add("profiler.events_dropped", dropped)


@contextlib.contextmanager
def record_event(name: str):
    with RecordEvent(name):
        yield


def active() -> bool:
    """Whether a span opened now would record anything (the executor
    checks this before it opens one per op)."""
    return _enabled or _traced_names is not None


def is_profiler_enabled() -> bool:
    return _enabled


def start_profiler(state: str = "All", tracer_option: str = "Default"):
    """Clear the ring and start recording host spans (``state`` and
    ``tracer_option`` are kept for the reference's call shape)."""
    global _enabled
    reset_profiler()
    _enabled = True


def reset_profiler():
    with _lock:
        _events.clear()


def stop_profiler(sorted_key: Optional[str] = "total",
                  profile_path: Optional[str] = None):
    """Stop recording, print the summary table, and write the chrome
    trace to ``profile_path`` if given."""
    global _enabled
    _enabled = False
    summary = summarize()
    _print_summary(summary, sorted_key)
    if profile_path:
        export_chrome_tracing(profile_path)
    return summary


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: str = "total",
             profile_path: Optional[str] = None):
    """``with profiler.profiler(): ...``"""
    start_profiler(state)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


profile = profiler


def events() -> List[dict]:
    with _lock:
        return list(_events)


def summarize() -> Dict[str, dict]:
    """Spans by name: {calls, total_us, avg_us, max_us, min_us}."""
    agg: Dict[str, dict] = {}
    for e in events():
        s = agg.setdefault(e["name"], {"calls": 0, "total_us": 0.0,
                                       "max_us": 0.0, "min_us": float("inf")})
        s["calls"] += 1
        s["total_us"] += e["dur"]
        s["max_us"] = max(s["max_us"], e["dur"])
        s["min_us"] = min(s["min_us"], e["dur"])
    for s in agg.values():
        s["avg_us"] = s["total_us"] / s["calls"]
    return agg


def _print_summary(summary: Dict[str, dict], sorted_key: Optional[str]):
    if not summary:
        return
    key = {"total": "total_us", "calls": "calls", "max": "max_us",
           "min": "min_us", "ave": "avg_us", "avg": "avg_us"}.get(
               sorted_key or "total", "total_us")
    rows = sorted(summary.items(), key=lambda kv: kv[1][key], reverse=True)
    print(f"{'Event':<40}{'Calls':>8}{'Total(us)':>14}{'Avg(us)':>12}"
          f"{'Max(us)':>12}{'Min(us)':>12}")
    for name, s in rows:
        print(f"{name[:39]:<40}{s['calls']:>8}{s['total_us']:>14.1f}"
              f"{s['avg_us']:>12.1f}{s['max_us']:>12.1f}{s['min_us']:>12.1f}")


def export_chrome_tracing(path: str):
    """The ring's spans as chrome://tracing JSON."""
    doc = {"traceEvents": [
        {"name": e["name"], "ph": "X", "ts": e["ts"], "dur": e["dur"],
         "pid": 0, "tid": e["tid"], "cat": "op"}
        for e in events()]}
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


# -- device traces: torch.profiler (CUPTI) ----------------------------------

_trace_state: Dict[str, Any] = {}


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def start_trace(log_dir: Optional[str] = None):
    """Start a torch.profiler trace of the CPU and the CUDA device; op
    spans become record_function ranges until ``stop_trace``."""
    global _traced_names
    import torch

    if _trace_state:
        raise RuntimeError("a profiler trace is already running")
    prof = torch.profiler.profile(activities=_activities())
    prof.__enter__()
    _trace_state.update(prof=prof, log_dir=log_dir)
    _traced_names = set()


def stop_trace():
    """Stop the trace; with a ``log_dir`` its chrome trace is written
    there (``trace.json``). Returns the torch profiler and the set of op
    range names opened while it ran."""
    global _traced_names
    if not _trace_state:
        raise RuntimeError("no profiler trace is running")
    prof, log_dir = _trace_state.pop("prof"), _trace_state.pop("log_dir")
    names, _traced_names = _traced_names, None
    prof.__exit__(None, None, None)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    return prof, names


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace()


# kernel classes for device time with no op range above it
_KERNEL_CLASSES = (
    ("flash attention", ("flash_", "dkv_", "dq_tc", "dq_tf32", "dq_kernel",
                         "delta_kernel", "dbias_kernel")),
    ("port kernels", ("adamw", "ln_kernel", "conv_bn_relu", "paged",
                      "int8")),
    ("gemm", ("gemm", "cutlass", "cublas", "xmma", "nvjet")),
    ("reduction", ("reduce", "norm", "softmax")),
    ("copy", ("copy", "memcpy", "memset", "cat", "transpose")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "where",
                     "fill")))


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in _KERNEL_CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def _exclusive_times(events):
    """Per-event exclusive duration of nested trace events (a parent's
    time minus its properly contained children's); each (pid, tid)
    timeline nests on its own."""
    by_tid = collections.defaultdict(list)
    for e in events:
        if "dur" in e:
            by_tid[(e.get("pid"), e.get("tid"))].append(e)
    excl = {}
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []
        for e in evs:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
                stack.pop()
            if stack:
                p = stack[-1]
                if e["ts"] + e["dur"] <= p["ts"] + p["dur"]:
                    excl[id(p)] = excl.get(id(p), p["dur"]) - e["dur"]
                else:
                    continue
            stack.append(e)
    return excl


_WARMUP = "profiler::warmup"


def _attribute(events, names: set):
    """Each device event of a trace as (source, kernel name, device us),
    and the number of op spans on the device timeline. An op range
    opened while the trace ran has a device-side span over the kernels
    launched inside it on its thread (the profiler's user annotation on
    the device timeline). A kernel is attributed to the innermost span
    containing it; one outside every span (launched from another
    thread, as the autograd engine's thread runs a ``__vjp_grad__``'s
    backward after the op's forward recompute) to the op whose span
    began last before it; one before any span to its kernel class."""
    from torch.autograd import DeviceType

    dev = [e for e in events if e.device_type != DeviceType.CPU]
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in dev if e.name in names)
    starts = [sp[0] for sp in spans]
    out = []
    for e in dev:
        if e.name in names or e.name.startswith("ProfilerStep"):
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        # the latest span starting at or before the kernel that also ends
        # after it: the innermost op range around its launch; else the
        # latest span that began before it
        i = bisect.bisect_right(starts, t0) - 1
        src = spans[i][2] if i >= 0 else kernel_class(e.name)
        for j in range(i, max(-1, i - 64), -1):
            if spans[j][1] >= t1:
                src = spans[j][2]
                break
        out.append((src, e.name, t1 - t0))
    return out, len(spans)


def device_profile(run_step: Callable[[], Any], steps: int = 3,
                   log_dir: Optional[str] = None) -> Dict[str, Any]:
    """Trace ``steps`` calls of ``run_step`` (after a warm-up of a few
    small kernels, so the device tracing records from the first call)
    and attribute their kernels' device time.

    Returns {"ms_per_step": device ms a step, "rows": [(source, ms a
    step)] by cost, "kernels": {source: {kernel name: launches}},
    "kernel_records": device records attributed, "op_spans": op ranges
    seen on the device timeline}. A source is the op type whose range
    launched the kernel, or the kernel's class where no op range is
    around it (a replayed graph)."""
    import torch

    start_trace(log_dir)
    try:
        if torch.cuda.is_available():
            with record_event(_WARMUP):
                warm = torch.zeros(1024, device="cuda")
                for _ in range(64):
                    warm.add_(1.0)
                torch.cuda.synchronize()
        for _ in range(steps):
            run_step()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    finally:
        prof, names = stop_trace()
    by_src: Dict[str, float] = collections.defaultdict(float)
    counts: Dict[str, Dict[str, int]] = collections.defaultdict(
        lambda: collections.defaultdict(int))
    seen = 0
    attributed, n_spans = _attribute(prof.events(), names)
    for src, name, dur in attributed:
        if src == _WARMUP:
            continue
        by_src[src] += dur
        counts[src][name] += 1
        seen += 1
    total = sum(by_src.values())
    rows = sorted(((k, v / 1e3 / steps) for k, v in by_src.items()),
                  key=lambda kv: -kv[1])
    return {"ms_per_step": total / 1e3 / steps, "rows": rows,
            "kernels": {s: dict(c) for s, c in counts.items()},
            "kernel_records": seen, "op_spans": n_spans}
