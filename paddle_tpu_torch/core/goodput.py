"""Goodput ledger: wall-clock attribution of a training loop (port of
``paddle_tpu/core/goodput.py``).

``breakdown()`` splits the wall time since ``start_run()`` (or since the
process started) into phases read from the timers the framework emits:

* ``productive``: device compute, ``executor.device_ms`` (CUDA events
  around each compiled step's replay, read once they have completed);
* ``data_wait``: ``reader.data_wait_ms``;
* ``host_dispatch``: ``executor.host_dispatch_ms``, a run's wall minus
  its device ms;
* ``compile``: ``executor.compile_ms``, the captures;
* ``checkpoint``, ``collective``, ``recovery``: ``ckpt.save_ms``,
  ``sharding.collective_ms``, ``ckpt.restore_ms``;
* ``other``: the rest (Python, op-by-op runs, idle).

The reader, the training checkpoint and the collectives are not in the
port yet (ROADMAP A8, A9): their timers read 0. The phases are measured
in the loop's thread, so they are disjoint and, with ``other``, add up
to the wall. Pending device timings are settled (``telemetry.settle``)
before each breakdown. ``publish()`` lands ``goodput.productive_ms``,
``goodput.wall_ms``, ``goodput.badput_<phase>_ms`` and the
``goodput.ratio`` gauge; ``tick()`` on the executor's hot path publishes
at most every ``FLAGS_goodput_publish_s`` once a window is open.
Rendered by ``tools/perf_report.py``'s "Goodput" section.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from . import flags as _flags
from . import telemetry

#: badput phase -> (source kind, metric name). "hist" reads the
#: histogram's cumulative total ms; "counter" reads a cumulative ms
#: counter. Order is the render order.
BADPUT_SOURCES = (
    ("data_wait", "hist", "reader.data_wait_ms"),
    ("host_dispatch", "hist", "executor.host_dispatch_ms"),
    ("compile", "counter", "executor.compile_ms"),
    ("checkpoint", "hist", "ckpt.save_ms"),
    ("collective", "hist", "sharding.collective_ms"),
    ("recovery", "hist", "ckpt.restore_ms"),
)

PRODUCTIVE_SOURCE = ("hist", "executor.device_ms")

PHASES = tuple(p for p, _k, _m in BADPUT_SOURCES) + ("other",)

_PROCESS_T0 = time.monotonic()


def _totals() -> Dict[str, float]:
    """Cumulative ms per source metric from the live registry."""
    snap = telemetry.snapshot()
    hists = snap["hists"]
    counters = snap["counters"]
    out: Dict[str, float] = {}
    for _phase, kind, metric in BADPUT_SOURCES + (
            ("productive",) + PRODUCTIVE_SOURCE,):
        if kind == "hist":
            h = hists.get(metric)
            out[metric] = float(h["total"]) if h else 0.0
        else:
            v = counters.get(metric, 0)
            out[metric] = float(v) if isinstance(v, (int, float)) else 0.0
    return out


class GoodputLedger:
    """Delta-based wall-clock attribution window over the telemetry
    registry. Thread-safe; one per process is plenty (module singleton
    below)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._t0 = _PROCESS_T0
        self._base: Dict[str, float] = {}
        self._started = False
        self._last_publish = 0.0

    def start(self, reset: bool = True):
        """Open an attribution window NOW (baseline = current telemetry
        totals). With ``reset=False``, a no-op when a window is already
        open, so an outer caller-opened window survives nested calls."""
        with self._lock:
            if self._started and not reset:
                return
            self._t0 = time.monotonic()
            self._base = _totals()
            self._started = True

    def started(self) -> bool:
        with self._lock:
            return self._started

    def breakdown(self) -> Dict[str, Any]:
        """Wall-clock attribution since start (or process start):
        ``{"wall_ms", "productive_ms", "ratio", "phases": {phase: ms}}``.
        Tracked phases are same-thread disjoint, so
        productive + sum(phases) == wall up to measurement noise
        ("other" is the explicit untracked remainder, clamped >= 0)."""
        telemetry.settle()
        with self._lock:
            t0, base, started = self._t0, dict(self._base), self._started
        now_totals = _totals()
        wall_ms = max((time.monotonic() - t0) * 1e3, 1e-9)

        def delta(metric):
            return max(0.0, now_totals.get(metric, 0.0)
                       - base.get(metric, 0.0))

        phases = {phase: round(delta(metric), 3)
                  for phase, _kind, metric in BADPUT_SOURCES}
        productive = round(delta(PRODUCTIVE_SOURCE[1]), 3)
        tracked = productive + sum(phases.values())
        phases["other"] = round(max(0.0, wall_ms - tracked), 3)
        ratio = min(1.0, max(0.0, productive / wall_ms))
        return {"wall_ms": round(wall_ms, 3),
                "productive_ms": productive,
                "badput_ms": round(sum(phases.values()), 3),
                "ratio": round(ratio, 4),
                "phases": phases,
                "window": "run" if started else "process"}

    def publish(self) -> Dict[str, Any]:
        """Land the current breakdown in the registry: goodput.* ms
        counters + the goodput.ratio gauge (live on /metrics)."""
        b = self.breakdown()
        telemetry.counter_set("goodput.productive_ms", b["productive_ms"])
        telemetry.counter_set("goodput.wall_ms", b["wall_ms"])
        for phase, ms in b["phases"].items():
            telemetry.counter_set(f"goodput.badput_{phase}_ms", ms)
        telemetry.gauge_set("goodput.ratio", b["ratio"])
        with self._lock:
            self._last_publish = time.monotonic()
        return b

    def tick(self, now: Optional[float] = None):
        """Hot-path hook (next to incidents.tick in the executor):
        publish at most every FLAGS_goodput_publish_s once a window is
        open; two reads otherwise."""
        with self._lock:
            if not self._started:
                return
            last = self._last_publish
        if now is None:
            now = time.monotonic()
        period = float(_flags.flag("goodput_publish_s"))
        if now - last < max(period, 0.05):
            return
        self.publish()

    def reset(self):
        with self._lock:
            self._t0 = _PROCESS_T0
            self._base = {}
            self._started = False
            self._last_publish = 0.0


_ledger = GoodputLedger()


def ledger() -> GoodputLedger:
    return _ledger


def start_run():
    """Open a fresh attribution window."""
    _ledger.start(reset=True)


def ensure_run():
    """Open a window only if none is open (an outer start_run() window
    is preserved)."""
    _ledger.start(reset=False)


def breakdown() -> Dict[str, Any]:
    return _ledger.breakdown()


def publish() -> Dict[str, Any]:
    return _ledger.publish()


def tick(now: Optional[float] = None):
    _ledger.tick(now)


def reset():
    _ledger.reset()
