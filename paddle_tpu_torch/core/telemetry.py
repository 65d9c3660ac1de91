"""In-process telemetry: counters, gauges, histograms and timers.

The part of ``paddle_tpu/core/telemetry.py`` that ``DecodeEngine.stats``
and ``AdmissionQueue`` read: cumulative counters and gauges, histograms
with percentile summaries (``timer`` records milliseconds), a snapshot,
and a rolling-window counter rate. The JSONL sink, the metrics server
and Prometheus text come with later slices.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Any, Dict, Optional

_HIST_SAMPLE_CAP = 4096
_WIN_BUCKET_CAP = 3600
WINDOW_S = 60.0


class _Hist:
    """Exact count/sum/min/max plus a bounded sample ring for
    percentiles (recent-window semantics once full)."""

    __slots__ = ("count", "total", "vmin", "vmax", "samples", "_next")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self.samples = []
        self._next = 0

    def observe(self, v: float):
        v = float(v)
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        if len(self.samples) < _HIST_SAMPLE_CAP:
            self.samples.append(v)
        else:
            self.samples[self._next] = v
            self._next = (self._next + 1) % _HIST_SAMPLE_CAP

    def summary(self) -> Dict[str, float]:
        s = sorted(self.samples)

        def pct(q):
            return s[min(len(s) - 1, int(q * (len(s) - 1) + 0.5))] if s \
                else 0.0

        n = self.count
        return {"count": n, "total": self.total,
                "min": self.vmin if n else 0.0,
                "max": self.vmax if n else 0.0,
                "avg": self.total / n if n else 0.0,
                "p50": pct(0.50), "p90": pct(0.90),
                "p95": pct(0.95), "p99": pct(0.99)}


class _Registry:
    def __init__(self):
        self._lock = threading.RLock()
        self._counters: Dict[str, Any] = {}
        self._gauges: Dict[str, Any] = {}
        self._hists: Dict[str, _Hist] = {}
        self._win: Dict[str, deque] = {}   # counter -> [[second, delta]]

    def counter_add(self, name: str, delta=1):
        with self._lock:
            val = self._counters.get(name, 0) + delta
            self._counters[name] = val
            dq = self._win.setdefault(name, deque(maxlen=_WIN_BUCKET_CAP))
            sec = int(time.time())
            if dq and dq[-1][0] == sec:
                dq[-1][1] += delta
            else:
                dq.append([sec, delta])
        return val

    def gauge_set(self, name: str, value):
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, value):
        with self._lock:
            self._hists.setdefault(name, _Hist()).observe(value)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges),
                    "hists": {n: h.summary() for n, h in self._hists.items()}}

    def windowed(self, window_s: Optional[float] = None) -> Dict[str, Any]:
        """Counter deltas and per-second rates over the last window_s
        seconds (bucket granularity: one second)."""
        w = max(float(window_s or WINDOW_S), 1.0)
        cut = time.time() - w
        out = {}
        with self._lock:
            for name, dq in self._win.items():
                tot = sum(v for sec, v in dq if sec >= cut)
                if tot:
                    out[name] = {"delta": tot, "rate": tot / w}
        return {"window_s": w, "counters": out}

    def reset(self):
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._win.clear()


_REG = _Registry()


def counter_add(name: str, delta=1):
    return _REG.counter_add(name, delta)


def counter_get(name: str):
    """A counter's cumulative value (0 if never added to)."""
    with _REG._lock:
        return _REG._counters.get(name, 0)


def gauge_set(name: str, value):
    _REG.gauge_set(name, value)


def observe(name: str, value):
    _REG.observe(name, value)


@contextlib.contextmanager
def timer(name: str):
    """Observe the wall time of the block, in ms, under ``name``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _REG.observe(name, (time.perf_counter() - t0) * 1e3)


def snapshot() -> Dict[str, Any]:
    return _REG.snapshot()


def windowed(window_s: Optional[float] = None) -> Dict[str, Any]:
    return _REG.windowed(window_s)


def reset():
    _REG.reset()
