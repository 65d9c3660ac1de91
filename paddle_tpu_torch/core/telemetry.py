"""In-process telemetry: counters, gauges, histograms, timers and events
(port of ``paddle_tpu/core/telemetry.py``).

Cumulative counters and gauges, histograms with percentile summaries and
fixed log-spaced bucket counts (``timer`` records milliseconds), a
snapshot, the rolling-window view (``windowed``: counter deltas and
rates, histogram percentiles over the last ``FLAGS_metrics_window_s``)
and its Prometheus text exposition (``prometheus_text``, what the
serving plane's ``/metrics`` answers), with the reference's metric
names: ``pt_<name>_total``, ``pt_<name>_rate``, gauges, summaries and
``pt_<name>_bucket`` series.

``event`` keeps the most recent records (trace spans, injected faults)
in a bounded in-memory ring, ``recent_events``. Keyword attributes of
``counter_add`` / ``observe`` are accepted for the reference's call
shape and not stored. Not in the port yet (ROADMAP A10): the JSONL
run-log sink (``configure``, ``flush_sink``) and the metrics server.
"""

from __future__ import annotations

import bisect
import contextlib
import math
import re
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from . import flags as _flags

_HIST_SAMPLE_CAP = 4096
_WIN_BUCKET_CAP = 3600
_WIN_SAMPLE_CAP = 8192
_EVENT_CAP = 4096

#: Fixed log-spaced histogram bucket upper bounds, 4 per decade from 1e-3
#: to 1e7: the reference's, so bucket series from either package add up.
HIST_BUCKET_BOUNDS: tuple = tuple(
    round(10.0 ** (i / 4.0) * 1e-3, 9) for i in range(41))


class _Hist:
    """Exact count/sum/min/max, a bounded sample ring for percentiles
    (recent-window semantics once full) and bucket counts over
    HIST_BUCKET_BOUNDS (+ an overflow slot)."""

    __slots__ = ("count", "total", "vmin", "vmax", "samples", "_next",
                 "buckets")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self.samples = []
        self._next = 0
        self.buckets = [0] * (len(HIST_BUCKET_BOUNDS) + 1)

    def observe(self, v: float):
        v = float(v)
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        if math.isfinite(v):
            self.buckets[bisect.bisect_left(HIST_BUCKET_BOUNDS, v)] += 1
        else:
            self.buckets[-1] += 1
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
        self._win_samples: Dict[str, deque] = {}   # hist -> (ts, value)
        self._events: deque = deque(maxlen=_EVENT_CAP)

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
            self._win_samples.setdefault(
                name, deque(maxlen=_WIN_SAMPLE_CAP)).append(
                    (time.time(), float(value)))

    def event(self, kind: str, name: str, value, attrs):
        with self._lock:
            self._events.append({"ts": time.time(), "kind": kind,
                                 "name": name, "value": value,
                                 "attrs": dict(attrs or {})})

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges),
                    "hists": {n: h.summary() for n, h in self._hists.items()}}

    def windowed(self, window_s: Optional[float] = None,
                 now: Optional[float] = None) -> Dict[str, Any]:
        """Counter deltas and per-second rates, current gauges and
        histogram count/rate/percentiles over the last window_s seconds
        before ``now`` (default FLAGS_metrics_window_s before the present;
        counter buckets are whole seconds)."""
        w = max(float(window_s if window_s is not None
                      else _flags.flag("metrics_window_s")), 1.0)
        cut = (time.time() if now is None else float(now)) - w
        counters, hists = {}, {}
        with self._lock:
            for name, dq in self._win.items():
                tot = sum(v for sec, v in dq if sec >= cut)
                if tot:
                    counters[name] = {"delta": tot, "rate": tot / w}
            for name, dq in self._win_samples.items():
                vals = sorted(v for ts, v in dq if ts >= cut)
                if not vals:
                    continue
                n = len(vals)

                def pct(q, vals=vals, n=n):
                    return vals[min(n - 1, int(q * (n - 1) + 0.5))]

                hists[name] = {"count": n, "rate": n / w,
                               "avg": sum(vals) / n, "p50": pct(0.50),
                               "p95": pct(0.95), "p99": pct(0.99),
                               "max": vals[-1]}
            gauges = dict(self._gauges)
        return {"window_s": w, "counters": counters, "gauges": gauges,
                "hists": hists}

    def prometheus_text(self, window_s: Optional[float] = None) -> str:
        """Prometheus text exposition (0.0.4), the reference's layout:
        cumulative counters as ``pt_<name>_total``, window rates as
        ``pt_<name>_rate``, gauges, histograms as summaries (window
        quantiles, cumulative _sum/_count) with their cumulative
        ``pt_<name>_bucket{le="..."}`` series."""
        win = self.windowed(window_s)
        W = int(win["window_s"])
        with self._lock:
            cum = {n: v for n, v in self._counters.items()
                   if isinstance(v, (int, float))}
            hist_cum = {n: (h.count, h.total, list(h.buckets))
                        for n, h in self._hists.items()}
        lines = []
        for name in sorted(cum):
            m = _prom_name(name)
            lines.append(f"# TYPE {m}_total counter")
            lines.append(f"{m}_total {_prom_num(cum[name])}")
            wc = win["counters"].get(name)
            if wc is not None:
                lines.append(f"# TYPE {m}_rate gauge")
                lines.append(f'{m}_rate{{window="{W}s"}} '
                             f'{_prom_num(wc["rate"])}')
        for name in sorted(win["gauges"]):
            v = win["gauges"][name]
            if not isinstance(v, (int, float)):
                continue
            lines.append(f"# TYPE {_prom_name(name)} gauge")
            lines.append(f"{_prom_name(name)} {_prom_num(v)}")
        for name in sorted(hist_cum):
            cnt, tot, buckets = hist_cum[name]
            m = _prom_name(name)
            wh = win["hists"].get(name)
            lines.append(f"# TYPE {m} summary")
            if wh:
                for q, key in (("0.5", "p50"), ("0.95", "p95"),
                               ("0.99", "p99")):
                    lines.append(f'{m}{{quantile="{q}"}} '
                                 f'{_prom_num(wh[key])}')
            lines.append(f"{m}_sum {_prom_num(round(tot, 4))}")
            lines.append(f"{m}_count {cnt}")
            running = 0
            for bound, c in zip(HIST_BUCKET_BOUNDS, buckets):
                running += c
                lines.append(f'{m}_bucket{{le="{bound!r}"}} {running}')
            lines.append(f'{m}_bucket{{le="+Inf"}} {cnt}')
            if wh:
                lines.append(f"# TYPE {m}_window_rate gauge")
                lines.append(f'{m}_window_rate{{window="{W}s"}} '
                             f'{_prom_num(wh["rate"])}')
        return "\n".join(lines) + "\n"

    def reset(self):
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._win.clear()
            self._win_samples.clear()
            self._events.clear()


def _prom_name(name: str) -> str:
    return "pt_" + re.sub(r"[^a-zA-Z0-9_]", "_", name)


def _prom_num(v) -> str:
    if isinstance(v, float):
        return repr(round(v, 6))
    return str(v)


_REG = _Registry()


def counter_add(name: str, delta=1, **attrs):
    return _REG.counter_add(name, delta)


def counter_quiet(name: str, delta=1):
    """An increment that records no event (the reference keeps these out
    of its run log: span counts, sink failures)."""
    return _REG.counter_add(name, delta)


def counter_get(name: str):
    """A counter's cumulative value (0 if never added to)."""
    with _REG._lock:
        return _REG._counters.get(name, 0)


def counters() -> Dict[str, Any]:
    with _REG._lock:
        return dict(_REG._counters)


def gauge_set(name: str, value, **attrs):
    _REG.gauge_set(name, value)


def gauges() -> Dict[str, Any]:
    with _REG._lock:
        return dict(_REG._gauges)


def observe(name: str, value, kind: str = "hist", **attrs):
    _REG.observe(name, value)


@contextlib.contextmanager
def timer(name: str, **attrs):
    """Observe the wall time of the block, in ms, under ``name``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _REG.observe(name, (time.perf_counter() - t0) * 1e3)


def event(kind: str, name: str, value=None, attrs=None):
    """Record one event (a finished trace span, an injected fault) in the
    bounded in-memory ring."""
    _REG.event(kind, name, value, attrs)


def recent_events(kind: Optional[str] = None) -> List[Dict[str, Any]]:
    """The ring's events, oldest first, of ``kind`` if given."""
    with _REG._lock:
        return [e for e in _REG._events if kind is None or e["kind"] == kind]


def snapshot() -> Dict[str, Any]:
    return _REG.snapshot()


def windowed(window_s: Optional[float] = None,
             now: Optional[float] = None) -> Dict[str, Any]:
    return _REG.windowed(window_s, now=now)


def prometheus_text(window_s: Optional[float] = None) -> str:
    return _REG.prometheus_text(window_s)


def reset():
    _REG.reset()
