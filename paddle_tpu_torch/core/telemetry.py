"""In-process telemetry: counters, gauges, histograms, timers, events
and the JSONL run-log sink (port of ``paddle_tpu/core/telemetry.py``).

Cumulative counters and gauges, histograms with percentile summaries and
fixed log-spaced bucket counts (``timer`` records milliseconds), a
snapshot, the rolling-window view (``windowed``: counter deltas and
rates, histogram percentiles over the last ``FLAGS_metrics_window_s``)
and its Prometheus text exposition (``prometheus_text``), with the
reference's metric names: ``pt_<name>_total``, ``pt_<name>_rate``,
gauges, summaries and ``pt_<name>_bucket`` series.

Every ``counter_add`` / ``counter_set`` / ``gauge_set`` / ``observe`` /
``timer`` / ``event`` call becomes one record of the reference's run-log
schema::

    {"ts": <unix seconds>, "kind": <str>, "name": <str>,
     "value": <number|null>, "attrs": {<str>: <json>}}

(``counter``: value = the new cumulative, attrs.delta = the increment
and the caller's keyword attributes; ``gauge``; ``timer`` / ``hist``:
the sample, rounded to 4 places; ``event`` records keep their kind:
``span``, ``compile``, ``cost``, ``oom``, ``incident``, ``fault``,
``scale``, ``tuner``; ``snapshot`` and ``profiler_summary`` at
``flush``), so ``tools/perf_report.py``, ``mem_report.py``,
``incident_report.py`` and ``trace_view.py`` read the port's logs
unchanged. Records go to:

* the flight-recorder tap (``set_blackbox``; ``core/incidents.py``
  installs its ring), always, whether or not a sink is configured;
* the JSONL sink, when ``FLAGS_telemetry_path`` (or, below it, the
  ``PT_TELEMETRY_LOG`` env var) names a file: lines buffer in memory and
  are written in one batch once ``FLAGS_telemetry_buffer_lines`` are
  pending, every ``FLAGS_telemetry_flush_s`` (inline on the next record
  and from a lazy daemon flusher), on ``flush_sink()`` / ``flush()``, on
  a path change and at exit (``flush`` is registered with ``atexit``: a
  final ``snapshot`` record and the profiler's summary rows). A failing
  sink never raises into the instrumented thread; its lost records are
  counted in ``telemetry.dropped_records``.

``event`` records (not the metric updates) are also kept in a bounded
in-memory ring, ``recent_events``. ``start_metrics_server(port)`` serves
``GET /metrics`` (Prometheus text), ``/healthz`` and ``/varz`` (snapshot
and window as JSON) from any process.
"""

from __future__ import annotations

import atexit
import bisect
import contextlib
import json
import math
import os
import re
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from . import flags as _flags

_HIST_SAMPLE_CAP = 4096
_WIN_BUCKET_CAP = 3600
_WIN_SAMPLE_CAP = 8192
_EVENT_CAP = 4096

# the flight-recorder tap (core/incidents.py installs it): every record is
# handed to it, sink or no sink; it must be cheap and never raise
_blackbox = [None]


def set_blackbox(fn):
    _blackbox[0] = fn


# settlers: callables that land measurements still pending on the device
# (the executor's CUDA events) before a reader sums them
_settlers: list = []


def add_settler(fn):
    if fn not in _settlers:
        _settlers.append(fn)


def settle():
    """Land the pending device timings (``goodput.breakdown`` and
    ``flush`` call it; the executor's hot path never waits for them)."""
    for fn in list(_settlers):
        fn()

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
        self._file = None
        self._path: Optional[str] = None
        self._sink_warned = False
        self._buf: List[str] = []          # pending JSONL lines
        self._last_flush = 0.0
        self._flusher_started = False

    # -- the sink ----------------------------------------------------------
    @staticmethod
    def _resolve_path() -> Optional[str]:
        path = _flags.flag("telemetry_path")
        if not path:
            path = os.environ.get("PT_TELEMETRY_LOG", "")
        return path or None

    def _sink(self):
        """The sink file (under the lock). Follows flag and env changes:
        a new path flushes the buffer into the old file, closes it and
        opens the new one; an empty path closes the sink."""
        path = self._resolve_path()
        if path != self._path:
            if self._file is not None:
                self._flush_buf_locked()
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None
            self._buf.clear()
            self._path = path
            if path:
                try:
                    self._file = open(path, "a")
                    self._last_flush = time.time()
                except OSError as e:
                    if not self._sink_warned:
                        self._sink_warned = True
                        print(f"[telemetry] cannot open sink {path!r}: {e}",
                              file=sys.stderr)
                    self._path = None
        return self._file

    def _drop_locked(self, n: int):
        """Count records lost to a failing sink, in memory only (a
        counter_add here would recurse into emit)."""
        self._counters["telemetry.dropped_records"] = \
            self._counters.get("telemetry.dropped_records", 0) + n

    def _flush_buf_locked(self):
        """Write the pending lines as one write + flush; a failing file
        system is counted, never raised."""
        if not self._buf or self._file is None:
            return
        batch, self._buf = self._buf, []
        self._last_flush = time.time()
        try:
            self._file.write("\n".join(batch) + "\n")
            self._file.flush()
        except (OSError, ValueError):
            self._drop_locked(len(batch))

    def _ensure_flusher_locked(self):
        """A lazy daemon thread that flushes the buffer every
        FLAGS_telemetry_flush_s, so an idle process still lands its
        records."""
        if self._flusher_started:
            return
        self._flusher_started = True

        def loop():
            while True:
                time.sleep(max(0.05, float(_flags.flag("telemetry_flush_s"))))
                with self._lock:
                    self._flush_buf_locked()

        threading.Thread(target=loop, name="pt-telemetry-flush",
                         daemon=True).start()

    def flush_sink(self):
        with self._lock:
            self._flush_buf_locked()

    def enabled(self) -> bool:
        return self._resolve_path() is not None

    def configure(self, path: Optional[str]):
        _flags.set_flags({"telemetry_path": path or ""})
        with self._lock:
            self._sink()

    def emit(self, kind: str, name: str, value=None,
             attrs: Optional[Dict[str, Any]] = None):
        """One schema record to the flight-recorder tap and, when a sink
        is configured, to the JSONL buffer. Serialisation and write
        failures are counted, never raised."""
        bb = _blackbox[0]
        with self._lock:
            f = self._sink()
            if f is None and bb is None:
                return
            rec = {"ts": time.time(), "kind": kind, "name": name,
                   "value": value, "attrs": attrs or {}}
            if bb is not None:
                try:
                    bb(rec)
                except Exception:   # noqa: BLE001 - the tap never raises
                    pass
            if f is None:
                return
            try:
                self._buf.append(json.dumps(rec, default=str))
            except (ValueError, TypeError):
                self._drop_locked(1)
                return
            if len(self._buf) >= max(1, int(_flags.flag(
                    "telemetry_buffer_lines"))) or rec["ts"] - \
                    self._last_flush >= float(_flags.flag(
                        "telemetry_flush_s")):
                self._flush_buf_locked()
            self._ensure_flusher_locked()

    # -- metrics -----------------------------------------------------------
    def _count_locked(self, name: str, delta):
        val = self._counters.get(name, 0) + delta
        self._counters[name] = val
        dq = self._win.setdefault(name, deque(maxlen=_WIN_BUCKET_CAP))
        sec = int(time.time())
        if dq and dq[-1][0] == sec:
            dq[-1][1] += delta
        else:
            dq.append([sec, delta])
        return val

    def counter_add(self, name: str, delta=1, **attrs):
        with self._lock:
            val = self._count_locked(name, delta)
        self.emit("counter", name, val, {"delta": delta, **attrs})
        return val

    def counter_quiet(self, name: str, delta=1):
        with self._lock:
            return self._count_locked(name, delta)

    def counter_set(self, name: str, value, **attrs):
        with self._lock:
            self._counters[name] = value
        self.emit("counter", name, value, {"set": True, **attrs})

    def gauge_set(self, name: str, value, **attrs):
        with self._lock:
            self._gauges[name] = value
        self.emit("gauge", name, value, attrs)

    def observe(self, name: str, value, kind: str = "hist", **attrs):
        with self._lock:
            self._hists.setdefault(name, _Hist()).observe(value)
            self._win_samples.setdefault(
                name, deque(maxlen=_WIN_SAMPLE_CAP)).append(
                    (time.time(), float(value)))
        self.emit(kind, name, round(float(value), 4), attrs)

    def event(self, kind: str, name: str, value, attrs):
        with self._lock:
            self._events.append({"ts": time.time(), "kind": kind,
                                 "name": name, "value": value,
                                 "attrs": dict(attrs or {})})
        self.emit(kind, name, value, attrs)

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
        """Clear the in-memory aggregates (tests); the sink stays."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._win.clear()
            self._win_samples.clear()
            self._events.clear()

    def flush(self):
        """A final ``snapshot`` record and the profiler's summary rows,
        then the buffer to disk (registered with atexit)."""
        if not self.enabled():
            return
        settle()
        # the profiler's rows first: its drop accounting calls back into
        # this registry, so never hold both locks
        try:
            from .. import profiler as _prof

            prof_rows = _prof.summarize()
        except Exception:   # noqa: BLE001 - a flush at exit never raises
            prof_rows = {}
        self.emit("snapshot", "telemetry", None, self.snapshot())
        for name, row in prof_rows.items():
            self.emit("profiler_summary", name, row.get("total_us"),
                      {k: v for k, v in row.items() if k != "total_us"})
        self.flush_sink()


def _prom_name(name: str) -> str:
    return "pt_" + re.sub(r"[^a-zA-Z0-9_]", "_", name)


def _prom_num(v) -> str:
    if isinstance(v, float):
        return repr(round(v, 6))
    return str(v)


# live MetricsServer count: costmodel's 'auto' capture level treats a
# process that started a scrape surface as instrumented
_metrics_servers = [0]
_metrics_servers_lock = threading.Lock()


def metrics_server_active() -> bool:
    return _metrics_servers[0] > 0


class MetricsServer:
    """A stdlib HTTP scrape surface over the live registry: ``/metrics``
    (Prometheus text), ``/healthz`` and ``/varz`` (snapshot and rolling
    window as JSON). Starting one arms the SLO watchdog plane
    (``incidents.arm``, under FLAGS_slo_watchdog 'auto'); ``shutdown``
    disarms it."""

    def __init__(self, registry: "_Registry", host: str = "127.0.0.1",
                 port: int = 0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        reg = registry

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _send(self, code, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    self._send(200, reg.prometheus_text().encode(),
                               "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/healthz":
                    self._send(200, b'{"status": "ok"}', "application/json")
                elif path == "/varz":
                    body = json.dumps({"snapshot": reg.snapshot(),
                                       "window": reg.windowed()},
                                      default=str).encode()
                    self._send(200, body, "application/json")
                else:
                    self._send(404, b'{"error": "no route"}',
                               "application/json")

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="pt-metrics-http", daemon=True)
        self._thread.start()
        with _metrics_servers_lock:
            _metrics_servers[0] += 1
        from . import incidents

        incidents.arm()

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def shutdown(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
        with _metrics_servers_lock:
            _metrics_servers[0] = max(0, _metrics_servers[0] - 1)
        from . import incidents

        incidents.disarm()


_REG = _Registry()


def counter_add(name: str, delta=1, **attrs):
    return _REG.counter_add(name, delta, **attrs)


def counter_quiet(name: str, delta=1):
    """An increment that writes no record (span counts, sink failures)."""
    return _REG.counter_quiet(name, delta)


def counter_set(name: str, value, **attrs):
    return _REG.counter_set(name, value, **attrs)


def counter_get(name: str):
    """A counter's cumulative value (0 if never added to)."""
    with _REG._lock:
        return _REG._counters.get(name, 0)


def counters() -> Dict[str, Any]:
    with _REG._lock:
        return dict(_REG._counters)


def gauge_set(name: str, value, **attrs):
    _REG.gauge_set(name, value, **attrs)


def gauges() -> Dict[str, Any]:
    with _REG._lock:
        return dict(_REG._gauges)


def observe(name: str, value, kind: str = "hist", **attrs):
    _REG.observe(name, value, kind=kind, **attrs)


@contextlib.contextmanager
def timer(name: str, **attrs):
    """Observe the wall time of the block, in ms, as a ``timer`` record."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _REG.observe(name, (time.perf_counter() - t0) * 1e3, kind="timer",
                     **attrs)


def event(kind: str, name: str, value=None, attrs=None):
    """One record of ``kind`` (a finished trace span, a compile, an
    injected fault, an incident), also kept in the in-memory ring."""
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


def enabled() -> bool:
    """Whether a JSONL sink is configured."""
    return _REG.enabled()


def configure(path: Optional[str]):
    """Point the JSONL sink at ``path`` (None or '' closes it): sets
    FLAGS_telemetry_path, which wins over PT_TELEMETRY_LOG."""
    _REG.configure(path)


def flush_sink():
    """Write the buffered lines now."""
    _REG.flush_sink()


def flush():
    _REG.flush()


def reset():
    _REG.reset()


def start_metrics_server(port: int = 0,
                         host: str = "127.0.0.1") -> MetricsServer:
    """Serve GET /metrics, /healthz and /varz from this process's live
    registry on ``host:port`` (0: an ephemeral port). Returns the
    started server (``.url``, ``.shutdown()``)."""
    return MetricsServer(_REG, host=host, port=port)


atexit.register(flush)
