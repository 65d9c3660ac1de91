"""Distributed tracing: propagated per-request span contexts (port of
``paddle_tpu/core/trace.py``).

A *trace* is one logical request made of *spans* (named, timed, nested
operations) that share a ``trace_id`` across threads and processes. The
serving HTTP server opens a root span per request (``serving.http_request``)
and the router a ``router.dispatch`` child span per attempt; a client's
``X-Request-Id`` header forces sampling and pins the trace id, and the
router forwards it on the replica hop, so both processes' spans carry
one id.

* A ``SpanContext`` is ``(trace_id, span_id)``, carried in a
  ``contextvars.ContextVar`` (nesting follows the call structure of each
  thread).
* Sampling happens once, at the root (``FLAGS_trace_sample_rate``, 0 by
  default); children and remote continuations never re-roll.
* Off costs one ContextVar read and one flag lookup: ``span()`` returns a
  shared no-op context manager.
* A finished sampled span counts ``trace.spans`` and is emitted as a
  ``kind:"span"`` telemetry record (to the run-log sink when one is
  configured, the flight recorder, and ``telemetry.recent_events``):
  value = duration in ms, attrs = trace, span, parent, start, pid, tid
  and the caller's; ``tools/trace_view.py`` merges the logs of several
  processes into one chrome://tracing file.
* ``record(name, parent, start_s, end_s)`` emits a span timed after the
  fact under a context captured earlier, possibly on another thread.
* Every finished span notes its trace id in a bounded ring;
  ``recent_trace_ids(window_s)`` names the traces live around a moment,
  which an incident record attaches (core/incidents.py).

Not in the port yet: the reference's cross-process header propagation
(``inject`` / ``extract`` / ``span_from``), whose caller is the PS RPC
transport (ROADMAP A9).
"""

from __future__ import annotations

import contextvars
import os
import random
import re
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from . import flags as _flags
from . import telemetry

_ID_RE = re.compile(r"^[A-Za-z0-9_.-]{1,64}$")


class SpanContext:
    """Identity of one sampled span: (trace_id, span_id)."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self):
        return f"SpanContext(trace={self.trace_id}, span={self.span_id})"


_ctx: "contextvars.ContextVar[Optional[SpanContext]]" = \
    contextvars.ContextVar("pt_trace_ctx", default=None)
_rng = random.Random()   # urandom-seeded; ids need uniqueness, not secrecy

# (finish ts, trace id) of each finished sampled span, for the incident
# pipeline's "active traces"
_recent_lock = threading.Lock()
_recent_traces: deque = deque(maxlen=256)


def _note_trace(trace_id: str):
    with _recent_lock:
        _recent_traces.append((time.time(), trace_id))


def recent_trace_ids(window_s: float = 120.0,
                     now: Optional[float] = None) -> List[str]:
    """Unique trace ids whose spans finished within the last
    ``window_s`` seconds, newest first."""
    if now is None:
        now = time.time()
    cut = now - max(window_s, 0.0)
    with _recent_lock:
        items = list(_recent_traces)
    out, seen = [], set()
    for ts, tid in reversed(items):
        if ts >= cut and tid not in seen:
            seen.add(tid)
            out.append(tid)
    return out

def _new_id() -> str:
    return f"{_rng.getrandbits(64):016x}"


def _clean_trace_id(raw: str) -> str:
    """An externally supplied trace id (X-Request-Id) must be safe to
    embed in JSONL/headers/filenames; anything odd maps deterministically
    to a hex digest so correlation still works."""
    raw = str(raw).strip()
    if _ID_RE.match(raw):
        return raw
    import hashlib

    return hashlib.md5(raw.encode("utf-8", "replace")).hexdigest()[:16]


class _NullSpan:
    """Shared no-op context manager — the entire cost of tracing-off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, et, ev, tb):
        return False


_NULL = _NullSpan()


class _Span:
    """An open sampled span; emits its record on __exit__."""

    __slots__ = ("name", "ctx", "parent_id", "attrs", "_token", "_start",
                 "_t0")

    def __init__(self, name: str, ctx: SpanContext,
                 parent_id: Optional[str], attrs: Dict[str, Any]):
        self.name = name
        self.ctx = ctx
        self.parent_id = parent_id
        self.attrs = attrs

    def __enter__(self) -> SpanContext:
        self._token = _ctx.set(self.ctx)
        self._start = time.time()
        self._t0 = time.perf_counter()
        return self.ctx

    def __exit__(self, et, ev, tb):
        _ctx.reset(self._token)
        dur_ms = (time.perf_counter() - self._t0) * 1e3
        attrs = {"trace": self.ctx.trace_id, "span": self.ctx.span_id,
                 "parent": self.parent_id,
                 "start": round(self._start, 6),
                 "pid": os.getpid(),
                 "tid": threading.current_thread().name}
        if self.attrs:
            attrs.update(self.attrs)
        if et is not None:
            attrs["error"] = et.__name__
        telemetry.counter_quiet("trace.spans")
        _note_trace(self.ctx.trace_id)
        telemetry.event("span", self.name, round(dur_ms, 4), attrs)
        return False


def _sampled_root() -> bool:
    rate = _flags.flag("trace_sample_rate")
    if rate <= 0.0:
        return False
    return rate >= 1.0 or _rng.random() < rate


# -- the public surface ------------------------------------------------------

def current() -> Optional[SpanContext]:
    """The active sampled span context of this thread, if any (the
    parent a later ``record`` takes)."""
    return _ctx.get()


def span(name: str, **attrs):
    """Open a span. Inside an active trace: a child. Outside: a root,
    subject to FLAGS_trace_sample_rate — unsampled/off returns a shared
    no-op context manager whose __enter__ yields None."""
    parent = _ctx.get()
    if parent is None:
        if not _sampled_root():
            return _NULL
        return _Span(name, SpanContext(_new_id(), _new_id()), None, attrs)
    return _Span(name, SpanContext(parent.trace_id, _new_id()),
                 parent.span_id, attrs)


def root_span(name: str, trace_id: Optional[str] = None,
              force: bool = False, **attrs):
    """Start a NEW trace (ignores any active context). ``trace_id`` pins
    the id (an X-Request-Id-style external correlation key) and
    ``force=True`` bypasses sampling — a caller who names their request
    wants it traced."""
    if not force and not _sampled_root():
        return _NULL
    tid = _clean_trace_id(trace_id) if trace_id else _new_id()
    return _Span(name, SpanContext(tid, _new_id()), None, attrs)


def record(name: str, parent: Optional[SpanContext], start_s: float,
           end_s: float, **attrs) -> Optional[SpanContext]:
    """Emit a completed span under ``parent`` (a context captured
    earlier, possibly on another thread), from ``start_s`` to ``end_s``
    (epoch seconds). Returns its context, or None (and no record)
    without a parent."""
    if parent is None:
        return None
    ctx = SpanContext(parent.trace_id, _new_id())
    rec_attrs = {"trace": ctx.trace_id, "span": ctx.span_id,
                 "parent": parent.span_id, "start": round(start_s, 6),
                 "pid": os.getpid(),
                 "tid": threading.current_thread().name}
    if attrs:
        rec_attrs.update(attrs)
    telemetry.counter_quiet("trace.spans")
    _note_trace(ctx.trace_id)
    telemetry.event("span", name, round((end_s - start_s) * 1e3, 4),
                    rec_attrs)
    return ctx
