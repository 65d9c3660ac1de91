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
* A finished sampled span counts ``trace.spans`` and is recorded as a
  ``span`` event (``telemetry.recent_events("span")``): value = duration
  in ms, attrs = trace, span, parent, start, pid, tid and the caller's.

Not in the port yet: the run-log sink that writes spans to JSONL and the
incident pipeline's ring of recently active trace ids (ROADMAP A10), and
the reference's cross-process header propagation (``inject`` /
``extract`` / ``span_from``) and retroactive ``record``, whose callers
are the PS RPC transport (A9) and the micro-batching engine's batch
worker (its queue-wait and batch spans, A10).
"""

from __future__ import annotations

import contextvars
import os
import random
import re
import threading
import time
from typing import Any, Dict, Optional

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
        telemetry.event("span", self.name, round(dur_ms, 4), attrs)
        return False


def _sampled_root() -> bool:
    rate = _flags.flag("trace_sample_rate")
    if rate <= 0.0:
        return False
    return rate >= 1.0 or _rng.random() < rate


# -- the public surface ------------------------------------------------------

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
