"""Admission control for the serving engines — bounded queue,
deadlines, graceful drain (port of ``paddle_tpu/serving/admission.py``).

* ``AdmissionQueue.submit`` / ``submit_request`` reject with
  ``ServerOverloadedError`` once ``max_depth`` requests are waiting;
* a request still queued past its deadline is failed with
  ``DeadlineExceededError`` at dequeue instead of taking a slot;
* ``close(drain=True)`` stops admission and lets the engine finish the
  backlog; ``drain=False`` fails the backlog with ``EngineClosedError``.

Two take sides: ``take_batch`` (the micro-batching ``ServingEngine``)
gathers the FIFO-ordered requests that share the head request's shape
signature, holding the batch open up to ``timeout_ms`` past the head's
enqueue for more rows; ``poll`` / ``requeue`` / ``wait_for_work`` serve
the decode engine. ``metric_prefix`` names the counter family
(``serving.*`` or ``decode.*``).

The typed errors are what the HTTP server (serving/server.py) maps to
status codes, as the reference does: ``ValueError`` 400,
``KVCacheExhaustedError`` 429 (``error_type`` "KVCacheExhaustedError"),
``ServerOverloadedError`` 429 (``Retry-After``), ``EngineClosedError``
503, ``DeadlineExceededError`` 504, anything else 500.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core import telemetry


class ServingError(RuntimeError):
    """Base of the serving engine's typed request failures."""


class ServerOverloadedError(ServingError):
    """Queue depth hit its bound — retry later."""


class DeadlineExceededError(ServingError):
    """The request's deadline elapsed."""


class EngineClosedError(ServingError):
    """The engine is shut down (or draining) and takes no new work."""


class KVCacheExhaustedError(ServingError):
    """The request's worst-case KV page need can never fit the pool."""


class InferenceRequest:
    """One queued request: its feeds, its rows, a deadline and a future
    the caller blocks on. ``served_version`` is the engine's model
    version when its batch ran, ``served_bucket`` the leading dim its
    batch was padded to (the port's addition: a response is bit for bit
    the predictor's run of its rows padded to that bucket)."""

    __slots__ = ("feeds", "rows", "deadline", "enqueue_t",
                 "served_version", "served_bucket", "_event", "_result",
                 "_error")

    def __init__(self, feeds: Dict[str, Any], rows: int,
                 deadline: Optional[float]):
        self.feeds = feeds
        self.rows = rows
        self.deadline = deadline          # absolute time.monotonic() or None
        self.enqueue_t = time.monotonic()
        self.served_version: Optional[int] = None
        self.served_bucket: Optional[int] = None
        self._event = threading.Event()
        self._result: Any = None
        self._error: Optional[BaseException] = None

    def resolve(self, result: Any):
        self._result = result
        self._event.set()

    def fail(self, error: BaseException):
        self._error = error
        self._event.set()

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline is not None
                and (now if now is not None else time.monotonic())
                >= self.deadline)

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        """Block for the response; raises the typed failure on error."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"request still pending after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result


class AdmissionQueue:
    """Bounded FIFO with deadline enforcement and drain semantics; counts
    under ``<metric_prefix>.*``."""

    def __init__(self, max_depth: int, default_deadline_ms: float = 0.0,
                 metric_prefix: str = "serving"):
        self.max_depth = int(max_depth)
        self.default_deadline_ms = float(default_deadline_ms)
        self.metric_prefix = metric_prefix
        self._items: List[InferenceRequest] = []
        self._cond = threading.Condition()
        self._closed = False

    def deadline_for(self, deadline_ms: Optional[float]) -> Optional[float]:
        """Caller deadline (ms from now, None = default) -> absolute
        time.monotonic() instant, or None."""
        ms = self.default_deadline_ms if deadline_ms is None \
            else float(deadline_ms)
        return time.monotonic() + ms / 1e3 if ms > 0 else None

    def submit(self, feeds: Dict[str, Any], rows: int,
               deadline_ms: Optional[float] = None) -> InferenceRequest:
        return self.submit_request(InferenceRequest(
            feeds, rows, self.deadline_for(deadline_ms)))

    def submit_request(self, req: InferenceRequest) -> InferenceRequest:
        with self._cond:
            if self._closed:
                raise EngineClosedError(
                    "serving engine is shut down — no new requests")
            if len(self._items) >= self.max_depth:
                telemetry.counter_add(f"{self.metric_prefix}.rejects", 1)
                raise ServerOverloadedError(
                    f"serving queue full ({self.max_depth} requests "
                    f"waiting) — retry later")
            self._items.append(req)
            # the depth gauge is written under the lock, so a taker that
            # empties the queue right after cannot be overwritten by this
            # older depth (a stale 1 tripped the queue-depth SLO rule on
            # an idle queue)
            telemetry.gauge_set(f"{self.metric_prefix}.queue_depth",
                                len(self._items))
            self._cond.notify_all()
        telemetry.counter_add(f"{self.metric_prefix}.requests", 1)
        return req

    def poll(self, max_n: int) -> List[InferenceRequest]:
        """Non-blocking FIFO take of up to ``max_n`` requests; expired
        requests are failed wherever they sit."""
        out: List[InferenceRequest] = []
        with self._cond:
            self._fail_expired(time.monotonic())
            while self._items and len(out) < max_n:
                out.append(self._items.pop(0))
            telemetry.gauge_set(f"{self.metric_prefix}.queue_depth",
                                len(self._items))
        return out

    def _fail_expired(self, now: float):
        """Fail the expired requests wherever they sit (under the lock)."""
        for req in [r for r in self._items if r.expired(now)]:
            self._items.remove(req)
            telemetry.counter_add(f"{self.metric_prefix}.deadline_expired", 1)
            req.fail(DeadlineExceededError(
                "request deadline elapsed after "
                f"{(now - req.enqueue_t) * 1e3:.1f} ms in queue"))

    def requeue(self, reqs: List[InferenceRequest]):
        """Put polled-but-unadmitted requests back at the FIFO head."""
        if not reqs:
            return
        with self._cond:
            self._items[0:0] = list(reqs)
            self._cond.notify_all()

    def wait_for_work(self, timeout_s: Optional[float]) -> bool:
        """Block until work is queued or the queue closes (or timeout);
        True when items are waiting."""
        with self._cond:
            if not self._items and not self._closed:
                self._cond.wait(timeout_s)
            return bool(self._items)

    def take_batch(self, signature: Callable[[InferenceRequest], Any],
                   max_rows: int, timeout_ms: float,
                   ) -> Optional[Tuple[Any, List[InferenceRequest]]]:
        """Gather one same-signature batch (the FIFO head keys it),
        waiting up to ``timeout_ms`` past the head's enqueue for it to
        fill. A request that would push a non-empty batch past
        ``max_rows`` waits for the next one. Returns None only when the
        queue is closed and drained."""
        batch: List[InferenceRequest] = []
        rows = 0
        sig = None
        flush_t = None
        with self._cond:
            while True:
                now = time.monotonic()
                self._fail_expired(now)
                if sig is None and self._items:
                    head = self._items[0]
                    sig = signature(head)
                    flush_t = head.enqueue_t + max(0.0, timeout_ms) / 1e3
                if sig is not None:
                    for req in list(self._items):
                        if rows >= max_rows:
                            break
                        if signature(req) != sig:
                            continue
                        if batch and rows + req.rows > max_rows:
                            continue   # keep it for the next batch
                        self._items.remove(req)
                        batch.append(req)
                        rows += req.rows
                    if rows >= max_rows or now >= flush_t:
                        break
                if self._closed:
                    if batch:
                        break
                    if not self._items:
                        return None
                    continue   # closed, other-signature work remains
                self._cond.wait(None if sig is None
                                else max(0.0, flush_t - now))
            telemetry.gauge_set(f"{self.metric_prefix}.queue_depth",
                                len(self._items))
            self._cond.notify_all()
        return sig, batch

    def close(self, drain: bool = True):
        with self._cond:
            self._closed = True
            if not drain:
                for req in self._items:
                    req.fail(EngineClosedError(
                        "serving engine shut down before this request "
                        "was served"))
                self._items.clear()
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def depth(self) -> int:
        with self._cond:
            return len(self._items)
