"""ServingEngine: dynamic micro-batching over a frozen inference program
(port of ``paddle_tpu/serving/engine.py:46-456``).

* concurrent callers ``submit()`` requests into a bounded
  ``AdmissionQueue`` (admission.py: backpressure and deadlines);
* one worker thread takes the requests that share a shape signature,
  concatenates their rows and pads the batch up to a bucket boundary
  (powers of two on the leading dim by default), so the predictor holds
  one entry (one CUDA graph on the card) per bucket;
* the padded rows are sliced off before the responses resolve, and each
  request records the model version that served it;
* the handler is the ``serving.handler`` fault site (core/faults.py): an
  injected fault fails that batch's requests and the loop keeps serving;
* ``swap_predictor`` warms a new predictor on every bucket while the old
  one serves, then flips predictor and version together under the infer
  lock, so a batch is served by one version (``replica.swap`` fault
  site).

Telemetry: ``serving.requests`` / ``batches`` / ``batched_rows`` /
``padded_rows`` / ``rejects`` / ``deadline_expired`` /
``handler_errors`` / ``warmup_compiles`` / ``swaps`` counters, the
``serving.batch_fill`` histogram, the ``serving.request_ms`` /
``batch_ms`` / ``warmup_ms`` / ``swap_ms`` timers and the
``serving.queue_depth`` gauge, all in the run log when a sink is
configured. The batch loop calls the SLO watchdog's ``incidents.tick``.
With cost capture on, each warmed bucket's footprint is published as
the ``mem.serving.bucket<B>_peak_bytes`` gauge and in the ``memory``
section of ``/v1/stats`` (with the composed ledger). The locks are
plain ``threading.Lock``s (the reference's lockdep-checked ones are
ROADMAP A10b), and the retroactive queue-wait/batch spans of a sampled
trace are not ported.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..core import costmodel, faults, incidents, telemetry
from ..core import flags as _flags
from ..core.flags import flag as _flag
from .admission import (AdmissionQueue, EngineClosedError, InferenceRequest,
                        ServingError)
from .health import DRAINING, READY, STOPPED, SWAPPING, HealthState, ReadyGate


def _pow2_buckets(max_batch: int) -> List[int]:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


class ServingConfig:
    """Engine knobs; the defaults come from the FLAGS_serving_* entries."""

    def __init__(self, max_batch_size: Optional[int] = None,
                 batch_timeout_ms: Optional[float] = None,
                 max_queue_depth: Optional[int] = None,
                 default_deadline_ms: Optional[float] = None,
                 buckets: Optional[Sequence[int]] = None):
        self.max_batch_size = int(
            _flag("serving_max_batch_size") if max_batch_size is None
            else max_batch_size)
        self.batch_timeout_ms = float(
            _flag("serving_batch_timeout_ms") if batch_timeout_ms is None
            else batch_timeout_ms)
        self.max_queue_depth = int(
            _flag("serving_max_queue_depth") if max_queue_depth is None
            else max_queue_depth)
        self.default_deadline_ms = float(
            _flag("serving_default_deadline_ms")
            if default_deadline_ms is None else default_deadline_ms)
        # strict typed parse: a zero-valued or non-monotonic bucket list
        # raises BucketConfigError instead of being reordered
        if buckets is None:
            buckets = _flags.parse_buckets(_flag("serving_buckets"),
                                           "FLAGS_serving_buckets")
        else:
            buckets = _flags.parse_buckets(buckets, "buckets")
        self.buckets = buckets or _pow2_buckets(self.max_batch_size)

    def bucket(self, rows: int) -> int:
        """The smallest boundary >= rows; an oversized request is its own
        bucket."""
        for b in self.buckets:
            if rows <= b:
                return b
        return rows


class ServingEngine:
    """Thread-safe micro-batching front end over an AnalysisPredictor.

    ``start()`` (warming every bucket by default) -> concurrent
    ``submit`` / ``infer`` -> ``close(drain=True)``. Only the worker
    thread, and the warm-up before it starts, run the predictor.
    """

    def __init__(self, predictor, config: Optional[ServingConfig] = None,
                 version: int = 0):
        self.predictor = predictor
        self.config = config or ServingConfig()
        self.queue = AdmissionQueue(self.config.max_queue_depth,
                                    self.config.default_deadline_ms)
        self._thread: Optional[threading.Thread] = None
        self._infer_lock = threading.Lock()
        self._swap_lock = threading.Lock()
        self._feed_names = list(predictor.feed_names)
        self._fetch_names = list(predictor.fetch_names)
        # STARTING until start() has warmed up: a router polling /healthz
        # never routes to a cold replica
        self.health = HealthState()
        self.version = int(version)
        # each warmed bucket's cost record (cost capture on)
        self._bucket_costs: Dict[int, Any] = {}

    @property
    def feed_names(self) -> List[str]:
        return list(self._feed_names)

    @property
    def fetch_names(self) -> List[str]:
        return list(self._fetch_names)

    def submit(self, feeds: Dict[str, Any],
               deadline_ms: Optional[float] = None) -> InferenceRequest:
        """Enqueue one request (non-blocking). ``feeds`` maps every feed
        name to an array whose dim 0 is the request's rows; all feeds
        agree on rows. Raises ServerOverloadedError / EngineClosedError,
        or ValueError for bad feeds."""
        arrs = {}
        rows = None
        for n in self._feed_names:
            if n not in feeds:
                raise ValueError(f"missing input '{n}'; "
                                 f"need {self._feed_names}")
            v = np.asarray(feeds[n])
            if v.ndim == 0:
                raise ValueError(f"input '{n}' needs a leading batch dim")
            if rows is None:
                rows = v.shape[0]
            elif v.shape[0] != rows:
                raise ValueError(
                    f"inputs disagree on rows: '{n}' has {v.shape[0]}, "
                    f"expected {rows}")
            arrs[n] = v
        extra = set(feeds) - set(self._feed_names)
        if extra:
            raise ValueError(f"unknown inputs {sorted(extra)}; "
                             f"feeds are {self._feed_names}")
        return self.queue.submit(arrs, rows, deadline_ms)

    def infer(self, feeds: Dict[str, Any],
              deadline_ms: Optional[float] = None,
              timeout: Optional[float] = None) -> List[np.ndarray]:
        """Blocking submit-and-wait; the fetches in fetch_names order."""
        return self.submit(feeds, deadline_ms).result(timeout)

    def stats(self) -> Dict[str, Any]:
        """The /v1/stats payload: cumulative serving.* counters, request
        and batch latency percentiles, rolling-window rates, and the
        process's kernel launch counters (``kernels``, with the flash
        launches by layout and by dtype instance)."""
        from .. import kernels

        c = telemetry.counters()
        out = {k.split(".", 1)[1]: int(v) for k, v in c.items()
               if k.startswith("serving.") and isinstance(v, (int, float))}
        out["queue_depth"] = self.queue.depth()
        out["model_version"] = self.version
        out["status"] = self.health.state
        out["ready"] = self.health.is_ready()
        out["serving_config"] = {
            "max_batch_size": self.config.max_batch_size,
            "batch_timeout_ms": self.config.batch_timeout_ms,
            "buckets": list(self.config.buckets)}
        hists = telemetry.snapshot()["hists"]
        for key in ("serving.request_ms", "serving.batch_ms"):
            h = hists.get(key)
            if h:
                out[key.split(".", 1)[1]] = {
                    "count": h["count"], "avg": h["avg"], "p50": h["p50"],
                    "p95": h["p95"], "p99": h["p99"], "max": h["max"]}
        win = telemetry.windowed()
        wout = {"seconds": win["window_s"]}
        for key, short in (("serving.requests", "request_rate"),
                           ("serving.batches", "batch_rate")):
            wc = win["counters"].get(key)
            if wc:
                wout[short] = wc["rate"]
        for key in ("serving.request_ms", "serving.batch_ms"):
            wh = win["hists"].get(key)
            if wh:
                wout[key.split(".", 1)[1]] = {
                    "count": wh["count"], "rate": wh["rate"],
                    "p50": wh["p50"], "p95": wh["p95"], "p99": wh["p99"]}
        out["window"] = wout
        out["kernels"] = kernels.launch_counts()
        out["kernel_layouts"] = kernels.layout_counts()
        out["kernel_dtypes"] = kernels.dtype_counts()
        if self._bucket_costs:
            # each warmed bucket's footprint and the composed ledger
            out["memory"] = {
                "buckets": {str(b): {
                    "peak_bytes": rec.peak_bytes,
                    "temp_bytes": rec.temp_bytes,
                    "arg_bytes": rec.arg_bytes,
                    "flops": rec.flops,
                    "roofline": rec.roofline()}
                    for b, rec in sorted(self._bucket_costs.items())},
                "ledger": costmodel.ledger()}
        return out

    # -- lifecycle -----------------------------------------------------------
    def start(self, warmup: bool = True) -> "ServingEngine":
        if self._thread is not None:
            return self
        if self.queue.closed:
            raise EngineClosedError("engine was closed; build a new one")
        if warmup:
            self.warmup()
        self._thread = threading.Thread(target=self._loop,
                                        name="pt-torch-serving-engine",
                                        daemon=True)
        self._thread.start()
        self.health.set(READY)
        return self

    def warmup(self) -> int:
        """Run every bucket once with zero feeds, so the first real
        request never pays a capture. Returns the fresh predictor
        entries (``serving.warmup_compiles``)."""
        fresh, costs = self._warm(self.predictor, locked=True)
        self._publish_bucket_costs(costs)
        return fresh

    def _warm(self, predictor, locked: bool = False, config=None):
        """Run every bucket of ``config`` (the engine's by default)
        through ``predictor`` once: (the fresh entries made, each bucket's
        cost record). ``locked``
        guards runs of the live predictor with the infer lock; a swap
        candidate is private until the flip, and warming it unlocked
        keeps the old one serving."""
        config = config or self.config
        specs = predictor.feed_specs()
        for n, (shape, _dtype) in specs.items():
            if any(d is None or d < 0 for d in shape[1:]):
                telemetry.counter_add("serving.warmup_skipped", 1)
                return 0, {}   # non-batch dynamic dims: nothing to build
        before = telemetry.counter_get("predictor.compiles")
        costs = {}
        with telemetry.timer("serving.warmup_ms"):
            for b in config.buckets:
                feed = {n: np.zeros((b,) + tuple(shape[1:]), dtype=dtype)
                        for n, (shape, dtype) in specs.items()}
                if locked:
                    with self._infer_lock:
                        predictor.run(feed)
                else:
                    predictor.run(feed)
                if predictor._last_cost is not None:
                    costs[b] = predictor._last_cost
        fresh = telemetry.counter_get("predictor.compiles") - before
        if fresh:
            telemetry.counter_add("serving.warmup_compiles", fresh)
        return int(fresh), costs

    def _publish_bucket_costs(self, costs: Dict[int, Any]):
        """The warmed buckets' footprints on the ledger: the
        ``mem.serving.bucket<B>_peak_bytes`` gauges (level full: the peak
        needs the capture's allocator statistics) and /v1/stats'
        ``memory`` section."""
        if not costs:
            return
        self._bucket_costs = dict(costs)
        for b, rec in costs.items():
            if rec.peak_bytes:
                telemetry.gauge_set(f"mem.serving.bucket{b}_peak_bytes",
                                    int(rec.peak_bytes))
        costmodel.refresh_ledger()

    def swap_predictor(self, predictor, version: Optional[int] = None,
                       warmup: bool = True, config=None) -> int:
        """Swap the model with no downtime: warm every bucket on the new
        predictor while the old one serves, then flip predictor, version
        (and ``config``, if given) together under the infer lock; the
        batch in flight finishes on the old predictor. Readiness is
        SWAPPING meanwhile, so a router sends new traffic elsewhere. On
        any failure the old predictor stays live. Returns the fresh
        warm-up entries. The admission bounds are not flipped."""
        with self._swap_lock:
            faults.maybe_fail("replica.swap", version=version)
            # clients feed by name and read outputs by the engine's fetch
            # schema: a swap needs the same feed names and fetch arity
            if list(predictor.feed_names) != self._feed_names or \
                    len(predictor.fetch_names) != len(self._fetch_names):
                raise ValueError(
                    f"swap candidate signature mismatch: feeds "
                    f"{list(predictor.feed_names)} / "
                    f"{len(predictor.fetch_names)} fetches, serving "
                    f"{self._feed_names} / {len(self._fetch_names)} "
                    f"fetches")
            with ReadyGate(self.health, SWAPPING), \
                    telemetry.timer("serving.swap_ms"):
                fresh, costs = self._warm(predictor, locked=False,
                                          config=config) \
                    if warmup else (0, {})
                with self._infer_lock:
                    self.predictor = predictor
                    if config is not None:
                        self.config = config
                    if version is not None:
                        self.version = int(version)
                self._publish_bucket_costs(costs)
            telemetry.counter_add("serving.swaps", 1)
            return fresh

    def close(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop admission; with drain=True the worker serves the backlog
        before exiting, else queued requests fail with EngineClosedError.
        Readiness drops to DRAINING at once and ends STOPPED."""
        self.health.set(DRAINING)
        self.queue.close(drain=drain)
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        self.health.set(STOPPED)

    # -- engine loop ---------------------------------------------------------
    def _signature(self, req: InferenceRequest):
        return tuple((n, req.feeds[n].shape[1:], str(req.feeds[n].dtype))
                     for n in self._feed_names)

    def _loop(self):
        while True:
            taken = self.queue.take_batch(self._signature,
                                          self.config.max_batch_size,
                                          self.config.batch_timeout_ms)
            if taken is None:
                return
            incidents.tick()
            _sig, batch = taken
            if not batch:
                continue
            try:
                self._serve_batch(batch)
            except BaseException as e:   # the loop outlives any batch
                telemetry.counter_add("serving.handler_errors", len(batch))
                for req in batch:
                    if not req.done():
                        req.fail(e if isinstance(e, ServingError)
                                 else ServingError(
                                     f"serving handler failed: {e!r}"))

    def _serve_batch(self, batch: List[InferenceRequest]):
        rows = sum(r.rows for r in batch)
        bucket = self.config.bucket(rows)
        try:
            faults.maybe_fail("serving.handler", batch_rows=rows,
                              requests=len(batch))
            feed = {}
            for n in self._feed_names:
                parts = [r.feeds[n] for r in batch]
                if bucket > rows:
                    parts.append(np.zeros((bucket - rows,)
                                          + parts[0].shape[1:],
                                          dtype=parts[0].dtype))
                feed[n] = parts[0] if len(parts) == 1 \
                    else np.concatenate(parts, axis=0)
            with self._infer_lock, telemetry.timer("serving.batch_ms"):
                # the predictor and its version are read under the lock:
                # a swap flips both at once, so one version serves the
                # whole batch
                version = self.version
                outs = self.predictor.run(feed)
        except Exception as e:
            # per-request error responses; the queue keeps moving
            telemetry.counter_add("serving.handler_errors", len(batch))
            for req in batch:
                req.fail(e)
            return
        telemetry.counter_add("serving.batches", 1)
        telemetry.counter_add("serving.batched_rows", rows)
        if bucket > rows:
            telemetry.counter_add("serving.padded_rows", bucket - rows)
        telemetry.observe("serving.batch_fill", rows / bucket)
        offset = 0
        now = time.monotonic()
        for req in batch:
            sliced = [o[offset:offset + req.rows]
                      if getattr(o, "ndim", 0) >= 1 and len(o) == bucket
                      else o   # not a per-row fetch: handed through whole
                      for o in outs]
            offset += req.rows
            req.served_version = version
            req.served_bucket = bucket
            req.resolve(sliced)
            telemetry.observe("serving.request_ms",
                              (now - req.enqueue_t) * 1e3)
