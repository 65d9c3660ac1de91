"""Request router: the traffic side of the cluster serving plane (port
of ``paddle_tpu/serving/router.py``).

One router fronts N replicas (serving/cluster.py launches and watches
them; this module never owns a process):

* **balance**: a probe thread polls every replica's ``/healthz`` every
  ``FLAGS_router_health_interval_s``; ``pick`` takes the READY replica
  with the lowest load score (scraped queue depth + the router's own
  in-flight count + one per consecutive probe failure), equal scores
  round-robin, and a SWAPPING replica only when nothing is READY;
* **prefix affinity**: ``pick_generate`` hashes a prompt's full-page
  prefix chain (``prefix_store.prefix_chain_hash``) over the ready decode
  tier (the unified tier when there is none), so the turns of a session
  land on the replica whose prefix store holds its pages;
* **fail over**: a dispatch that dies (refused, reset, timeout, a torn
  reply, or 429/500/503) is retried on another replica under the
  request's deadline, on the core/retry.py schedule; the failed replica
  is marked down at once;
* **session resumption**: decode replicas journal their sessions to
  ``POST /v1/session/journal`` (serving/session.py ``SessionJournal``);
  when a generation's replica dies, the retry resumes it on a survivor
  (``resume_args``: prompt + accepted tokens re-prefilled, RNG restored)
  and the journaled prefix is joined to the resumed tail, so the client
  sees one stream, bit for bit the uninterrupted one;
* **dedup**: a request id already answered (client ``X-Request-Id`` or
  body ``request_id``) replays the cached response
  (``router.dedup_hits``) instead of generating again;
* **prefill forwarding**: ``POST /v1/prefill`` goes to a ready
  prefill-tier replica (``forward_prefill``), so decode replicas can
  point their ``prefill_urls`` at the router.

Tracing: the router opens a request's root span and each attempt is a
``router.dispatch`` child span and fault site (core/faults.py).

Telemetry: router.requests / retries / failovers / rejects / dedup_hits
/ replica_up / replica_down / dispatch_errors / prefill_forwards /
affinity_routes / affinity_fallbacks counters, router.request_ms and
router.dispatch_ms timers, session.failovers.

**Trial split** (an online autotune trial, core/tuner.py): with
``set_trial(name, fraction)`` every ``round(1/fraction)``-th ``pick``
goes to the trial replica and every other pick excludes it, so each
arm's latency evidence is pure; when no control replica is routable the
trial replica serves (availability beats arm purity). The order of the
checks is the reference's: a request id's dedup replay first, then the
pick; prefix-affinity picks (``pick_generate``) are not steered, as in
the reference, and fall back to the steered ``pick`` only when no decode
or unified replica is ready. Each handle keeps a ring of its successful
``/v1/infer`` dispatches' ms (``record_dispatch``,
``dispatch_latencies``): the per-arm evidence the trial compares.

The router arms the SLO watchdog when it starts and its probe loop calls
``incidents.tick()`` (core/incidents.py), as the reference's does.

Locks are plain ``threading.Lock`` (lockdep is ROADMAP A10b). Not in the
port yet: the fleet observatory (``attach_fleet`` / ``fleet`` raise
naming ROADMAP A10b, and ``pick`` runs without straggler exclusion).
"""

from __future__ import annotations

import http.client
import json
import threading
import time
import zlib
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

from ..core import faults, incidents, retry, telemetry, trace
from ..core.flags import flag as _flag
from .admission import ServingError


class NoReplicaAvailableError(ServingError):
    """No READY replica to dispatch to (all down/draining/swapping)."""


class ReplicaHandle:
    """The router's view of one replica: endpoint + last probed state."""

    def __init__(self, name: str, url: str, role: str = "unified"):
        self.name = name
        self.url = url.rstrip("/")
        # disaggregated-serving tier (serving/disagg.py): 'prefill'
        # replicas only take /v1/prefill shipments, 'decode' and
        # 'unified' carry /v1/generate traffic (route_generate)
        self.role = str(role or "unified").lower()
        self._lock = threading.Lock()
        self.ready = False
        self.alive = True
        self.status = "unknown"     # /healthz status string (health.py)
        self.queue_depth = 0
        self.inflight = 0           # router-side dispatches in progress
        self.model_version: Optional[int] = None
        self.last_probe_t = 0.0
        self.consecutive_failures = 0
        # bounded ring of (epoch_ts, ms) of successful dispatches: the
        # per-arm latency evidence an online autotune trial compares
        # (router-side, so it works for in-process replicas too, which
        # share one telemetry registry)
        self.dispatch_samples: "deque" = deque(maxlen=512)

    # -- state updates (probe thread + dispatch path) ------------------------
    def mark_probe(self, ready: bool, stats: Optional[Dict[str, Any]] = None):
        with self._lock:
            was_ready = self.ready
            self.ready = ready
            self.alive = True
            self.last_probe_t = time.monotonic()
            self.consecutive_failures = 0
            if stats:
                self.queue_depth = int(stats.get("queue_depth", 0))
                if stats.get("status"):
                    self.status = str(stats["status"])
                if stats.get("model_version") is not None:
                    self.model_version = int(stats["model_version"])
        if ready and not was_ready:
            telemetry.counter_add("router.replica_up", 1, replica=self.name)

    def mark_down(self, reason: str = ""):
        with self._lock:
            was_ready = self.ready
            self.ready = False
            self.status = "down"
            self.consecutive_failures += 1
        if was_ready:
            telemetry.counter_add("router.replica_down", 1,
                                  replica=self.name, reason=reason)

    def swapping(self) -> bool:
        """Not-ready because of a model swap: the replica still SERVES
        (the old version keeps running while the new one warms) — a
        legal last-resort dispatch target when nothing is READY."""
        with self._lock:
            return self.status == "swapping"

    def rebind(self, url: str):
        """Point this slot at a respawned replica (cluster.py)."""
        with self._lock:
            self.url = url.rstrip("/")
            self.ready = False
            self.queue_depth = 0
            self.inflight = 0
            self.consecutive_failures = 0

    def record_dispatch(self, ms: float):
        with self._lock:
            self.dispatch_samples.append((time.time(), float(ms)))

    def dispatch_latencies(self, since_ts: float = 0.0) -> List[float]:
        with self._lock:
            return [ms for ts, ms in self.dispatch_samples
                    if ts >= since_ts]

    # -- balancing -----------------------------------------------------------
    def probe_age_s(self) -> Optional[float]:
        """Seconds since the last SUCCESSFUL probe; None before the
        first. The staleness evidence behind score()'s failure penalty
        and the /v1/stats `last_probe_age_s` field."""
        with self._lock:
            t = self.last_probe_t
        if not t:
            return None
        return round(time.monotonic() - t, 3)

    def score(self) -> int:
        """Load estimate: last scraped queue depth + our own in-flight
        dispatches (covers requests sent since the last probe), plus a
        penalty per consecutive probe failure — a handle whose probe
        just failed keeps its STALE queue depth (mark_down never zeroes
        it), and the penalty stops that stale depth from reading as
        "least loaded" next to replicas with fresh evidence."""
        with self._lock:
            return (self.queue_depth + self.inflight
                    + self.consecutive_failures)

    def snapshot(self) -> Dict[str, Any]:
        age = self.probe_age_s()
        with self._lock:
            return {"name": self.name, "url": self.url, "role": self.role,
                    "ready": self.ready,
                    "queue_depth": self.queue_depth,
                    "inflight": self.inflight,
                    "model_version": self.model_version,
                    "consecutive_failures": self.consecutive_failures,
                    "probe_failures": self.consecutive_failures,
                    "last_probe_age_s": age,
                    "stale": self.consecutive_failures > 0}


def _http_json(method: str, url: str, path: str,
               body: Optional[bytes] = None,
               headers: Optional[Dict[str, str]] = None,
               timeout: float = 10.0) -> Tuple[int, Dict[str, Any]]:
    """One HTTP exchange with a replica; stdlib http.client (a fresh
    localhost connection per attempt — failover correctness over
    keep-alive micro-optimisation). Connection-level failures raise
    (ConnectionError/OSError/socket.timeout); HTTP status is returned."""
    host, _, port = url.rpartition("://")[2].partition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        raw = resp.read()
        try:
            doc = json.loads(raw) if raw else {}
        except ValueError:
            doc = {"error": f"non-JSON reply ({len(raw)} bytes)"}
        return resp.status, doc
    finally:
        conn.close()


class Router:
    """Health-checked, load-balanced, retrying front end over N replica
    endpoints. Thread-safe; serve it with RouterHTTPServer."""

    #: replica HTTP statuses that mean "this attempt failed, another
    #: replica may succeed" — 429 overload, 500 handler failure, 503
    #: draining/closed. 400/404 are the client's fault and 504 means the
    #: deadline died in the replica queue (retrying cannot resurrect it).
    RETRYABLE_STATUS = (429, 500, 503)

    def __init__(self, policy: Optional[retry.RetryPolicy] = None,
                 health_interval_s: Optional[float] = None):
        self.policy = policy or retry.RetryPolicy(
            max_retries=int(_flag("router_max_retries")),
            backoff=float(_flag("router_backoff")),
            deadline=None)   # per-request deadline is applied per call
        self.health_interval_s = float(
            _flag("router_health_interval_s") if health_interval_s is None
            else health_interval_s)
        self._handles: List[ReplicaHandle] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        # request-id dedup: id -> ("inflight", Event) | ("done", code,
        # payload). Bounded FIFO over done entries.
        self._dedup: "OrderedDict[str, tuple]" = OrderedDict()
        self._dedup_lock = threading.Lock()
        self._dedup_cap = int(_flag("router_dedup_capacity"))
        self._ids = 0
        self._rr = 0   # rotating tie-break offset for equal load scores
        # online A/B traffic split (core/tuner.py OnlineTrial): when set,
        # every period-th pick steers to the trial replica and every
        # other pick excludes it, so each arm's latency evidence is pure
        self._trial: Optional[Tuple[str, float]] = None
        self._trial_count = 0
        # decode-session journal (serving/session.py): replicas POST
        # per-request snapshots to /v1/session/journal; on a
        # decode-replica death route_generate re-admits the journaled
        # session on a survivor instead of losing the generation
        from .session import SessionJournal

        self.sessions = SessionJournal()

    # -- membership ----------------------------------------------------------
    def add_replica(self, name: str, url: str,
                    role: str = "unified") -> ReplicaHandle:
        handle = ReplicaHandle(name, url, role=role)
        with self._lock:
            self._handles.append(handle)
        self.probe(handle)
        return handle

    def remove_replica(self, name: str):
        with self._lock:
            self._handles = [h for h in self._handles if h.name != name]

    def handles(self) -> List[ReplicaHandle]:
        with self._lock:
            return list(self._handles)

    # -- health probing ------------------------------------------------------
    def probe(self, handle: ReplicaHandle):
        """One readiness+stats probe; never raises."""
        try:
            code, doc = _http_json("GET", handle.url, "/healthz",
                                   timeout=max(self.health_interval_s * 4,
                                               1.0))
            handle.mark_probe(code == 200, doc)
        except (ConnectionError, OSError) as e:
            handle.mark_down(type(e).__name__)

    def _probe_loop(self):
        while not self._stop.wait(self.health_interval_s):
            for handle in self.handles():
                if self._stop.is_set():
                    return
                self.probe(handle)
            # the SLO watchdog's rules evaluate on the probe cadence
            incidents.tick()

    def start(self) -> "Router":
        if self._probe_thread is None:
            # the router is the cluster's always-on vantage point: arm
            # the SLO watchdog, which the probe loop ticks
            incidents.arm()
            self._probe_thread = threading.Thread(
                target=self._probe_loop, name="pt-router-probe", daemon=True)
            self._probe_thread.start()
        return self

    def close(self):
        self._stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=5)
            self._probe_thread = None
        incidents.disarm()

    # -- A/B traffic split (online autotune trials) --------------------------
    def set_trial(self, replica_name: str, fraction: Optional[float] = None):
        """Steer a bounded slice of traffic onto ``replica_name``: every
        ~1/fraction-th routed request dispatches there, the rest stay on
        the control fleet and skip the trial replica. The fraction clamps
        to [0.01, 0.5]: the control arm always carries the majority."""
        if fraction is None:
            fraction = float(_flag("tuner_traffic_fraction"))
        fraction = min(max(float(fraction), 0.01), 0.5)
        with self._lock:
            self._trial = (replica_name, fraction)
            self._trial_count = 0
        telemetry.counter_add("router.trial_split_set", 1,
                              replica=replica_name, fraction=fraction)

    def clear_trial(self):
        with self._lock:
            self._trial = None

    def trial(self) -> Optional[Tuple[str, float]]:
        with self._lock:
            return self._trial

    # -- fleet observatory (ROADMAP A10b) ------------------------------------
    def attach_fleet(self, aggregator):
        """The reference wires a fleet aggregator here so ``pick`` skips
        flagged stragglers: ``core/fleetobs`` is not in the port yet."""
        raise NotImplementedError(
            "Router.attach_fleet: the fleet observatory (core/fleetobs, "
            "straggler exclusion, /fleet/*) is not in the port yet "
            "(ROADMAP A10b)")

    def fleet(self):
        raise NotImplementedError(
            "Router.fleet: core/fleetobs is not in the port yet "
            "(ROADMAP A10b)")

    # -- balancing -----------------------------------------------------------
    def pick(self, exclude=()) -> Optional[ReplicaHandle]:
        """READY replica with the lowest load score, skipping `exclude`;
        None when nothing is routable. Equal scores round-robin (a
        rotating start offset), so an idle fleet shares work instead of
        hammering the first replica.

        With a trial split set (``set_trial``) the steering schedule
        decides the arm first: a steered pick returns the trial replica
        (when ready), any other pick excludes it, unless no control
        replica is routable, where availability beats arm purity."""
        handles = self.handles()
        if not handles:
            return None
        with self._lock:
            self._rr += 1
            offset = self._rr
            trial = self._trial
            steer = False
            if trial is not None:
                self._trial_count += 1
                period = max(2, int(round(1.0 / trial[1])))
                steer = (self._trial_count % period) == 0
        if trial is not None:
            trial_handle = next((h for h in handles
                                 if h.name == trial[0]), None)
            if trial_handle is not None and trial_handle not in exclude:
                if steer and trial_handle.ready:
                    telemetry.counter_quiet("router.trial_dispatches")
                    return trial_handle
                if not steer:
                    control = self._pick_from(handles, offset,
                                              set(exclude) | {trial_handle})
                    if control is not None:
                        telemetry.counter_quiet(
                            "router.trial_control_dispatches")
                        return control
                    # no control replica routable: the trial replica
                    # carries the request
        return self._pick_from(handles, offset, exclude)

    def _pick_from(self, handles, offset, exclude) -> Optional[ReplicaHandle]:
        best = None
        best_score = None
        for j in range(len(handles)):
            handle = handles[(offset + j) % len(handles)]
            if handle in exclude or not handle.ready:
                continue
            s = handle.score()
            if best_score is None or s < best_score:
                best, best_score = handle, s
        if best is not None:
            return best
        # nothing READY: fall back to a SWAPPING replica — it is alive
        # and still serving its old model version while the new one
        # warms. Without this, a kill overlapping a rolling swap leaves
        # a zero-ready window that 503s traffic the fleet could serve.
        for j in range(len(handles)):
            handle = handles[(offset + j) % len(handles)]
            if handle in exclude or not handle.swapping():
                continue
            s = handle.score()
            if best_score is None or s < best_score:
                best, best_score = handle, s
        if best is not None:
            telemetry.counter_add("router.swapping_fallback", 1,
                                  replica=best.name)
        return best

    # -- dedup cache ---------------------------------------------------------
    def _dedup_claim(self, request_id: str):
        """None -> this caller owns the id (dispatch it). Otherwise the
        cached ("done", code, payload) to replay — waiting out an
        in-flight original first, like the PS server's dedup."""
        if self._dedup_cap <= 0:
            return None
        while True:
            with self._dedup_lock:
                entry = self._dedup.get(request_id)
                if entry is None:
                    self._dedup[request_id] = ("inflight", threading.Event())
                    return None
                if entry[0] == "done":
                    return entry
                event = entry[1]
            if not event.wait(timeout=60.0):
                return None   # wedged original; dispatch rather than hang

    def _dedup_publish(self, request_id: str, code: int,
                       payload: Dict[str, Any]):
        if self._dedup_cap <= 0:
            return
        with self._dedup_lock:
            entry = self._dedup.get(request_id)
            if code == 200:
                self._dedup[request_id] = ("done", code, payload)
                while len(self._dedup) > self._dedup_cap:
                    # evict the oldest DONE entry; in-flight ones are live
                    for key in self._dedup:
                        if self._dedup[key][0] == "done":
                            del self._dedup[key]
                            break
                    else:
                        break
            else:
                # failures are not cached: the client's retry should get
                # a fresh dispatch, not a replayed error
                self._dedup.pop(request_id, None)
            if entry is not None and entry[0] == "inflight":
                entry[1].set()

    def _wait_for_replica(self, sched: retry.RetrySchedule) -> bool:
        """Block (probing) until SOME replica is routable or the
        schedule's deadline passes (5 s cap when it has none). Returns
        True when a dispatch target exists again. Does not consume retry
        attempts — an outage window is not the request's fault."""
        waited_any = False
        end = time.monotonic() + (sched.remaining(default=5.0) or 5.0)
        while time.monotonic() < end:
            for handle in self.handles():
                self.probe(handle)
            if self.pick() is not None:
                if waited_any:
                    telemetry.counter_add("router.outage_waits", 1)
                return True
            waited_any = True
            time.sleep(0.05)
        return False

    # -- the dispatch --------------------------------------------------------
    def new_request_id(self) -> str:
        with self._lock:
            self._ids += 1
            return f"rt-{id(self) & 0xFFFFFF:06x}-{self._ids}"

    def route_infer(self, inputs: Dict[str, Any],
                    deadline_ms: Optional[float] = None,
                    request_id: Optional[str] = None,
                    forward_request_id: Optional[bool] = None,
                    ) -> Tuple[int, Dict[str, Any]]:
        """Route one inference request: returns (http_code, payload).

        Retries transport failures and retryable replica statuses on the
        surviving fleet under min(deadline_ms, FLAGS_router_timeout_s);
        replays the cached response for an already-answered request id.
        Never raises — the answer is always an HTTP-shaped (code, doc)."""
        t0 = time.perf_counter()
        client_supplied = request_id is not None
        if forward_request_id is None:
            forward_request_id = client_supplied
        rid = request_id if client_supplied else self.new_request_id()
        telemetry.counter_add("router.requests", 1)

        cached = self._dedup_claim(rid)
        if cached is not None:
            telemetry.counter_add("router.dedup_hits", 1)
            payload = dict(cached[2])
            payload["deduped"] = True
            return cached[1], payload

        budget_s = float(_flag("router_timeout_s"))
        if deadline_ms is not None and deadline_ms > 0:
            budget_s = min(budget_s, deadline_ms / 1e3) \
                if budget_s > 0 else deadline_ms / 1e3
        policy = retry.RetryPolicy(
            max_retries=self.policy.max_retries,
            backoff=self.policy.backoff,
            deadline=budget_s if budget_s > 0 else None,
            max_delay=self.policy.max_delay, jitter=self.policy.jitter)
        sched = policy.start()
        per_try_cap = float(_flag("router_dispatch_timeout_s"))

        tried: set = set()
        prev_handle: Optional[ReplicaHandle] = None
        failed_over = False
        code, payload = 503, {"error": "no replica available"}
        while True:
            handle = self.pick(exclude=tried)
            if handle is None and tried:
                tried = set()               # second lap: allow re-tries
                handle = self.pick()
            if handle is None:
                # no routable replica RIGHT NOW — a kill, a swap warmup
                # or a respawn window. Wait it out under the request
                # deadline (actively re-probing) rather than shedding
                # traffic the fleet can serve in a moment.
                if self._wait_for_replica(sched):
                    continue
                telemetry.counter_add("router.rejects", 1)
                code, payload = 503, {
                    "error": "no replica available (all down, draining "
                             "or swapping)", "request_id": rid}
                break
            if prev_handle is not None and handle is not prev_handle:
                failed_over = True
                telemetry.counter_add("router.failovers", 1,
                                      frm=prev_handle.name, to=handle.name)
            prev_handle = handle
            attempt_timeout = sched.remaining(default=per_try_cap)
            if attempt_timeout is None:
                attempt_timeout = per_try_cap
            else:
                attempt_timeout = min(attempt_timeout, per_try_cap)
            body_doc = {"inputs": inputs}
            rem_ms = sched.remaining(default=None)
            if rem_ms is not None:
                body_doc["deadline_ms"] = max(rem_ms * 1e3, 1.0)
            headers = {}
            if forward_request_id:
                # the replica pins its root span to this id -> one trace
                # id across the hop (trace_view merges both logs)
                headers["X-Request-Id"] = rid
            retryable_exc: Optional[BaseException] = None
            try:
                with trace.span("router.dispatch", replica=handle.name,
                                request=rid):
                    faults.maybe_fail("router.dispatch",
                                      replica=handle.name)
                    with handle._lock:
                        handle.inflight += 1
                    try:
                        t_disp = time.perf_counter()
                        with telemetry.timer("router.dispatch_ms"):
                            code, payload = _http_json(
                                "POST", handle.url, "/v1/infer",
                                body=json.dumps(body_doc).encode(),
                                headers=headers, timeout=attempt_timeout)
                        if code == 200:
                            # per-arm latency evidence of an online
                            # autotune trial (core/tuner.py)
                            handle.record_dispatch(
                                (time.perf_counter() - t_disp) * 1e3)
                    finally:
                        with handle._lock:
                            handle.inflight -= 1
            except (ConnectionError, OSError,
                    http.client.HTTPException) as e:  # incl. socket.timeout
                # a SIGKILLed replica shows up as refused/reset/timeout or
                # a torn HTTP response — all retryable on a survivor
                retryable_exc = e
                handle.mark_down(type(e).__name__)
                telemetry.counter_add("router.dispatch_errors", 1,
                                      replica=handle.name,
                                      exc=type(e).__name__)
            if retryable_exc is None:
                if code == 200:
                    payload.setdefault("request_id", rid)
                    payload["replica"] = handle.name
                    break
                if code not in self.RETRYABLE_STATUS:
                    payload.setdefault("request_id", rid)
                    break               # 400/404/504: retrying cannot help
                telemetry.counter_add("router.dispatch_errors", 1,
                                      replica=handle.name, status=code)
            tried.add(handle)
            outcome, delay = sched.note_failure()
            if outcome == retry.DEADLINE:
                telemetry.counter_add("router.deadline_exceeded", 1)
                code, payload = 504, {
                    "error": f"request exceeded its {budget_s:.3f}s "
                             f"deadline after {sched.attempt} attempts",
                    "request_id": rid}
                break
            if outcome == retry.EXHAUSTED:
                code, payload = 502, {
                    "error": f"request failed on every replica after "
                             f"{sched.attempt} attempts "
                             f"(last: {retryable_exc or code})",
                    "request_id": rid}
                break
            telemetry.counter_add("router.retries", 1)
            time.sleep(delay)
        if failed_over and code == 200:
            payload["failed_over"] = True
        self._dedup_publish(rid, code, payload)
        telemetry.observe("router.request_ms",
                          (time.perf_counter() - t0) * 1e3, kind="timer",
                          code=code)
        return code, payload

    # -- generative plane: prefix-affinity routing ---------------------------
    def pick_generate(self, prompt_ids,
                      exclude=()) -> Optional[ReplicaHandle]:
        """Prefix-AFFINITY pick for /v1/generate (serving/disagg.py
        topology): hash the prompt's full-page prefix chain
        (serving/prefix_store.prefix_chain_hash) over the ready
        decode-tier replicas, so a session's turns keep landing on the
        replica whose prefix store already holds its KV pages. Falls
        back to the unified tier when the decode tier is empty
        (``router.affinity_fallbacks``), then to the generic
        lowest-load pick. Prefill-tier replicas never carry generate
        traffic."""
        handles = [h for h in self.handles() if h not in exclude]
        decode_tier = sorted((h for h in handles
                              if h.ready and h.role == "decode"),
                             key=lambda h: h.name)
        unified_tier = sorted((h for h in handles
                               if h.ready and h.role == "unified"),
                              key=lambda h: h.name)
        tier = decode_tier or unified_tier
        if not tier:
            return self.pick(exclude=set(exclude) | {
                h for h in handles if h.role == "prefill"})
        if not decode_tier and any(h.role == "decode"
                                   for h in self.handles()):
            # a decode tier EXISTS but none of it is ready right now
            telemetry.counter_add("router.affinity_fallbacks", 1)
        from .prefix_store import ROOT_HASH, prefix_chain_hash

        tokens = [int(t) for t in prompt_ids]
        chain = prefix_chain_hash(tokens, int(_flag("decode_page_size")))
        if chain == ROOT_HASH:
            # prompt shorter than one full page: no KV pages to be
            # affine to — spread by a stable hash of the raw prompt
            # (must be process-independent: the failover re-pick and a
            # respawned router have to agree)
            key = zlib.crc32(",".join(map(str, tokens)).encode())
        else:
            key = int(chain, 16)
        handle = tier[key % len(tier)]
        telemetry.counter_quiet("router.affinity_routes")
        return handle

    def route_generate(self, prompt_ids,
                       max_new_tokens: Optional[int] = None,
                       temperature: float = 0.0,
                       seed: Optional[int] = None,
                       deadline_ms: Optional[float] = None,
                       request_id: Optional[str] = None,
                       stop_at_eos: bool = True,
                       ) -> Tuple[int, Dict[str, Any]]:
        """Route one generation to the decode plane with prefix
        affinity; retries transport failures and retryable statuses on
        the remaining tier. Never raises — always (code, payload).

        Exactly-once under client retries: an X-Request-Id already
        answered replays the cached response (same dedup cache as
        /v1/infer — a client retry during a failover can't
        double-generate). Crash survival: when a dispatch fails and the
        session journal (serving/session.py) holds accepted tokens for
        this id, the retry RESUMES the generation on a survivor —
        prompt+accepted re-prefilled, RNG state restored — and the
        journaled prefix is re-joined with the resumed tail, so the
        client sees one uninterrupted, bitwise-identical token
        stream."""
        telemetry.counter_add("router.requests", 1, plane="generate")
        client_supplied = request_id is not None
        rid = request_id if client_supplied else self.new_request_id()

        cached = self._dedup_claim(rid)
        if cached is not None:
            telemetry.counter_add("router.dedup_hits", 1,
                                  plane="generate")
            payload = dict(cached[2])
            payload["deduped"] = True
            return cached[1], payload

        budget_s = float(_flag("router_timeout_s"))
        if deadline_ms is not None and deadline_ms > 0:
            budget_s = min(budget_s, deadline_ms / 1e3) \
                if budget_s > 0 else deadline_ms / 1e3
        policy = retry.RetryPolicy(
            max_retries=self.policy.max_retries,
            backoff=self.policy.backoff,
            deadline=budget_s if budget_s > 0 else None,
            max_delay=self.policy.max_delay, jitter=self.policy.jitter)
        sched = policy.start()
        per_try_cap = float(_flag("router_dispatch_timeout_s"))
        body_doc: Dict[str, Any] = {
            "prompt_ids": [int(t) for t in prompt_ids],
            "temperature": float(temperature),
            "stop_at_eos": bool(stop_at_eos),
            "request_id": rid}
        if max_new_tokens is not None:
            body_doc["max_new_tokens"] = int(max_new_tokens)
        if seed is not None:
            body_doc["seed"] = int(seed)
        tried: set = set()
        resumed_prefix: List[int] = []
        failed_over = False
        code, payload = 503, {"error": "no replica available"}
        while True:
            # affinity stays keyed on the ORIGINAL prompt across
            # failovers — prior_tokens ride separately in the body
            handle = self.pick_generate(body_doc["prompt_ids"],
                                        exclude=tried)
            if handle is None and tried:
                tried = set()
                handle = self.pick_generate(body_doc["prompt_ids"])
            if handle is None:
                # respawn/failover window with no generate-capable
                # replica: wait it out under the deadline, re-probing —
                # the cluster controller is usually mid-respawn
                if self._wait_for_replica(sched):
                    continue
                telemetry.counter_add("router.rejects", 1)
                code, payload = 503, {
                    "error": "no generate-capable replica available",
                    "request_id": rid}
                break
            attempt_timeout = sched.remaining(default=per_try_cap)
            attempt_timeout = per_try_cap if attempt_timeout is None \
                else min(attempt_timeout, per_try_cap)
            rem = sched.remaining(default=None)
            if rem is not None:
                body_doc["deadline_ms"] = max(rem * 1e3, 1.0)
            retryable_exc: Optional[BaseException] = None
            try:
                with trace.span("router.dispatch", replica=handle.name,
                                request=rid):
                    faults.maybe_fail("router.dispatch",
                                      replica=handle.name)
                    with telemetry.timer("router.dispatch_ms"):
                        code, payload = _http_json(
                            "POST", handle.url, "/v1/generate",
                            body=json.dumps(body_doc).encode(),
                            headers={"X-Request-Id": rid},
                            timeout=attempt_timeout)
            except (ConnectionError, OSError,
                    http.client.HTTPException) as e:
                retryable_exc = e
                handle.mark_down(type(e).__name__)
                telemetry.counter_add("router.dispatch_errors", 1,
                                      replica=handle.name,
                                      exc=type(e).__name__)
            if retryable_exc is None:
                if code == 200 or code not in self.RETRYABLE_STATUS:
                    payload["replica"] = handle.name
                    break
                telemetry.counter_add("router.dispatch_errors", 1,
                                      replica=handle.name, status=code)
            tried.add(handle)
            # session failover: if the dead replica journaled accepted
            # tokens for this id, the next attempt resumes instead of
            # regenerating — re-consulted every lap, so a survivor that
            # ALSO dies mid-resume hands off its own progress too
            record = self.sessions.get(rid)
            if record and record.get("accepted"):
                from .session import resume_args

                kw = resume_args(record)
                if kw["max_new_tokens"] >= 1:
                    resumed_prefix = list(kw["prior_tokens"])
                    body_doc["prior_tokens"] = kw["prior_tokens"]
                    body_doc["max_new_tokens"] = kw["max_new_tokens"]
                    if kw.get("rng_state") is not None:
                        body_doc["rng_state"] = kw["rng_state"]
                    failed_over = True
                    telemetry.counter_add("session.failovers", 1,
                                          replica=handle.name)
            outcome, delay = sched.note_failure()
            if outcome == retry.DEADLINE:
                telemetry.counter_add("router.deadline_exceeded", 1)
                code, payload = 504, {
                    "error": f"generation exceeded its {budget_s:.3f}s "
                             f"deadline after {sched.attempt} attempts",
                    "request_id": rid}
                break
            if outcome == retry.EXHAUSTED:
                code, payload = 502, {
                    "error": f"generation failed on every replica after "
                             f"{sched.attempt} attempts "
                             f"(last: {retryable_exc or code})",
                    "request_id": rid}
                break
            telemetry.counter_add("router.retries", 1)
            time.sleep(delay)
        if code == 200:
            if resumed_prefix:
                # re-join the journaled prefix with the resumed tail —
                # ONE uninterrupted stream, bitwise-identical to the
                # generation the dead replica would have produced
                payload["tokens"] = resumed_prefix + list(
                    payload.get("tokens", []))
                payload["num_tokens"] = len(payload["tokens"])
                payload["resumed"] = True
            if failed_over:
                payload["failed_over"] = True
            payload.setdefault("request_id", rid)
            self.sessions.pop(rid)
        self._dedup_publish(rid, code, payload)
        return code, payload

    def forward_prefill(self, raw_body: bytes,
                        timeout: Optional[float] = None
                        ) -> Tuple[int, bytes, str]:
        """Forward a /v1/prefill shipment pull to a ready prefill-tier
        replica (lowest load first) — the live-cluster path that lets
        decode replicas point at the ROUTER instead of pinning peer
        URLs, so prefill-tier membership changes (respawn, scale)
        never strand them. Returns (status, body_bytes, content_type);
        CRC verification stays end-to-end in the decode replica."""
        cap = float(_flag("router_dispatch_timeout_s"))
        timeout = cap if timeout is None else min(timeout, cap)
        tier = sorted((h for h in self.handles()
                       if h.ready and h.role == "prefill"),
                      key=lambda h: h.score())
        if not tier:
            return 503, json.dumps(
                {"error": "no prefill-tier replica available"}).encode(), \
                "application/json"
        last: Any = None
        for handle in tier:
            try:
                host, _, port = \
                    handle.url.rpartition("://")[2].partition(":")
                conn = http.client.HTTPConnection(host, int(port),
                                                  timeout=timeout)
                try:
                    conn.request("POST", "/v1/prefill", body=raw_body,
                                 headers={"Content-Type":
                                          "application/json"})
                    resp = conn.getresponse()
                    data = resp.read()
                    ctype = resp.getheader("Content-Type",
                                           "application/octet-stream")
                finally:
                    conn.close()
                if resp.status == 200:
                    telemetry.counter_add("router.prefill_forwards", 1,
                                          replica=handle.name)
                    return resp.status, data, ctype
                last = resp.status
                telemetry.counter_add("router.prefill_forward_errors", 1,
                                      replica=handle.name,
                                      status=resp.status)
            except (ConnectionError, OSError,
                    http.client.HTTPException) as e:
                last = e
                handle.mark_down(type(e).__name__)
                telemetry.counter_add("router.prefill_forward_errors", 1,
                                      replica=handle.name,
                                      exc=type(e).__name__)
        return 503, json.dumps(
            {"error": f"every prefill replica failed (last: {last})"}
        ).encode(), "application/json"

    # -- introspection -------------------------------------------------------
    def ready(self) -> bool:
        return any(h.ready for h in self.handles())

    def stats(self) -> Dict[str, Any]:
        c = telemetry.counters()
        out = {k.split(".", 1)[1]: int(v) for k, v in c.items()
               if k.startswith("router.") and isinstance(v, (int, float))}
        out["replicas"] = [h.snapshot() for h in self.handles()]
        out["ready"] = self.ready()
        hists = telemetry.snapshot()["hists"]
        for key in ("router.request_ms", "router.dispatch_ms"):
            h = hists.get(key)
            if h:
                out[key.split(".", 1)[1]] = {
                    "count": h["count"], "avg": h["avg"], "p50": h["p50"],
                    "p95": h["p95"], "p99": h["p99"], "max": h["max"]}
        return out


# ---------------------------------------------------------------------------
# HTTP front end — the address clients actually talk to
# ---------------------------------------------------------------------------

from http.server import BaseHTTPRequestHandler  # noqa: E402


class _RouterHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        pass

    def _reply(self, code: int, payload: Dict[str, Any],
               headers: Optional[Dict[str, str]] = None):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        router: Router = self.server.router
        if self.path == "/healthz":
            ready = router.ready()
            self._reply(200 if ready else 503,
                        {"status": "ok" if ready else "no_ready_replica",
                         "replicas": [h.snapshot()
                                      for h in router.handles()]})
        elif self.path == "/livez":
            self._reply(200, {"status": "alive"})
        elif self.path == "/v1/stats":
            self._reply(200, router.stats())
        elif self.path == "/metrics":
            body = telemetry.prometheus_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        router: Router = self.server.router
        if self.path == "/v1/generate":
            try:
                length = int(self.headers.get("Content-Length") or 0)
                doc = json.loads(self.rfile.read(length) or b"{}")
                prompt = doc["prompt_ids"]
            except (ValueError, TypeError, KeyError) as e:
                self._reply(400, {"error": f"bad generate request: {e!r}"})
                return
            # client-supplied identity: exactly-once dedup + session
            # journaling key — body request_id wins over the header
            rid = (doc.get("request_id")
                   or self.headers.get("X-Request-Id"))
            headers: Dict[str, str] = {}
            # the router owns the request's root span; the id it forwards
            # pins the replica's root span to the same trace id
            with trace.root_span("router.request", trace_id=rid,
                                 force=bool(rid), path=self.path) as tctx:
                code, payload = router.route_generate(
                    prompt, max_new_tokens=doc.get("max_new_tokens"),
                    temperature=float(doc.get("temperature", 0.0)),
                    seed=doc.get("seed"),
                    deadline_ms=doc.get("deadline_ms"),
                    request_id=rid,
                    stop_at_eos=bool(doc.get("stop_at_eos", True)))
            if tctx is not None:
                headers["X-Trace-Id"] = tctx.trace_id
            self._reply(code, payload, headers)
            return
        if self.path == "/v1/session/journal":
            # decode replicas replicate session snapshots here at
            # step-boundary cadence (serving/session.py)
            try:
                length = int(self.headers.get("Content-Length") or 0)
                doc = json.loads(self.rfile.read(length) or b"{}")
                records = doc.get("records") or []
            except (ValueError, TypeError) as e:
                self._reply(400, {"error": f"bad journal batch: {e!r}"})
                return
            n = router.sessions.update(records)
            self._reply(200, {"journaled": n})
            return
        if self.path == "/v1/prefill":
            # live-cluster shipment pull: decode replicas configured
            # with the ROUTER url fetch prefill shipments through here
            length = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(length)
            code, data, ctype = router.forward_prefill(raw)
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
            return
        if self.path != "/v1/infer":
            self._reply(404, {"error": f"no route {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length") or 0)
            doc = json.loads(self.rfile.read(length) or b"{}")
            inputs = doc.get("inputs") or {}
        except (ValueError, TypeError) as e:
            self._reply(400, {"error": f"bad request body: {e}"})
            return
        rid = self.headers.get("X-Request-Id")
        headers: Dict[str, str] = {}
        # the router owns the request's ROOT span; the forwarded
        # X-Request-Id pins the replica's root span to the same trace id
        with trace.root_span("router.request", trace_id=rid,
                             force=bool(rid), path=self.path) as tctx:
            code, payload = router.route_infer(
                inputs, deadline_ms=doc.get("deadline_ms"), request_id=rid)
        if tctx is not None:
            payload.setdefault("trace_id", tctx.trace_id)
            headers["X-Trace-Id"] = tctx.trace_id
        self._reply(code, payload, headers)


class RouterHTTPServer:
    """Bound router front end; start()/shutdown() own the acceptor
    thread, same lifecycle shape as ServingHTTPServer."""

    def __init__(self, router: Router, host: str = "127.0.0.1",
                 port: int = 0):
        self.router = router
        from .server import BackloggedHTTPServer

        self._httpd = BackloggedHTTPServer((host, port), _RouterHandler)
        self._httpd.router = router
        self._thread: Optional[threading.Thread] = None

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "RouterHTTPServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                name="pt-router-http", daemon=True)
            self._thread.start()
        return self

    def shutdown(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
