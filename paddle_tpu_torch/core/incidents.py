"""Flight recorder, SLO watchdog and incident records (port of
``paddle_tpu/core/incidents.py``).

* **Flight recorder** (:class:`FlightRecorder`): an always-on bounded
  ring of the most recent telemetry records, installed as telemetry's
  tap, so it sees every record whether or not a JSONL sink is configured
  (``FLAGS_blackbox_max_records``, pruned to ``FLAGS_blackbox_seconds``
  when a snapshot is taken).
* **Rules** (:class:`Rule`): one metric of the rolling telemetry window
  (``telemetry.windowed``: a counter's delta or rate, a histogram
  percentile, a gauge), a window, a threshold (absolute, or a ratio of a
  baseline learned from the first qualifying measurement), a direction,
  min-samples and a cooldown. A breached rule latches ``firing`` and
  trips once an episode. ``default_rules`` is the reference's built-in
  set; ``FLAGS_slo_rules`` (``rules_from_spec``) replaces it.
* **Watchdog** (:class:`Watchdog`): evaluates a rule list; a trip sets
  the ``slo.<rule>_firing`` gauge (what ``SLOScalerPolicy`` reads),
  counts ``slo.trips`` and files an incident. ``arm`` / ``disarm`` /
  ``armed`` / ``tick`` (throttled to ``FLAGS_slo_eval_s``, inert while
  disarmed; the executor, the decode engine's step loop, the
  micro-batching engine's batch loop and the router's probe loop call
  it) / ``start_watchdog`` / ``stop_watchdog`` / ``health`` / ``reset``,
  with ``FLAGS_slo_watchdog`` on / off / auto (auto: armed while a
  serving HTTP server, a metrics server or a router runs).
* **Records**: ``report_incident`` (rate-limited by
  ``FLAGS_incident_rate_limit_s`` unless ``rate_limit=False``, as the
  cluster controller's ``replica_death`` record is) writes one
  ``kind:"incident"`` record bundling the flight recorder's snapshot,
  the recently active trace ids (``trace.recent_trace_ids``), the memory
  ledger (``costmodel.ledger``), the goodput breakdown and the counters,
  then flushes the sink: ``tools/incident_report.py`` renders it.
  ``report_scale_event`` writes one ``kind:"scale"`` record a world-size
  transition, never rate-limited, counted as ``incidents.scale_events``.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from . import flags as _flags
from . import telemetry

# -- the flight recorder -----------------------------------------------------


class FlightRecorder:
    """Always-on bounded ring of recent telemetry records. Its plain lock
    is never held while calling out, so feeding it from inside the
    telemetry registry's lock cannot deadlock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=2048)
        self._maxlen = 2048
        self.dropped = 0

    def record(self, rec: Dict[str, Any]):
        """Append one record (telemetry's tap: cheap, never raises)."""
        limit = int(_flags.flag("blackbox_max_records"))
        if limit <= 0:
            return
        with self._lock:
            if limit != self._maxlen:
                self._ring = deque(self._ring, maxlen=limit)
                self._maxlen = limit
            if len(self._ring) == self._maxlen:
                self.dropped += 1
            self._ring.append(rec)

    def snapshot(self, window_s: Optional[float] = None,
                 limit: Optional[int] = None,
                 now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Recent records, oldest first: those of the last ``window_s``
        seconds (default FLAGS_blackbox_seconds), the newest ``limit``
        of them."""
        if window_s is None:
            window_s = float(_flags.flag("blackbox_seconds"))
        if now is None:
            now = time.time()
        cut = now - max(window_s, 0.0)
        with self._lock:
            recs = list(self._ring)
        out = [r for r in recs
               if isinstance(r.get("ts"), (int, float)) and r["ts"] >= cut]
        if limit is not None and limit > 0 and len(out) > limit:
            out = out[-limit:]
        return out

    def __len__(self):
        with self._lock:
            return len(self._ring)

    def clear(self):
        with self._lock:
            self._ring.clear()
            self.dropped = 0


_recorder = FlightRecorder()


def flight_recorder() -> FlightRecorder:
    return _recorder


_RULE_KINDS = ("counter", "hist", "gauge")
_DIRECTIONS = ("above", "below")


class Rule:
    """One declarative SLO rule over the rolling metrics window.

    ``threshold`` is absolute; ``ratio`` is relative to a baseline learned
    from the first measurement with ``min_samples`` observations. A
    breached rule latches ``firing`` and trips once an episode; a re-trip
    needs the condition to clear and ``cooldown_s`` to pass."""

    def __init__(self, name: str, metric: str, kind: str = "counter",
                 stat: Optional[str] = None, window_s: float = 60.0,
                 threshold: Optional[float] = None,
                 ratio: Optional[float] = None, direction: str = "above",
                 min_samples: int = 0, cooldown_s: float = 300.0):
        if kind not in _RULE_KINDS:
            raise ValueError(f"rule {name!r}: kind must be one of "
                             f"{_RULE_KINDS}, got {kind!r}")
        if direction not in _DIRECTIONS:
            raise ValueError(f"rule {name!r}: direction must be one of "
                             f"{_DIRECTIONS}, got {direction!r}")
        if threshold is None and ratio is None:
            raise ValueError(f"rule {name!r}: needs a threshold or a "
                             f"baseline ratio")
        if stat is None:
            stat = {"counter": "delta", "hist": "p99",
                    "gauge": "value"}[kind]
        self.name = name
        self.metric = metric
        self.kind = kind
        self.stat = stat
        self.window_s = float(window_s)
        self.threshold = threshold
        self.ratio = ratio
        self.direction = direction
        self.min_samples = int(min_samples)
        self.cooldown_s = float(cooldown_s)
        self.reset()

    def reset(self):
        self.baseline: Optional[float] = None
        self.last_value: Optional[float] = None
        self.firing = False
        self.trips = 0
        self.last_trip_ts = float("-inf")
        self._learn_evals = 0

    def measure(self, win: Dict[str, Any]):
        """(value, samples) of the rule's metric in one ``windowed()``
        view; (None, 0) when the metric has no data in the window."""
        if self.kind == "counter":
            wc = win["counters"].get(self.metric)
            if wc is None:
                return None, 0
            return float(wc.get(self.stat, wc["delta"])), int(wc["delta"])
        if self.kind == "hist":
            wh = win["hists"].get(self.metric)
            if wh is None:
                return None, 0
            return float(wh[self.stat]), int(wh["count"])
        v = win["gauges"].get(self.metric)
        if v is None or not isinstance(v, (int, float)):
            return None, 0
        self._learn_evals += 1
        return float(v), self._learn_evals

    def effective_threshold(self) -> Optional[float]:
        if self.ratio is not None:
            if self.baseline is None:
                return None
            return self.baseline * self.ratio
        return self.threshold

    def state(self) -> str:
        if self.firing:
            return "firing"
        if self.ratio is not None and self.baseline is None:
            return "learning"
        return "ok"

    def as_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "metric": self.metric,
                "kind": self.kind, "stat": self.stat,
                "window_s": self.window_s, "threshold": self.threshold,
                "ratio": self.ratio, "direction": self.direction,
                "min_samples": self.min_samples,
                "cooldown_s": self.cooldown_s,
                "baseline": self.baseline, "value": self.last_value,
                "state": self.state(), "trips": self.trips}


def default_rules() -> List[Rule]:
    """The reference's built-in rule set; the queue thresholds come from
    the admission flags when the set is built. The rules on metrics the
    port does not publish (the Pallas fallbacks, ``ckpt.verify_failures``)
    stay in the set and never see data."""
    serving_q = max(1, int(_flags.flag("serving_max_queue_depth")))
    decode_q = max(1, int(_flags.flag("decode_max_queue_depth")))
    return [
        Rule("step_time_p99", "executor.run_ms", kind="hist", stat="p99",
             window_s=60.0, ratio=2.0, direction="above", min_samples=20,
             cooldown_s=300.0),
        Rule("live_mfu_drop", "cost.live_mfu", kind="gauge", ratio=0.5,
             direction="below", min_samples=5, cooldown_s=300.0),
        Rule("serving_queue_saturation", "serving.queue_depth",
             kind="gauge", threshold=0.9 * serving_q, direction="above",
             cooldown_s=120.0),
        Rule("decode_queue_saturation", "decode.queue_depth",
             kind="gauge", threshold=0.9 * decode_q, direction="above",
             cooldown_s=120.0),
        Rule("pallas_gemm_fallback_spike", "pallas.int8_gemm_fallbacks",
             kind="counter", stat="delta", window_s=60.0, threshold=3,
             cooldown_s=300.0),
        Rule("pallas_attn_fallback_spike", "pallas.paged_attn_fallbacks",
             kind="counter", stat="delta", window_s=60.0, threshold=3,
             cooldown_s=300.0),
        Rule("router_failover_burst", "router.failovers", kind="counter",
             stat="delta", window_s=30.0, threshold=3, cooldown_s=120.0),
        Rule("ckpt_verify_failures", "ckpt.verify_failures",
             kind="counter", stat="delta", window_s=120.0, threshold=0,
             cooldown_s=300.0),
    ]


def rules_from_spec(spec: str) -> List[Rule]:
    """Parse ``FLAGS_slo_rules``: a JSON array of rule objects, or
    ``@/path/to/rules.json``; empty gives ``default_rules()``. A
    malformed spec raises ValueError."""
    spec = (spec or "").strip()
    if not spec:
        return default_rules()
    if spec.startswith("@"):
        with open(spec[1:]) as f:
            doc = json.load(f)
    else:
        doc = json.loads(spec)
    if not isinstance(doc, list):
        raise ValueError("FLAGS_slo_rules must be a JSON array of rule "
                         "objects")
    return [Rule(**{str(k): v for k, v in obj.items()}) for obj in doc]


class Watchdog:
    """Evaluates a rule list over the live metrics window and files an
    incident for each trip. Its lock is never held across a telemetry
    call."""

    def __init__(self, rules: Optional[List[Rule]] = None):
        self._lock = threading.Lock()
        self.rules = list(rules) if rules is not None \
            else rules_from_spec(_flags.flag("slo_rules"))
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def evaluate(self, now: Optional[float] = None) -> List[str]:
        """One pass over the rules; returns the names of the rules that
        tripped in it."""
        if now is None:
            now = time.time()
        wins: Dict[float, Dict[str, Any]] = {}
        trips = []
        for rule in self.rules:
            win = wins.get(rule.window_s)
            if win is None:
                win = wins[rule.window_s] = telemetry.windowed(
                    rule.window_s, now=now)
            value, samples = rule.measure(win)
            with self._lock:
                tripped = self._step_rule_locked(rule, value, samples, now)
            if tripped is True:
                trips.append(rule.name)
                telemetry.gauge_set(f"slo.{rule.name}_firing", 1)
                telemetry.counter_add("slo.trips", 1, rule=rule.name,
                                      metric=rule.metric)
                report_incident("slo", f"slo.{rule.name}",
                                value=rule.last_value, rule=rule.as_dict())
            elif tripped is False:
                telemetry.gauge_set(f"slo.{rule.name}_firing", 0)
        telemetry.counter_quiet("slo.evaluations")
        return trips

    @staticmethod
    def _step_rule_locked(rule: Rule, value, samples: int,
                          now: float) -> Optional[bool]:
        """Advance one rule for one measurement: True on a fresh trip,
        False when a firing episode cleared, None otherwise."""

        def clear():
            if rule.firing:
                rule.firing = False
                return False
            return None

        if value is None:
            return clear()
        rule.last_value = value
        if samples < rule.min_samples:
            return None
        if rule.ratio is not None and rule.baseline is None:
            rule.baseline = value
            return None
        eff = rule.effective_threshold()
        if eff is None:
            return None
        breach = value > eff if rule.direction == "above" else value < eff
        if not breach:
            return clear()
        if rule.firing or now - rule.last_trip_ts < rule.cooldown_s:
            rule.firing = True
            return None
        rule.firing = True
        rule.trips += 1
        rule.last_trip_ts = now
        return True

    def health(self) -> Dict[str, Any]:
        with self._lock:
            rules = [r.as_dict() for r in self.rules]
        return {"rules": {r["name"]: r for r in rules},
                "firing": sorted(r["name"] for r in rules
                                 if r["state"] == "firing"),
                "trips": sum(r["trips"] for r in rules)}

    def reset(self):
        with self._lock:
            for r in self.rules:
                r.reset()

    def start(self) -> "Watchdog":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="pt-incidents-watchdog",
                daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self):
        while not self._stop.wait(max(0.05,
                                      float(_flags.flag("slo_eval_s")))):
            try:
                self.evaluate()
            except Exception:   # noqa: BLE001 - a bad rule must not kill it
                telemetry.counter_quiet("slo.eval_errors")


# -- arming and the tick the hot paths call ---------------------------------

_state_lock = threading.Lock()
_watchdog: Optional[Watchdog] = None
_armed = [False]
_last_eval = [0.0]


def _flag_mode() -> str:
    m = str(_flags.flag("slo_watchdog")).strip().lower()
    return m if m in ("off", "on", "auto") else "auto"


def armed() -> bool:
    mode = _flag_mode()
    if mode == "off":
        return False
    if mode == "on":
        return True
    return _armed[0]


def watchdog() -> Watchdog:
    """The process watchdog (built from FLAGS_slo_rules on first use)."""
    global _watchdog
    with _state_lock:
        if _watchdog is None:
            _watchdog = Watchdog()
        return _watchdog


def arm(rules: Optional[List[Rule]] = None) -> Optional[Watchdog]:
    """Activate rule evaluation by ``tick()``; ``rules`` replaces the rule
    set. A no-op while FLAGS_slo_watchdog is 'off'."""
    global _watchdog
    if _flag_mode() == "off":
        return None
    with _state_lock:
        if rules is not None:
            _watchdog = Watchdog(rules)
        elif _watchdog is None:
            _watchdog = Watchdog()
        _armed[0] = True
        return _watchdog


def disarm():
    _armed[0] = False


def start_watchdog(rules: Optional[List[Rule]] = None) -> Optional[Watchdog]:
    """arm() and the pt-incidents-watchdog thread, for a process that must
    evaluate while idle."""
    wd = arm(rules)
    if wd is not None:
        wd.start()
    return wd


def stop_watchdog():
    with _state_lock:
        wd = _watchdog
    if wd is not None:
        wd.stop()
    disarm()


def tick(now: Optional[float] = None):
    """The hot-path hook (the router's probe loop, an online trial's
    evaluation): evaluates the rules at most every FLAGS_slo_eval_s while
    armed; one boolean read otherwise."""
    if not armed():
        return
    if now is None:
        now = time.time()
    if now - _last_eval[0] < float(_flags.flag("slo_eval_s")):
        return
    _last_eval[0] = now
    try:
        watchdog().evaluate(now=now)
    except Exception:   # noqa: BLE001 - the hot path never raises here
        telemetry.counter_quiet("slo.eval_errors")


# -- incident and scale records ---------------------------------------------

_incident_lock = threading.Lock()
_last_incident_ts = [float("-inf")]
_last_incident: List[Optional[Dict[str, Any]]] = [None]
_incident_seq = [0]


def report_incident(source: str, name: str, value=None,
                    context: Optional[Dict[str, Any]] = None,
                    rule: Optional[Dict[str, Any]] = None,
                    legacy_kind: Optional[str] = None,
                    now: Optional[float] = None,
                    rate_limit: bool = True) -> Optional[str]:
    """File one ``kind:"incident"`` record (rate-limited by
    FLAGS_incident_rate_limit_s unless ``rate_limit=False``, which leaves
    the window's bookkeeping untouched) bundling the flight recorder's
    snapshot, the recent trace ids, the memory ledger, the goodput
    breakdown and the counters, then flush the sink. ``legacy_kind``
    first writes the original record under that kind (``oom``), never
    rate-limited. Returns the incident id, or None when rate-limited."""
    if now is None:
        now = time.time()
    if legacy_kind:
        telemetry.event(legacy_kind, name, value, dict(context or {}))
    allowed = False
    with _incident_lock:
        if rate_limit:
            limit = float(_flags.flag("incident_rate_limit_s"))
            if now - _last_incident_ts[0] >= limit:
                _last_incident_ts[0] = now
                allowed = True
        else:
            allowed = True
        if allowed:
            _incident_seq[0] += 1
            incident_id = f"inc-{int(now)}-{_incident_seq[0]:04d}"
    if not allowed:
        telemetry.counter_quiet("incidents.rate_limited")
        return None
    from . import costmodel, goodput, trace

    attrs: Dict[str, Any] = {
        "id": incident_id,
        "source": source,
        "trip_ts": round(now, 6),
        "context": dict(context or {}),
        "ring": _recorder.snapshot(
            limit=int(_flags.flag("incident_ring_records")), now=now),
        "ring_dropped": _recorder.dropped,
        "ledger": costmodel.ledger(),
        "traces": trace.recent_trace_ids(),
        "goodput": goodput.breakdown(),
        "counters": telemetry.counters(),
    }
    if rule is not None:
        attrs["rule"] = rule
    telemetry.counter_add("incidents.reported", 1, source=source,
                          incident=name)
    telemetry.event("incident", name, value, attrs)
    # the process may be about to die (an OOM, a wedged replica)
    telemetry.flush_sink()
    with _incident_lock:
        _last_incident[0] = {"id": incident_id, "source": source,
                             "name": name, "ts": round(now, 3),
                             "value": value,
                             "rule": rule.get("name") if rule else None}
    return incident_id


def report_scale_event(source: str, event: str, old_world: int,
                       new_world: int, reason: str = "",
                       attrs: Optional[Dict[str, Any]] = None) -> None:
    """One ``kind:"scale"`` event a world-size transition, never
    rate-limited, counted as ``incidents.scale_events``."""
    payload: Dict[str, Any] = {
        "source": source,
        "event": event,
        "old_world": int(old_world),
        "new_world": int(new_world),
        "reason": reason,
    }
    if attrs:
        payload.update(attrs)
    telemetry.counter_add("incidents.scale_events", 1, source=source,
                          event=event)
    telemetry.event("scale", f"{source}.{event}",
                    int(new_world) - int(old_world), payload)
    telemetry.flush_sink()


def last_incident() -> Optional[Dict[str, Any]]:
    with _incident_lock:
        return dict(_last_incident[0]) if _last_incident[0] else None


def health() -> Dict[str, Any]:
    """Watchdog arming, the rules' firing states and the incident
    totals."""
    c = telemetry.counters()
    out: Dict[str, Any] = {
        "watchdog_armed": armed(),
        "incidents_reported": int(c.get("incidents.reported", 0)),
        "incidents_rate_limited": int(c.get("incidents.rate_limited", 0)),
        "slo_trips": int(c.get("slo.trips", 0)),
        "blackbox_records": len(_recorder),
    }
    with _state_lock:
        wd = _watchdog
    if wd is not None:
        out.update(wd.health())
    li = last_incident()
    if li:
        out["last_incident"] = li
    return out


def reset():
    """Clear the recorder, the watchdog and the incident bookkeeping
    (tests)."""
    global _watchdog
    _recorder.clear()
    with _state_lock:
        _watchdog = None
    _armed[0] = False
    _last_eval[0] = 0.0
    with _incident_lock:
        _last_incident_ts[0] = float("-inf")
        _last_incident[0] = None
        _incident_seq[0] = 0


# the flight recorder's tap: every telemetry record lands in the ring,
# whether or not a JSONL sink is configured
telemetry.set_blackbox(_recorder.record)
