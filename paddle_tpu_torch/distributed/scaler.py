"""Scale-event protocol: a signal-driven world-size policy (port of
``paddle_tpu/distributed/scaler.py``).

A ``ScalerPolicy`` reads the evidence the rest of the stack publishes,
heartbeat verdicts (``ps.trainer_dead`` / ``ps.trainer_revived`` /
``ps.barrier_regrown``), queue saturation (``fleet.queue_frac``, else
the serving admission depth against its bound), the step-time p99 over
the rolling window, and emits typed ScaleUp / ScaleDown decisions with a
cooldown and min/max bounds. ``SLOScalerPolicy`` reads the incident
plane's latched ``slo.<rule>_firing`` gauges instead
(core/incidents.py).

The policy only decides. ``ClusterController.autoscale_tick`` /
``scale_to`` (serving/cluster.py) execute a serving-fleet decision; the
reference's training-side executor (``ElasticRunner``) is not in the
port. The fleet observatory that writes ``fleet.queue_frac`` in the
reference (``core/fleetobs``) is ROADMAP A10b: with ``fleet=None``,
``gather_signals`` reads that gauge from telemetry, as the reference
does, and whoever drives the fleet writes it.

Every decision is counted (``scaler.evaluations``, ``scaler.decisions``,
``scaler.scale_up``, ``scaler.scale_down``, ``scaler.suppressed_cooldown``,
``scaler.clamped``); every executed transition is one
``incidents.report_scale_event``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ..core import flags as _flags
from ..core import telemetry

SCALE_UP = "up"
SCALE_DOWN = "down"


@dataclass(frozen=True)
class ScaleDecision:
    """One typed verdict: move the world from ``current`` to ``target``.

    ``reason`` names the rule that fired (heartbeat_dead,
    worker_rejoined, queue_saturation, step_time_p99, underutilized);
    ``signals`` carries the evidence snapshot the rule judged."""

    direction: str                 # SCALE_UP | SCALE_DOWN
    current: int
    target: int
    reason: str
    signals: Dict[str, Any] = field(default_factory=dict)
    ts: float = 0.0

    @property
    def delta(self) -> int:
        return self.target - self.current


@dataclass
class ScaleSignals:
    """The evidence vector a policy judges — normalised from whatever
    plane produced it (training PS world, serving fleet, local
    telemetry window) so one policy serves both planes."""

    dead_workers: int = 0          # heartbeat verdicts in the window
    joined_workers: int = 0        # revived/announced workers in window
    queue_frac: float = 0.0        # queue depth / admission bound, 0..1
    queue_evidence: bool = False   # the window actually saw traffic
    step_p99_ms: float = 0.0       # step-time p99 over the window
    extra: Dict[str, Any] = field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        d = {"dead_workers": self.dead_workers,
             "joined_workers": self.joined_workers,
             "queue_frac": round(float(self.queue_frac), 4),
             "queue_evidence": bool(self.queue_evidence),
             "step_p99_ms": round(float(self.step_p99_ms), 3)}
        d.update(self.extra)
        return d


def gather_signals(window: Optional[Dict[str, Any]] = None,
                   fleet=None,
                   window_s: Optional[float] = None,
                   now: Optional[float] = None) -> ScaleSignals:
    """Build a ScaleSignals from the live telemetry window (and the
    fleet observatory when one is attached). ``window`` is injectable
    for deterministic tests; by default the rolling
    ``telemetry.windowed(FLAGS_scaler_window_s)`` view is read."""
    if window is None:
        W = float(window_s if window_s is not None
                  else _flags.flag("scaler_window_s"))
        window = telemetry.windowed(W, now=now)
    counters = window.get("counters") or {}
    hists = window.get("hists") or {}
    gauges = window.get("gauges") or {}

    def cdelta(name: str) -> float:
        rec = counters.get(name) or {}
        try:
            return float(rec.get("delta") or 0)
        except (TypeError, ValueError):
            return 0.0

    dead = cdelta("ps.trainer_dead")
    revived = cdelta("ps.trainer_revived")
    joined = cdelta("ps.barrier_regrown")
    sig = ScaleSignals(
        dead_workers=max(0, int(dead - revived)),
        joined_workers=int(max(revived, joined)))
    # queue saturation: prefer the fleet-merged view, fall back to the
    # local serving gauge against the admission bound
    qf = None
    if fleet is not None:
        try:
            qf = ((fleet.status() or {}).get("fleet")
                  or {}).get("queue_frac")
        except Exception:
            qf = None
    if qf is None:
        qf = gauges.get("fleet.queue_frac")
    if qf is None:
        depth = gauges.get("serving.queue_depth")
        bound = float(_flags.flag("serving_max_queue_depth") or 0)
        if depth is not None and bound > 0:
            qf = float(depth) / bound
    if qf is not None:
        sig.queue_frac = max(0.0, float(qf))
        sig.queue_evidence = True
    # step-time p99 over the window: first step-latency histogram wins
    for hname in ("executor.run_steps_ms", "executor.run_ms",
                  "serving.request_ms"):
        h = hists.get(hname)
        if h and h.get("count"):
            sig.step_p99_ms = float(h.get("p99") or 0.0)
            sig.extra["step_metric"] = hname
            break
    return sig


class ScalerPolicy:
    """Cooldown-gated, bound-clamped scale policy over ScaleSignals.

    Rule order (first hit wins):
      1. dead_workers > 0           → ScaleDown to the survivor count
      2. joined_workers > 0         → ScaleUp (re-absorb the announced
                                      worker — the barrier-regrow path)
      3. queue_frac ≥ high          → ScaleUp   (queue_saturation)
      4. step_p99 ≥ bound (if set)  → ScaleUp   (step_time_p99)
      5. queue_frac ≤ low w/traffic → ScaleDown (underutilized)

    A decision outside [min_world, max_world] clamps; a clamp that
    lands back on the current world is suppressed (scaler.clamped).
    A decision inside the cooldown since the last one is suppressed
    (scaler.suppressed_cooldown) — the thrash guard.
    """

    def __init__(self, min_world: Optional[int] = None,
                 max_world: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 queue_high_frac: Optional[float] = None,
                 queue_low_frac: Optional[float] = None,
                 step_p99_high_ms: Optional[float] = None,
                 step: int = 1, source: str = "scaler"):
        f = _flags.flag
        self.min_world = int(f("scaler_min_world") if min_world is None
                             else min_world)
        self.max_world = int(f("scaler_max_world") if max_world is None
                             else max_world)
        if self.min_world < 1 or self.max_world < self.min_world:
            raise ValueError(
                f"ScalerPolicy: need 1 <= min_world <= max_world, got "
                f"[{self.min_world}, {self.max_world}]")
        self.cooldown_s = float(f("scaler_cooldown_s") if cooldown_s is None
                                else cooldown_s)
        self.queue_high = float(f("scaler_queue_high_frac")
                                if queue_high_frac is None
                                else queue_high_frac)
        self.queue_low = float(f("scaler_queue_low_frac")
                               if queue_low_frac is None
                               else queue_low_frac)
        self.step_p99_high = float(f("scaler_step_p99_high_ms")
                                   if step_p99_high_ms is None
                                   else step_p99_high_ms)
        self.step = max(1, int(step))
        self.source = source
        self._last_decision_ts: Optional[float] = None

    # -- the rules -----------------------------------------------------------
    def _judge(self, world: int, sig: ScaleSignals):
        """(direction, raw_target, reason) or None — bounds/cooldown are
        applied by decide(), not here."""
        if sig.dead_workers > 0:
            return (SCALE_DOWN, world - sig.dead_workers, "heartbeat_dead")
        if sig.joined_workers > 0:
            return (SCALE_UP, world + sig.joined_workers, "worker_rejoined")
        if sig.queue_evidence and sig.queue_frac >= self.queue_high:
            return (SCALE_UP, world + self.step, "queue_saturation")
        if self.step_p99_high > 0 and sig.step_p99_ms >= self.step_p99_high:
            return (SCALE_UP, world + self.step, "step_time_p99")
        if sig.queue_evidence and sig.queue_frac <= self.queue_low:
            return (SCALE_DOWN, world - self.step, "underutilized")
        return None

    def decide(self, world: int, signals: Optional[ScaleSignals] = None,
               now: Optional[float] = None,
               fleet=None) -> Optional[ScaleDecision]:
        """Judge the current evidence; returns a ScaleDecision or None.

        The returned decision is already clamped to [min_world,
        max_world] and has passed the cooldown gate — a non-None return
        is safe to execute."""
        if now is None:
            now = time.time()
        if signals is None:
            signals = gather_signals(fleet=fleet, now=now)
        telemetry.counter_add("scaler.evaluations", 1, source=self.source)
        verdict = self._judge(int(world), signals)
        if verdict is None:
            return None
        direction, target, reason = verdict
        clamped = min(self.max_world, max(self.min_world, int(target)))
        if clamped != target:
            telemetry.counter_add("scaler.clamped", 1, source=self.source,
                                  reason=reason, target=int(target),
                                  clamped=clamped)
            target = clamped
        if target == int(world):
            return None                 # fully clamped away
        if self._last_decision_ts is not None and \
                now - self._last_decision_ts < self.cooldown_s:
            telemetry.counter_add("scaler.suppressed_cooldown", 1,
                                  source=self.source, reason=reason)
            return None
        self._last_decision_ts = now
        decision = ScaleDecision(direction=direction, current=int(world),
                                 target=int(target), reason=reason,
                                 signals=signals.as_dict(), ts=now)
        telemetry.counter_add("scaler.decisions", 1, source=self.source,
                              reason=reason, direction=direction,
                              current=decision.current,
                              target=decision.target)
        if direction == SCALE_UP:
            telemetry.counter_add("scaler.scale_up", 1,
                                  source=self.source, reason=reason)
        else:
            telemetry.counter_add("scaler.scale_down", 1,
                                  source=self.source, reason=reason)
        return decision

    def reset_cooldown(self):
        self._last_decision_ts = None

    @classmethod
    def from_slo_rules(cls, up_rules=None, down_rules=None,
                       **kw) -> "SLOScalerPolicy":
        """A policy whose evidence is the incident plane's FIRING state
        instead of raw metrics: the incident watchdog already applies
        windowing, min-samples and warmup baselines before latching a
        ``slo.<rule>_firing`` gauge, so the scaler reuses that verdict
        rather than re-deriving it from the same counters.

        ``up_rules`` / ``down_rules`` name the SLO rules (incidents.Rule
        names, e.g. the built-in ``decode_queue_saturation``) whose
        firing argues ScaleUp / ScaleDown. Cooldown/bounds/step keyword
        arguments pass through to :class:`ScalerPolicy` unchanged."""
        return SLOScalerPolicy(
            up_rules=_SLO_UP_DEFAULT if up_rules is None else up_rules,
            down_rules=(_SLO_DOWN_DEFAULT if down_rules is None
                        else down_rules), **kw)


# SLO rules whose firing is capacity evidence. Saturated admission
# queues, regressed step time and router failover bursts all argue MORE
# replicas; a live-MFU collapse on an otherwise healthy world argues the
# fleet is over-provisioned for the work it is getting.
_SLO_UP_DEFAULT = ("decode_queue_saturation", "serving_queue_saturation",
                   "step_time_p99", "router_failover_burst")
_SLO_DOWN_DEFAULT = ("live_mfu_drop",)


class SLOScalerPolicy(ScalerPolicy):
    """ScalerPolicy driven by ``slo.<rule>_firing`` gauges (build via
    :meth:`ScalerPolicy.from_slo_rules`). Rule order: first firing
    up-rule wins, then first firing down-rule; the base class still owns
    clamping and the cooldown gate, so one sustained queue-saturation
    episode yields exactly ONE ScaleUp per cooldown window."""

    def __init__(self, up_rules=(), down_rules=(), source: str = "slo",
                 **kw):
        super().__init__(source=source, **kw)
        self.up_rules = tuple(str(r) for r in up_rules)
        self.down_rules = tuple(str(r) for r in down_rules)

    def firing_rules(self) -> list:
        """Rule names currently latched firing (gauge value truthy)."""
        gauges = telemetry.gauges()
        out = []
        for name in self.up_rules + self.down_rules:
            if gauges.get(f"slo.{name}_firing"):
                out.append(name)
        return out

    def _judge(self, world: int, sig: ScaleSignals):
        firing = sig.extra.get("slo_firing")
        if firing is None:
            firing = self.firing_rules()
            sig.extra["slo_firing"] = sorted(firing)
        for name in self.up_rules:
            if name in firing:
                return (SCALE_UP, world + self.step, name)
        for name in self.down_rules:
            if name in firing:
                return (SCALE_DOWN, world - self.step, name)
        return None


class ResizeSchedule:
    """Deterministic step-triggered resize plan for a supervising
    launcher: ``"step:world,step:world"`` (e.g. ``"4:3,8:2"`` —
    grow to 3 trainers once any trainer reports step 4, shrink back to
    2 at step 8). Entries fire once each, in step order; the
    launcher polls :meth:`next_target` with the max observed
    trainer step between supervision passes. Malformed specs raise at
    parse time — a silently-dropped resize plan is worse than a loud
    one."""

    def __init__(self, spec: str = "",
                 entries: Optional[list] = None):
        plan = []
        if entries is not None:
            plan = [(int(s), int(w)) for s, w in entries]
        else:
            for part in str(spec or "").split(","):
                part = part.strip()
                if not part:
                    continue
                step_s, sep, world_s = part.partition(":")
                if not sep:
                    raise ValueError(
                        f"ResizeSchedule: entry {part!r} is not "
                        f"'step:world'")
                plan.append((int(step_s), int(world_s)))
        for _, world in plan:
            if world < 1:
                raise ValueError("ResizeSchedule: world must be >= 1")
        self._plan = sorted(plan)
        self.executed: list = []

    def pending(self) -> list:
        return list(self._plan)

    def next_target(self, step: int) -> Optional[int]:
        """World size to resize to once ``step`` has been reached, or
        None. Consumes every entry whose trigger step has passed and
        returns the LAST one — a supervisor that stalled past two
        triggers jumps straight to the final world."""
        target = None
        while self._plan and step >= self._plan[0][0]:
            entry = self._plan.pop(0)
            self.executed.append(entry)
            target = entry[1]
        return target
