"""Autotuner: offline replay search and online A/B promotion over the
live config surface (port of ``paddle_tpu/core/tuner.py``).

* **Typed search space** (:class:`Knob` / :class:`SearchSpace`,
  ``default_space``): the reference's knob set over the flag surface,
  each domain with the incumbent first; candidates pass typed constraint
  checks before they are scored (bucket sets strictly increasing and
  covering the batch bound, batch scaling gated by memory headroom,
  sharding candidates needing mesh evidence), each rejection counted in
  ``tuner.constraint_rejections``.
* **Offline replay** (:class:`RunLogObservations` / :class:`ReplayModel`
  / :func:`offline_search`): a captured telemetry run log (JSONL records
  and/or bench rows) ranks the candidates without touching the hardware:
  measured per-k step ms first, the amortisation law ``ms(k) =
  device_ms + host_ms / k`` fitted from >= 2 observed k only where it is
  physical, and no claimed win without evidence
  (``tuner.insufficient_evidence``). Both packages rank the same log the
  same way and emit the same ``profile_hash`` (a hash of the config
  alone).
* **Profiles** (``make_profile`` / ``save_profile`` / ``load_profile`` /
  ``apply_profile`` / ``profile_provenance``): the winner as a JSON of
  flag overrides, axis-rule table and fingerprints.
* **Online A/B trial** (:class:`OnlineTrial`): one candidate's flags on
  one replica of a live cluster (``ClusterController.retune_replica``),
  a bounded slice of traffic steered there (``Router.set_trial``),
  promotion or rollback on the arms' p99; an SLO rule trip
  (core/incidents.py) aborts within one evaluation tick, and a rollback
  restores the exact flag snapshot. The fleet's model version is never
  touched.

The one divergence from the reference: ``exec_steps_per_dispatch`` and
``pallas_kv_chunk_tokens`` have no reader in the port (``Executor.run_steps``
exists, but the flag's readers, ``train_from_dataset`` and
``hapi.Model.fit``, are ROADMAP A9 and A11; the CUDA paged-attention
kernel's chunk is fixed at 128 tokens) and ZeRO is ROADMAP A8, so ``apply_profile`` and
``OnlineTrial.start`` raise ``ProfileError`` for a profile or candidate
that moves either flag off its default or asks for ``zero_stage > 0``,
instead of setting a flag that nothing reads. The offline search still
ranks those knobs, as the reference does. A profile's
``fingerprints.pallas_kernels`` (the reference's key) holds the hash of
the port's CUDA kernel sources. ``telemetry.event`` records go to the
run-log sink when one is configured, and to the in-memory event ring.

Counters: ``tuner.trials`` / ``promotions`` / ``rollbacks`` /
``constraint_rejections`` / ``candidates`` / ``profiles_loaded`` /
``insufficient_evidence`` / ``slo_aborts`` / ``rollback_errors`` /
``replay_observations``.

CLI: ``python -m paddle_tpu_torch.tools.autotune`` (offline search, the
online trial, the space dump).
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import flags as _flags
from . import telemetry
from .flags import BucketConfigError, ConfigError

PROFILE_FORMAT = "pt-tuned-profile-v1"

# the share of device memory the headroom constraint keeps free
HBM_SAFETY = 0.92


class TunerError(RuntimeError):
    """Autotuner failure (unusable run log, trial could not start)."""


class ProfileError(ConfigError):
    """A tuned-profile document that is malformed or the wrong format."""


# ---------------------------------------------------------------------------
# typed search space
# ---------------------------------------------------------------------------


class Knob:
    """One tunable dimension: a name, the config field it writes
    (``target``: 'flags' / 'batch_multiplier' / 'axis_rules' /
    'zero_stage'), and its candidate domain (default value FIRST)."""

    def __init__(self, name: str, values: Sequence[Any],
                 target: str = "flags", flag: Optional[str] = None,
                 doc: str = ""):
        if not values:
            raise ValueError(f"knob {name!r}: empty domain")
        self.name = name
        self.values = list(values)
        self.target = target
        self.flag = flag or name
        self.doc = doc

    @property
    def default(self):
        return self.values[0]

    def as_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "target": self.target,
                "flag": self.flag, "values": list(self.values),
                "doc": self.doc}


class Candidate:
    """One point in the search space: flag overrides + the non-flag
    levers (batch multiplier, axis-rule table, ZeRO stage). ``changes``
    counts knobs moved off their defaults (the least-change tie-break)."""

    def __init__(self, flags: Optional[Dict[str, Any]] = None,
                 batch_multiplier: float = 1.0,
                 axis_rules: Optional[List] = None,
                 zero_stage: Optional[int] = None,
                 changes: int = 0, label: str = "default"):
        self.flags = dict(flags or {})
        self.batch_multiplier = float(batch_multiplier)
        self.axis_rules = axis_rules
        self.zero_stage = zero_stage
        self.changes = int(changes)
        self.label = label

    def config_doc(self) -> Dict[str, Any]:
        """The canonical config payload (profile body + hash input)."""
        return {"flags": {k: self.flags[k] for k in sorted(self.flags)},
                "batch_multiplier": self.batch_multiplier,
                "axis_rules": self.axis_rules,
                "zero_stage": self.zero_stage}

    def fingerprint(self) -> str:
        payload = json.dumps(self.config_doc(), sort_keys=True,
                             separators=(",", ":"), default=str)
        return hashlib.sha1(payload.encode()).hexdigest()[:12]

    def __repr__(self):
        return f"Candidate({self.label}, {self.config_doc()})"


def default_space() -> List[Knob]:
    """The built-in knob set over the live flag surface. Domains derive
    from the CURRENT flag values so the incumbent config is always the
    first (default) point of every knob."""
    k0 = max(1, int(_flags.flag("exec_steps_per_dispatch")))
    max_batch = max(1, int(_flags.flag("serving_max_batch_size")))
    slots = max(1, int(_flags.flag("decode_max_slots")))
    chunk = max(1, int(_flags.flag("pallas_kv_chunk_tokens")))

    def uniq(vals):
        seen, out = set(), []
        for v in vals:
            key = json.dumps(v, sort_keys=True, default=str)
            if key not in seen:
                seen.add(key)
                out.append(v)
        return out

    serving_sets = uniq([
        str(_flags.flag("serving_buckets")),     # incumbent (often "")
        "",                                       # pow2 default
        str(max_batch),                           # one fixed bucket
        ",".join(str(b) for b in sorted({max(1, max_batch // 2),
                                         max_batch})),
    ])
    decode_sets = uniq([
        str(_flags.flag("decode_buckets")),       # incumbent
        "",                                       # one bucket of max_slots
        ",".join(str(b) for b in sorted({max(1, slots // 2), slots})),
    ])
    return [
        Knob("exec_steps_per_dispatch",
             uniq([k0] + [k for k in (1, 2, 4, 8) if k != k0]),
             doc="K-step fused dispatch (host-overhead amortization)"),
        Knob("batch_multiplier", [1.0, 2.0], target="batch_multiplier",
             doc="scale the workload batch (gated by HBM-ledger "
                 "headroom)"),
        Knob("serving_buckets", serving_sets,
             doc="micro-batch padding boundaries (jit-cache geometry)"),
        Knob("decode_max_slots",
             uniq([slots] + [s for s in (slots * 2,) if s != slots]),
             doc="concurrent decode slots (continuous-batching width)"),
        Knob("decode_buckets", decode_sets,
             doc="decode slot-array jit shapes"),
        Knob("pallas_kv_chunk_tokens",
             uniq([chunk] + [c for c in (256, 512, 1024, 2048)
                             if c != chunk]),
             doc="KV tokens per VMEM chunk of the Pallas paged-attention "
                 "kernel"),
        Knob("axis_rules", [None, "mp_first"], target="axis_rules",
             doc="logical-axis-rule table variant (needs mesh evidence)"),
        Knob("zero_stage", [0, 1, 2], target="zero_stage",
             doc="ZeRO sharded-optimizer stage (needs mesh evidence)"),
    ]


# the named axis-rule table variants the search can propose (the default
# table lives in parallel/axis_rules.py; "mp_first" prefers tensor
# parallelism for embed/mlp before falling back)
AXIS_RULE_VARIANTS: Dict[str, List[Tuple[str, Optional[str]]]] = {
    "mp_first": [("batch", "dp"), ("sequence", "sp"), ("vocab", "mp"),
                 ("heads", "mp"), ("mlp", "mp"), ("embed", "mp"),
                 ("kv", None), ("expert", "ep")],
}


class SearchSpace:
    """Knob list + candidate enumeration + typed constraint gate."""

    def __init__(self, knobs: Optional[List[Knob]] = None):
        self.knobs = list(knobs) if knobs is not None else default_space()

    def knob(self, name: str) -> Knob:
        for k in self.knobs:
            if k.name == name:
                return k
        raise KeyError(f"no knob {name!r} in the search space")

    def default_candidate(self) -> Candidate:
        return Candidate(label="default")

    def _with(self, knob: Knob, value) -> Candidate:
        cand = Candidate(changes=1, label=f"{knob.name}={value!r}")
        cand.knob = knob.name
        if knob.target == "flags":
            cand.flags[knob.flag] = value
        elif knob.target == "batch_multiplier":
            cand.batch_multiplier = float(value)
        elif knob.target == "axis_rules":
            cand.axis_rules = (AXIS_RULE_VARIANTS.get(value)
                               if isinstance(value, str) else value)
            if value is not None and cand.axis_rules is None:
                raise KeyError(f"unknown axis-rule variant {value!r}")
        elif knob.target == "zero_stage":
            cand.zero_stage = int(value)
        else:
            raise ValueError(f"knob {knob.name!r}: unknown target "
                             f"{knob.target!r}")
        return cand

    def enumerate(self) -> List[Candidate]:
        """Coordinate sweep: the default point plus one candidate per
        non-default knob value — a bounded, predictable enumeration
        (len = 1 + sum(len(domain) - 1)). Combination candidates are the
        search loop's job (offline_search combines per-knob winners)."""
        out = [self.default_candidate()]
        for knob in self.knobs:
            for value in knob.values[1:]:
                out.append(self._with(knob, value))
        telemetry.counter_add("tuner.candidates", len(out))
        return out

    # -- constraints ---------------------------------------------------------
    def check(self, cand: Candidate,
              obs: Optional["RunLogObservations"] = None) -> Optional[str]:
        """Typed constraint gate; returns the rejection reason (counted
        in ``tuner.constraint_rejections``) or None when the candidate
        is admissible."""
        reason = self._check(cand, obs)
        if reason is not None:
            telemetry.counter_add("tuner.constraint_rejections", 1,
                                  reason=reason, candidate=cand.label)
        return reason

    def _check(self, cand: Candidate,
               obs: Optional["RunLogObservations"]) -> Optional[str]:
        f = cand.flags
        k = f.get("exec_steps_per_dispatch")
        if k is not None and int(k) < 1:
            return "steps_per_dispatch_invalid"
        max_batch = int(f.get("serving_max_batch_size",
                              _flags.flag("serving_max_batch_size")))
        if "serving_buckets" in f:
            try:
                # serving bucket sets must be strictly increasing AND
                # cover max_batch_size (a set that stops short forces
                # oversized own-bucket compiles the tuner cannot cost)
                _flags.parse_buckets(f["serving_buckets"],
                                     "serving_buckets", cover=max_batch)
            except BucketConfigError:
                return "bucket_set_invalid"
        slots = int(f.get("decode_max_slots",
                          _flags.flag("decode_max_slots")))
        if slots < 1:
            return "decode_slots_invalid"
        if "decode_buckets" in f:
            try:
                _flags.parse_buckets(f["decode_buckets"], "decode_buckets",
                                     cover=slots, cover_exact=True)
            except BucketConfigError:
                return "bucket_set_invalid"
        chunk = f.get("pallas_kv_chunk_tokens")
        if chunk is not None and int(chunk) < 1:
            return "kv_chunk_invalid"
        if cand.batch_multiplier != 1.0:
            if cand.batch_multiplier <= 0:
                return "batch_multiplier_invalid"
            reason = self._check_hbm(cand, obs)
            if reason is not None:
                return reason
        if cand.axis_rules is not None or (cand.zero_stage or 0) > 0:
            # sharding candidates are only claimable with mesh evidence
            # in the replayed log (a 1-chip log cannot rank rule tables)
            if obs is None or obs.mesh_degree() <= 1:
                return "no_mesh_evidence"
        if cand.zero_stage is not None and \
                cand.zero_stage not in (0, 1, 2):
            return "zero_stage_invalid"
        return None

    @staticmethod
    def _check_hbm(cand: Candidate,
                   obs: Optional["RunLogObservations"]) -> Optional[str]:
        """HBM-ledger headroom gate: project the ledger at the scaled
        batch (params/optimizer state fixed, activation/temp bytes scale
        linearly) against the device capacity. No capacity or no ledger
        evidence ⇒ the scaled batch is unprovable ⇒ rejected."""
        capacity = float(_flags.flag("tuner_hbm_capacity_bytes"))
        if capacity <= 0:
            return "hbm_capacity_unknown"
        if obs is None:
            return "hbm_no_ledger_evidence"
        fixed, scaled = obs.ledger_split()
        if fixed is None:
            return "hbm_no_ledger_evidence"
        projected = fixed + scaled * cand.batch_multiplier
        if projected > capacity * HBM_SAFETY:
            return "hbm_headroom"
        return None


# ---------------------------------------------------------------------------
# offline replay: observations + cost model
# ---------------------------------------------------------------------------


def _pct(vals: Sequence[float], q: float) -> float:
    s = sorted(vals)
    if not s:
        return float("nan")
    idx = min(len(s) - 1, max(0, int(math.ceil(q * len(s))) - 1))
    return s[idx]


class RunLogObservations:
    """Everything the replay needs, extracted from captured telemetry:
    step-time observations keyed by (steps_per_dispatch, batch), decode
    tokens/s observations, per-program roofline records, last gauges and
    summed counters. Accepts raw telemetry JSONL records AND
    finalize_bench_result-style bench rows (one file may mix both)."""

    def __init__(self):
        self.step_rows: List[Dict[str, Any]] = []
        self.tokens_rows: List[Dict[str, Any]] = []
        self.cost_programs: List[Dict[str, Any]] = []
        self.gauges: Dict[str, Any] = {}
        self.counters: Dict[str, float] = {}
        self.mesh_shape: Optional[Dict[str, int]] = None
        self.run_ms: List[float] = []
        self.run_steps_ms: List[float] = []
        self.sources: List[str] = []
        self.malformed = 0

    # -- loading -------------------------------------------------------------
    @classmethod
    def load(cls, paths) -> "RunLogObservations":
        obs = cls()
        for path in ([paths] if isinstance(paths, str) else list(paths)):
            obs.sources.append(os.path.abspath(path))
            with open(path) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        doc = json.loads(line)
                    except ValueError:
                        obs.malformed += 1
                        continue
                    obs.add(doc)
        obs.finish()
        return obs

    def add(self, doc: Any):
        if not isinstance(doc, dict):
            self.malformed += 1
            return
        if isinstance(doc.get("parsed"), dict):     # BENCH_r*.json wrapper
            doc = doc["parsed"]
        if "kind" in doc:
            self._add_record(doc)
        elif "metric" in doc and isinstance(doc.get("value"), (int, float)):
            self._add_bench_row(doc)
        else:
            self.malformed += 1

    def _add_record(self, rec: Dict[str, Any]):
        kind, name = rec.get("kind"), rec.get("name", "")
        value = rec.get("value")
        attrs = rec.get("attrs") or {}
        if kind == "metric":
            row = {"metric": name, "value": value,
                   "unit": attrs.get("unit"), "extra": attrs}
            self._add_bench_row(row)
        elif kind == "cost" and isinstance(attrs, dict):
            self.cost_programs.append(attrs)
        elif kind == "gauge":
            self.gauges[name] = value
        elif kind == "counter" and isinstance(value, (int, float)):
            self.counters[name] = self.counters.get(name, 0.0) + value
        elif kind == "timer" and isinstance(value, (int, float)):
            if name == "executor.run_ms":
                self.run_ms.append(float(value))
            elif name == "executor.run_steps_ms":
                self.run_steps_ms.append(float(value))

    def _add_bench_row(self, row: Dict[str, Any]):
        ex = row.get("extra") or {}
        unit = str(row.get("unit") or "").lower()
        ms = ex.get("ms_per_step")
        if isinstance(ms, (int, float)):
            self.step_rows.append({
                "k": max(1, int(ex.get("steps_per_dispatch") or 1)),
                "batch": ex.get("batch"),
                "ms_per_step": float(ms),
                "metric": row.get("metric")})
        if "tokens/s" in unit or "tok/s" in unit:
            self.tokens_rows.append({
                "tokens_per_s": float(row["value"]),
                "config": dict(ex)})
        if isinstance(ex.get("mesh_shape"), dict):
            self.mesh_shape = {str(a): int(s)
                               for a, s in ex["mesh_shape"].items()}

    def finish(self):
        """Derive step observations from raw timer samples when the log
        carries no bench rows: executor.run_ms is per-step at k=1;
        executor.run_steps_ms is per-DISPATCH, divided by the fused k
        recovered from the fused_steps/fused_dispatches counters."""
        if self.run_ms and not any(r["k"] == 1 for r in self.step_rows):
            self.step_rows.append({
                "k": 1, "batch": None,
                "ms_per_step": _pct(self.run_ms, 0.5),
                "metric": "executor.run_ms"})
        disp = self.counters.get("executor.fused_dispatches", 0)
        steps = self.counters.get("executor.fused_steps", 0)
        if self.run_steps_ms and disp > 0 and steps > 0:
            k = max(1, int(round(steps / disp)))
            if not any(r["k"] == k for r in self.step_rows):
                self.step_rows.append({
                    "k": k, "batch": None,
                    "ms_per_step": _pct(self.run_steps_ms, 0.5) / k,
                    "metric": "executor.run_steps_ms"})
        telemetry.counter_add(
            "tuner.replay_observations",
            len(self.step_rows) + len(self.tokens_rows)
            + len(self.cost_programs))

    # -- derived evidence ----------------------------------------------------
    def mesh_degree(self) -> int:
        if not self.mesh_shape:
            return 1
        deg = 1
        for s in self.mesh_shape.values():
            deg *= max(1, int(s))
        return deg

    def ledger_split(self) -> Tuple[Optional[float], float]:
        """(fixed_bytes, batch_scaled_bytes) from the captured gauges:
        params + optimizer state are batch-invariant, activation/temp
        bytes scale with batch. (None, 0) without ledger evidence."""
        total = self.gauges.get("mem.hbm_total_bytes")
        if not isinstance(total, (int, float)):
            return None, 0.0
        fixed = 0.0
        for g in ("mem.param_bytes", "mem.opt_state_bytes"):
            v = self.gauges.get(g)
            if isinstance(v, (int, float)):
                fixed += float(v)
        return fixed, max(0.0, float(total) - fixed)

    def roofline_summary(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for rec in self.cost_programs:
            v = str(rec.get("roofline", "unknown"))
            out[v] = out.get(v, 0) + 1
        return out

    def base_batch(self) -> Optional[int]:
        batches = [r["batch"] for r in self.step_rows
                   if isinstance(r.get("batch"), (int, float))]
        return int(batches[-1]) if batches else None


class ReplayModel:
    """The measured objective, in order of trust:

    1. **measured** — per-k median ms_per_step straight from the log: a
       candidate whose dispatch depth WAS captured scores its measured
       value (this is what catches a hand-picked k that is wrong for
       the actual hardware, e.g. a fused loop that loses on a CPU);
    2. **modeled** — the fused-dispatch amortization law
       ``ms_per_step(k) = device_ms + host_ms / k`` least-squares
       fitted on x = 1/k from >= 2 distinct observed k, used ONLY when
       the fit is physically valid (host_ms >= 0, device_ms > 0): it
       extrapolates to unobserved k and scales device time linearly
       with batch (the objective is ms per base-batch-equivalent step,
       so batch scaling amortizes the host term);
    3. **none** — anything else returns None
       (``tuner.insufficient_evidence``): the tuner never invents a win
       the log cannot defend."""

    def __init__(self, obs: RunLogObservations):
        self.obs = obs
        self.measured: Dict[int, float] = {}
        self.device_ms: Optional[float] = None
        self.host_ms: Optional[float] = None
        self.base_k = 1
        self._fit()

    def _fit(self):
        by_k: Dict[int, List[float]] = {}
        for r in self.obs.step_rows:
            by_k.setdefault(int(r["k"]), []).append(float(r["ms_per_step"]))
        if not by_k:
            return
        self.measured = {k: _pct(v, 0.5) for k, v in sorted(by_k.items())}
        self.base_k = min(self.measured)
        pts = sorted(self.measured.items())
        if len(pts) < 2:
            return
        # least squares ms = device + host * (1/k)
        xs = [1.0 / k for k, _ in pts]
        ys = [ms for _, ms in pts]
        n = len(pts)
        mx, my = sum(xs) / n, sum(ys) / n
        denom = sum((x - mx) ** 2 for x in xs)
        host = (sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / denom
                if denom > 0 else 0.0)
        device = my - host * mx
        if host >= 0.0 and device > 0.0:
            self.host_ms = host
            self.device_ms = device
        # else: the log contradicts the amortization law (e.g. the
        # fused scan LOSES on this backend) — no extrapolation, the
        # measured per-k table is the only evidence

    def has_evidence(self) -> bool:
        return bool(self.measured)

    def fit_valid(self) -> bool:
        return self.device_ms is not None and self.host_ms is not None

    def predict_step_ms(self, k: int, batch_multiplier: float = 1.0
                        ) -> Optional[Tuple[float, str]]:
        """(predicted ms per base-batch-equivalent step, basis) at
        dispatch depth k and scaled batch; None when the evidence
        cannot support the point."""
        k = max(1, int(k))
        if batch_multiplier == 1.0 and k in self.measured:
            return self.measured[k], "measured"
        if self.fit_valid():
            assert self.device_ms is not None and self.host_ms is not None
            ms = (self.device_ms * batch_multiplier + self.host_ms / k)
            return ms / batch_multiplier, "modeled"
        return None

    def default_objective(self) -> Optional[float]:
        got = self.predict_step_ms(
            max(1, int(_flags.flag("exec_steps_per_dispatch"))))
        if got is not None:
            return got[0]
        # the incumbent k was never captured and no fit extrapolates to
        # it: fall back to the base measured point so candidates still
        # have a reference (conservative — the incumbent is assumed no
        # worse than the best captured run)
        return self.measured.get(self.base_k)

    def score(self, cand: Candidate) -> Tuple[Optional[float], str]:
        """(replayed objective, basis) for one candidate. Knobs the
        model has no evidence for leave the objective at the default's
        (basis 'default'): the candidate cannot claim a win."""
        k = int(cand.flags.get("exec_steps_per_dispatch",
                               _flags.flag("exec_steps_per_dispatch")))
        touches_model = ("exec_steps_per_dispatch" in cand.flags
                         or cand.batch_multiplier != 1.0)
        if not touches_model:
            return self.default_objective(), "default"
        got = self.predict_step_ms(k, cand.batch_multiplier)
        if got is None:
            telemetry.counter_add("tuner.insufficient_evidence", 1,
                                  candidate=cand.label)
            return self.default_objective(), "default"
        return got


class SearchResult:
    def __init__(self, ranked, best, default_score, objective, obs):
        self.ranked: List[Dict[str, Any]] = ranked
        self.best: Optional[Candidate] = best
        self.default_score = default_score
        self.objective = objective
        self.obs = obs

    def improved(self) -> bool:
        if self.best is None or self.default_score is None:
            return False
        top = self.ranked[0]
        return top["score"] is not None and \
            top["score"] < self.default_score


def offline_search(obs: RunLogObservations,
                   space: Optional[SearchSpace] = None) -> SearchResult:
    """Rank the admissible candidates by replayed objective (ms per
    base-batch-equivalent step, lower is better), then try ONE combined
    candidate merging every per-knob winner — greedy coordinate search
    with a single combination pass, bounded and deterministic."""
    space = space or SearchSpace()
    model = ReplayModel(obs)
    if not model.has_evidence():
        raise TunerError(
            "run log carries no step-time observations (no bench rows, "
            "no executor.run_ms samples) — nothing to replay")
    default_score = model.default_objective()
    scored: List[Dict[str, Any]] = []
    # the best improving candidate PER KNOB (each sweep candidate moves
    # exactly one knob) — the combination pass merges across knobs only
    winners: Dict[str, Tuple[float, Candidate]] = {}
    for cand in space.enumerate():
        reason = space.check(cand, obs)
        if reason is not None:
            scored.append({"candidate": cand, "score": None,
                           "basis": "rejected", "reason": reason})
            continue
        score, basis = model.score(cand)
        scored.append({"candidate": cand, "score": score, "basis": basis})
        if score is not None and default_score is not None and \
                basis in ("modeled", "measured") and \
                score < default_score:
            knob = getattr(cand, "knob", cand.label)
            if knob not in winners or score < winners[knob][0]:
                winners[knob] = (score, cand)
    if len(winners) > 1:
        merged = Candidate(changes=len(winners), label="combined")
        for _score, w in winners.values():
            merged.flags.update(w.flags)
            if w.batch_multiplier != 1.0:
                merged.batch_multiplier = w.batch_multiplier
        if space.check(merged, obs) is None:
            score, basis = model.score(merged)
            scored.append({"candidate": merged, "score": score,
                           "basis": basis})
    admissible = [s for s in scored if s["score"] is not None]
    # rank: best objective first; ties prefer the fewest changes (the
    # incumbent wins a dead heat)
    admissible.sort(key=lambda s: (s["score"], s["candidate"].changes))
    rejected = [s for s in scored if s["score"] is None]
    ranked = admissible + rejected
    best = admissible[0]["candidate"] if admissible else None
    return SearchResult(ranked, best, default_score,
                        "step_ms_per_base_batch", obs)


# ---------------------------------------------------------------------------
# tuned profiles
# ---------------------------------------------------------------------------

_active_profile: List[Optional[Dict[str, Any]]] = [None]


def make_profile(cand: Candidate, *, objective: str,
                 replayed: Optional[float],
                 default_objective: Optional[float],
                 origin: Optional[Dict[str, Any]] = None,
                 workload: str = "") -> Dict[str, Any]:
    """Build the tuned-profile document the bench harness loads via
    ``--profile``. The profile hash covers the CONFIG payload only, so
    re-deriving the same config from a different log hashes identically."""
    from ..kernels import _build
    from ..parallel import axis_rules as _axis

    pallas_fp = _build.sources_fingerprint()
    doc = {
        "format": PROFILE_FORMAT,
        "profile_hash": cand.fingerprint(),
        "workload": workload,
        "origin": dict(origin or {}),
        "flags": {k: cand.flags[k] for k in sorted(cand.flags)},
        "batch_multiplier": cand.batch_multiplier,
        "axis_rules": cand.axis_rules,
        "zero_stage": cand.zero_stage,
        "objective": {"name": objective, "replayed": replayed,
                      "default": default_objective},
        "fingerprints": {"axis_rules": _axis.fingerprint(),
                         "pallas_kernels": pallas_fp},
    }
    return doc


def save_profile(doc: Dict[str, Any], path: str):
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True, default=str)
        fh.write("\n")


def load_profile(path: str) -> Dict[str, Any]:
    """Load + validate a tuned profile (typed ProfileError on junk)."""
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except (OSError, ValueError) as e:
        raise ProfileError(f"cannot read profile {path!r}: {e}") from e
    if not isinstance(doc, dict) or doc.get("format") != PROFILE_FORMAT:
        raise ProfileError(
            f"{path!r} is not a {PROFILE_FORMAT} document "
            f"(format={doc.get('format') if isinstance(doc, dict) else None!r})")
    if not isinstance(doc.get("flags"), dict):
        raise ProfileError(f"profile {path!r}: 'flags' must be an object")
    if not isinstance(doc.get("profile_hash"), str):
        raise ProfileError(f"profile {path!r}: missing profile_hash")
    return doc


# flags of the reference's search space that nothing in the port reads,
# with the only value each may take here (its default), and why
UNREAD_FLAGS = {
    "exec_steps_per_dispatch": (1, "its readers (train_from_dataset, "
                                   "hapi) are ROADMAP A9/A11"),
    "pallas_kv_chunk_tokens": (1024, "the CUDA paged-attention kernel's "
                                     "chunk is fixed at 128 tokens"),
}


def check_port_support(flags: Dict[str, Any],
                       zero_stage: Optional[int] = None):
    """Raise ProfileError for a config that moves a flag the port does not
    read off its default, or asks for ZeRO (ROADMAP A8)."""
    for name, value in (flags or {}).items():
        key = name[6:] if name.startswith("FLAGS_") else name
        if key in UNREAD_FLAGS:
            default, why = UNREAD_FLAGS[key]
            try:
                moved = int(value) != default
            except (TypeError, ValueError):
                moved = True
            if moved:
                raise ProfileError(
                    f"{key}={value!r}: the port has no reader for this "
                    f"flag ({why}); only its default {default} applies")
    if zero_stage:
        raise ProfileError(f"zero_stage={zero_stage}: ZeRO sharding is not "
                           f"in the port (ROADMAP A8)")


def apply_profile(doc: Dict[str, Any],
                  origin_path: str = "") -> Dict[str, Any]:
    """Apply a tuned profile to the live config surface: validated flag
    overrides (core/flags.py apply), the axis-rule table when the profile
    carries one, and PT_BENCH_BATCH for a batch multiplier. Returns the
    prior flag values and registers the profile as active
    (``profile_provenance``). A profile the port cannot honour raises
    ProfileError before anything changes (``check_port_support``)."""
    check_port_support(doc.get("flags") or {}, doc.get("zero_stage"))
    prior = _flags.apply(doc.get("flags") or {})
    if doc.get("axis_rules") is not None:
        from ..parallel import axis_rules as _axis

        _axis.set_rules([tuple(r) for r in doc["axis_rules"]])
    mult = float(doc.get("batch_multiplier") or 1.0)
    if mult != 1.0 and os.environ.get("PT_BENCH_BATCH"):
        os.environ["PT_BENCH_BATCH"] = str(
            max(1, int(round(int(os.environ["PT_BENCH_BATCH"]) * mult))))
    _active_profile[0] = dict(doc)
    if origin_path:
        _active_profile[0].setdefault("origin", {})
        _active_profile[0]["origin"].setdefault("path", origin_path)
    telemetry.counter_add("tuner.profiles_loaded", 1,
                          profile=doc.get("profile_hash"))
    telemetry.event("tuner", "profile_applied", None,
                    {"profile_hash": doc.get("profile_hash"),
                     "workload": doc.get("workload"),
                     "flags": doc.get("flags")})
    return prior


def active_profile() -> Optional[Dict[str, Any]]:
    return _active_profile[0]


def clear_active_profile():
    _active_profile[0] = None


def profile_provenance():
    """A bench row's ``extra.tuned_profile``: the active profile's
    {profile_hash, origin}, or the literal "hand-picked", so tuned rows
    stay apart from hand-picked ones."""
    prof = _active_profile[0]
    if prof is None:
        return "hand-picked"
    origin = prof.get("origin") or {}
    return {"profile_hash": prof.get("profile_hash"),
            "origin": origin.get("run_id") or origin.get("run_log")
            or origin.get("path") or "unknown"}


# ---------------------------------------------------------------------------
# online A/B trial
# ---------------------------------------------------------------------------


class TrialResult:
    def __init__(self, status: str, reason: str, evals: int,
                 trial_p99: Optional[float] = None,
                 control_p99: Optional[float] = None):
        self.status = status          # "promoted" | "rolled_back"
        self.reason = reason
        self.evals = evals
        self.trial_p99 = trial_p99
        self.control_p99 = control_p99

    def as_dict(self) -> Dict[str, Any]:
        return {"status": self.status, "reason": self.reason,
                "evals": self.evals, "trial_p99": self.trial_p99,
                "control_p99": self.control_p99}

    def __repr__(self):
        return f"TrialResult({self.as_dict()})"


class OnlineTrial:
    """A/B-flip one candidate's FLAG overrides onto a single cluster
    replica (the rolling-swap machinery), steer a bounded traffic slice there,
    and promote or roll back on measured per-arm p99 deltas.

    Safety contract:

    * the incumbent flag surface is snapshotted before application and
      restored EXACTLY on rollback — zero residual overrides;
    * the fleet's model version is never changed by the trial; rollback
      leaves every replica on the incumbent version and config;
    * an SLO rule trip (core/incidents.py) mid-trial aborts within ONE
      evaluation tick (``tuner.slo_aborts``), and every rollback books
      exactly one ``tuner.rollbacks`` increment.
    """

    def __init__(self, cluster, candidate_flags: Dict[str, Any],
                 fraction: Optional[float] = None,
                 eval_interval_s: Optional[float] = None,
                 min_requests: Optional[int] = None,
                 promote_ratio: Optional[float] = None,
                 abort_ratio: Optional[float] = None,
                 max_evals: Optional[int] = None,
                 label: str = "candidate"):
        self.cluster = cluster
        self.router = cluster.router
        self.candidate_flags = dict(candidate_flags)
        self.fraction = float(_flags.flag("tuner_traffic_fraction")
                              if fraction is None else fraction)
        self.eval_interval_s = float(_flags.flag("tuner_eval_interval_s")
                                     if eval_interval_s is None
                                     else eval_interval_s)
        self.min_requests = int(_flags.flag("tuner_min_requests")
                                if min_requests is None else min_requests)
        self.promote_ratio = float(_flags.flag("tuner_promote_ratio")
                                   if promote_ratio is None
                                   else promote_ratio)
        self.abort_ratio = float(_flags.flag("tuner_abort_ratio")
                                 if abort_ratio is None else abort_ratio)
        self.max_evals = int(_flags.flag("tuner_max_evals")
                             if max_evals is None else max_evals)
        self.label = label
        self.trial_replica: Optional[str] = None
        self.result: Optional[TrialResult] = None
        self._snapshot: Optional[Dict[str, Any]] = None
        self._incumbent_version: Optional[int] = None
        self._slo_base = 0
        self._t0 = 0.0
        self._evals = 0
        self._started = False

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "OnlineTrial":
        """Snapshot the incumbent, apply the candidate flags, flip ONE
        replica onto the candidate config through the swap machinery and
        open the traffic split. On any application failure the trial
        rolls back immediately and raises TunerError."""
        if self._started:
            raise TunerError("trial already started")
        check_port_support(self.candidate_flags)
        handle = next((h for h in self.router.handles() if h.ready), None)
        if handle is None:
            raise TunerError("no ready replica to run the trial on")
        telemetry.counter_add("tuner.trials", 1, candidate=self.label)
        telemetry.event("tuner", "trial_started", None,
                        {"candidate": self.label,
                         "flags": self.candidate_flags,
                         "replica": handle.name,
                         "fraction": self.fraction})
        self._started = True
        self.trial_replica = handle.name
        self._snapshot = _flags.snapshot()
        self._incumbent_version = self.cluster.current_version
        self._slo_base = int(telemetry.counters().get("slo.trips", 0))
        self._t0 = time.time()
        try:
            _flags.apply(self.candidate_flags)
        except ConfigError:
            self._rollback("candidate_invalid", retune=False)
            raise
        self.router.set_trial(handle.name, self.fraction)
        if not self.cluster.retune_replica(handle.name):
            self._rollback("apply_failed")
            raise TunerError(
                f"candidate config never took on {handle.name} "
                f"(swap failed) — rolled back")
        # arm latency evidence starts AFTER the candidate is live
        self._t0 = time.time()
        return self

    def _arm_latencies(self) -> Tuple[List[float], List[float]]:
        trial, control = [], []
        for h in self.router.handles():
            lats = h.dispatch_latencies(self._t0)
            if h.name == self.trial_replica:
                trial = lats
            else:
                control.extend(lats)
        return trial, control

    def _slo_tripped(self) -> bool:
        if int(telemetry.counters().get("slo.trips", 0)) > self._slo_base:
            return True
        try:
            from . import incidents

            if incidents.armed():
                wd = incidents.watchdog()
                return bool(wd.health()["firing"])
        except Exception:
            pass
        return False

    def evaluate_once(self, now: Optional[float] = None
                      ) -> Optional[TrialResult]:
        """One evaluation tick: SLO check first (a trip aborts HERE,
        before any latency arithmetic), then the per-arm p99 verdict.
        Returns the final TrialResult or None while undecided."""
        if self.result is not None:
            return self.result
        if not self._started:
            raise TunerError("trial not started")
        self._evals += 1
        from . import incidents

        incidents.tick(now)
        if self._slo_tripped():
            telemetry.counter_add("tuner.slo_aborts", 1,
                                  candidate=self.label)
            return self._rollback("slo_trip")
        trial, control = self._arm_latencies()
        tp99 = _pct(trial, 0.99) if trial else None
        cp99 = _pct(control, 0.99) if control else None
        if len(trial) >= self.min_requests and \
                len(control) >= self.min_requests:
            assert tp99 is not None and cp99 is not None
            if tp99 >= cp99 * self.abort_ratio:
                return self._rollback("latency_regression",
                                      tp99=tp99, cp99=cp99)
            if tp99 <= cp99 * self.promote_ratio:
                return self._promote(tp99, cp99)
        if self._evals >= self.max_evals:
            return self._rollback("undecided", tp99=tp99, cp99=cp99)
        return None

    def run(self) -> TrialResult:
        """Drive evaluation ticks at the configured cadence until the
        trial resolves (the CLI entry point; tests call evaluate_once
        directly for determinism)."""
        if not self._started:
            self.start()
        while self.result is None:
            time.sleep(self.eval_interval_s)
            self.evaluate_once()
        return self.result

    # -- verdicts ------------------------------------------------------------
    def _promote(self, tp99: float, cp99: float) -> TrialResult:
        """Promote the candidate fleet-wide: the flags stay applied and
        every OTHER replica is re-tuned onto the candidate config (the
        rolling one-at-a-time discipline of roll_to). The model version
        is untouched — this was a config trial."""
        for h in self.router.handles():
            if h.name != self.trial_replica:
                self.cluster.retune_replica(h.name)
        self.router.clear_trial()
        telemetry.counter_add("tuner.promotions", 1, candidate=self.label)
        self.result = TrialResult("promoted", "latency_win", self._evals,
                                  tp99, cp99)
        telemetry.event("tuner", "trial_promoted", tp99,
                        self.result.as_dict())
        return self.result

    def _rollback(self, reason: str, tp99=None, cp99=None,
                  retune: bool = True) -> TrialResult:
        """Restore the exact incumbent config. Exactly one
        ``tuner.rollbacks`` increment per trial, guarded by the result
        latch."""
        if self.result is not None:
            return self.result
        assert self._snapshot is not None
        _flags.apply(self._snapshot)
        self.router.clear_trial()
        if retune and self.trial_replica is not None:
            # the replica must come back to the incumbent config even
            # under injected faults: retry the re-tune a few times
            ok = False
            for _ in range(5):
                if self.cluster.retune_replica(self.trial_replica):
                    ok = True
                    break
                time.sleep(0.05)
            if not ok:
                telemetry.counter_add("tuner.rollback_errors", 1,
                                      replica=self.trial_replica)
        telemetry.counter_add("tuner.rollbacks", 1, candidate=self.label,
                              reason=reason)
        self.result = TrialResult("rolled_back", reason, self._evals,
                                  tp99, cp99)
        telemetry.event("tuner", "trial_rolled_back", tp99,
                        dict(self.result.as_dict(),
                             incumbent_version=self._incumbent_version))
        return self.result
