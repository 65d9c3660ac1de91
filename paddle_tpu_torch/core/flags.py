"""FLAGS registry — env-settable runtime configuration.

The port keeps the part of ``paddle_tpu/core/flags.py`` that its serving
and inference planes read: the ``FLAGS_decode_*`` entries behind
``DecodeConfig``, the ``serving_*`` entries behind ``ServingConfig``,
``predictor_cache_capacity``, ``verify_passes``, ``ckpt_verify``, the
``router_*``, ``serving_model_poll_s`` and ``cluster_max_restarts``
entries of the router and the cluster controller, the fault-injection,
tracing and metrics-window entries, the observability plane's entries
(the run-log sink's ``telemetry_*``, ``cost_capture``,
``device_peak_*``, ``goodput_publish_s``, ``profiler_max_events``, the
flight recorder's ``blackbox_*`` and the executor's ``verify_program``), the SLO watchdog's and the incident
records' entries (core/incidents.py), the ``scaler_*`` entries of the
scale policy (distributed/scaler.py), the ``tuner_*`` entries of the
autotuner (core/tuner.py), the typed bucket-list parser, ``snapshot``
(every flag's value: ``apply(snapshot())`` restores exactly), ``apply``
(a validated bulk override that returns the prior values) and
``overrides`` (its scoped form). Each flag has a default and is
overridable via the environment (``FLAGS_<name>=...``) at import.

``exec_steps_per_dispatch`` and ``pallas_kv_chunk_tokens`` keep the
reference's names and defaults so that the tuner's search space is the
reference's, but nothing in the port reads them: ``Executor.run_steps``
exists, but the flag's readers, ``train_from_dataset`` and
``hapi.Model.fit``, are ROADMAP A9 and A11; and the CUDA paged-attention
kernel's chunk is fixed at 128 tokens. ``core/tuner.py`` refuses a profile that moves either.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Any, Dict, List, Optional


class ConfigError(ValueError):
    """Typed configuration-surface error."""


class UnknownFlagError(ConfigError):
    """A flag name that is not in the registry."""


class BucketConfigError(ConfigError):
    """A bucket-boundary list that is not a strictly increasing sequence
    of positive integers (or fails its coverage requirement)."""


class _Flag:
    __slots__ = ("name", "value", "default", "doc", "type")

    def __init__(self, name, default, doc):
        self.name = name
        self.default = default
        self.value = default
        self.doc = doc
        self.type = type(default)


_REGISTRY: Dict[str, _Flag] = {}


def _coerce(f: _Flag, val):
    if f.type is bool:
        if isinstance(val, str):
            return val.lower() in ("1", "true", "yes", "on")
        return bool(val)
    return f.type(val)


def define_flag(name: str, default, doc: str = ""):
    f = _Flag(name, default, doc)
    env = os.environ.get(f"FLAGS_{name}")
    if env is not None:
        f.value = _coerce(f, env)
    _REGISTRY[name] = f
    return f


def _resolve_key(name: str) -> str:
    key = name[6:] if name.startswith("FLAGS_") else name
    if key not in _REGISTRY:
        raise UnknownFlagError(f"unknown flag '{name}' (no FLAGS_{key} "
                               f"registered)")
    return key


def flag(name: str):
    return _REGISTRY[_resolve_key(name)].value


def all_flags() -> Dict[str, Any]:
    return {n: f.value for n, f in _REGISTRY.items()}


def snapshot() -> Dict[str, Any]:
    """Every flag's current value, keyed by bare name: the incumbent
    config an autotune trial (core/tuner.py) or a test rolls back to.
    ``apply(snapshot())`` is an exact restore."""
    return {n: f.value for n, f in _REGISTRY.items()}


def apply(overrides: Dict[str, Any]) -> Dict[str, Any]:
    """Validated bulk override: every name is resolved and every value
    coerced BEFORE any flag changes. Returns {bare_name: prior_value} of
    the touched flags; ``apply`` it to roll back."""
    resolved: Dict[str, Any] = {}
    for n, v in overrides.items():
        key = _resolve_key(n)
        f = _REGISTRY[key]
        try:
            resolved[key] = _coerce(f, v)
        except (TypeError, ValueError) as e:
            raise ConfigError(
                f"flag '{key}' cannot take value {v!r} "
                f"({f.type.__name__} expected): {e}") from e
    prior = {k: _REGISTRY[k].value for k in resolved}
    for k, v in resolved.items():
        _REGISTRY[k].value = v
    return prior


@contextmanager
def overrides(mapping: Optional[Dict[str, Any]] = None, **kw):
    """Scoped flag override: applies the (validated) overrides and
    restores the prior values on exit, also when the body raises."""
    ov: Dict[str, Any] = dict(mapping or {})
    ov.update(kw)
    prior = apply(ov)
    try:
        yield prior
    finally:
        apply(prior)


def set_flags(flags: Dict[str, Any]):
    """paddle.set_flags."""
    apply(flags)


def parse_buckets(spec, name: str = "buckets",
                  cover: Optional[int] = None,
                  cover_exact: bool = False) -> Optional[List[int]]:
    """Parse + validate a bucket-boundary list (a comma-separated flag
    string or a sequence of ints): positive, strictly increasing, and
    reaching ``cover`` (exactly, with ``cover_exact``). Returns None for
    an empty spec (the caller's default applies)."""
    if spec is None:
        vals: List[int] = []
    else:
        parts = ([b for b in spec.strip().split(",") if b.strip()]
                 if isinstance(spec, str) else spec)
        try:
            vals = [int(b) for b in parts]
        except (TypeError, ValueError) as e:
            raise BucketConfigError(
                f"{name}: non-integer bucket boundary in {spec!r}") from e
    if not vals:
        return None
    if vals[0] < 1:
        raise BucketConfigError(
            f"{name}: bucket boundaries must be >= 1, got {vals}")
    for a, b in zip(vals, vals[1:]):
        if b <= a:
            raise BucketConfigError(
                f"{name}: bucket boundaries must be strictly increasing, "
                f"got {vals}")
    if cover is not None:
        if cover_exact and vals[-1] != cover:
            raise BucketConfigError(
                f"{name}: bucket set {vals} must end exactly at {cover}")
        if vals[-1] < cover:
            raise BucketConfigError(
                f"{name}: bucket set {vals} does not cover {cover}")
    return vals


# -- program passes and the inference predictor (core/passes.py,
#    inference/predictor.py) ------------------------------------------------

define_flag("verify_passes", True,
            "verify the program after every pass applied through "
            "core.passes.apply_passes: a pass that leaves a dangling "
            "input, an unregistered op or a write hazard raises "
            "ProgramVerifyError naming the pass; VarDescs a pass orphans "
            "are pruned (verifier.pruned_vars)")
define_flag("predictor_cache_capacity", 32,
            "LRU bound on AnalysisPredictor's per-signature entries (a "
            "CUDA graph each on the card): under shape churn the oldest "
            "is evicted (predictor.cache_evictions); <= 0 disables the "
            "bound")
define_flag("ckpt_verify", True,
            "verify a published model dir's files (size + sha256) against "
            "its COMMIT manifest before it is served (checkpoint.py)")

# -- micro-batching serving engine (serving/engine.py) -----------------------

define_flag("serving_max_batch_size", 8,
            "upper bound on coalesced rows per engine batch: requests "
            "sharing a shape signature are merged up to this many rows "
            "(a single oversized request still runs, in its own batch)")
define_flag("serving_batch_timeout_ms", 5.0,
            "how long the engine holds a partial batch open for more "
            "same-signature rows before flushing it (from the head "
            "request's enqueue); 0 dispatches immediately")
define_flag("serving_max_queue_depth", 256,
            "admission bound on queued requests: submits beyond it raise "
            "ServerOverloadedError (serving.rejects)")
define_flag("serving_default_deadline_ms", 0.0,
            "per-request deadline when the caller gives none: a request "
            "still queued past it fails with DeadlineExceededError at "
            "dequeue; <= 0 means no deadline")
define_flag("serving_buckets", "",
            "comma-separated leading-dim bucket boundaries the engine pads "
            "coalesced batches up to (one predictor entry each); empty = "
            "powers of two up to serving_max_batch_size")

# -- generative decode engine (serving/decode.py) ---------------------------

define_flag("decode_max_slots", 8,
            "decode-state slots: the most sequences decoded at once; the "
            "step program runs at fixed slot-array shapes")
define_flag("decode_buckets", "",
            "comma-separated slot-array sizes the step pads the active "
            "set up to; empty = ONE bucket of decode_max_slots (fixed "
            "step shape, so continuous == sequential bit for bit)")
define_flag("decode_page_size", 16, "tokens per KV-cache page")
define_flag("decode_kv_pages", 64,
            "pages in the preallocated KV pool (per layer); admission "
            "refuses a request whose worst-case page need can never fit")
define_flag("decode_max_queue_depth", 256,
            "admission bound on queued generation requests")
define_flag("decode_default_deadline_ms", 0.0,
            "per-request generation deadline when the caller gives none; "
            "<= 0 means no deadline")
define_flag("decode_max_new_tokens", 64,
            "default generation budget when a request sets none")
define_flag("decode_weight_quant", "none",
            "'none' serves fp32 weights, 'int8' per-output-channel "
            "weight-only int8 through the int8 GEMM kernel")
define_flag("decode_prefix_cache", False,
            "content-addressed prefix sharing (serving/prefix_store.py): "
            "every prefill runs page-sized chunks through the chunked "
            "prefill program, and a prompt whose leading full pages are "
            "cached replays only its suffix")
define_flag("decode_role", "unified",
            "disaggregated-serving role: 'unified' prefills and decodes "
            "locally, 'prefill' ships KV pages over POST /v1/prefill, "
            "'decode' with disagg_prefill_urls installs shipped pages "
            "instead of prefilling (serving/disagg.py)")
define_flag("disagg_prefill_urls", "",
            "comma-separated prefill-tier URLs a decode-role replica "
            "fetches KV page shipments from (POST /v1/prefill); usually "
            "the router's URL, which forwards to a ready prefill-tier "
            "replica. Empty: every prefill runs locally")
define_flag("decode_journal_stride", 1,
            "session journaling: snapshot each journaled request every N "
            "accepted tokens, at the step boundary, to the engine's "
            "journal_sink (<= 0 disables)")
define_flag("decode_step_delay_ms", 0.0,
            "deliberate host-side delay before each decode step: a pacing "
            "knob that keeps generations in flight long enough to kill a "
            "replica mid-generation; 0 (the default) adds nothing")

# -- router and cluster controller (serving/router.py, serving/cluster.py)

define_flag("router_health_interval_s", 0.2,
            "seconds between router probes of each replica (GET /healthz): "
            "readiness gates routing, the scraped queue_depth drives "
            "least-loaded balancing")
define_flag("router_max_retries", 4,
            "retry/failover attempts per routed request beyond the first "
            "(router.retries / router.failovers count them)")
define_flag("router_backoff", 0.02,
            "base seconds of the router's exponential retry backoff "
            "(core/retry.py: doubles per attempt, +/-50% jitter, capped at "
            "1 s, clipped to the request deadline)")
define_flag("router_timeout_s", 30.0,
            "per-request budget in seconds when the client sends no "
            "deadline_ms; <= 0 disables")
define_flag("router_dispatch_timeout_s", 10.0,
            "cap on one dispatch attempt's socket timeout")
define_flag("router_dedup_capacity", 1024,
            "bound on the router's request-id dedup cache: a retried "
            "X-Request-Id already answered replays the cached response "
            "(router.dedup_hits); <= 0 disables")
define_flag("router_session_capacity", 4096,
            "SessionJournal bound: the most session records kept, oldest "
            "evicted first (session.evicted)")
define_flag("serving_model_poll_s", 0.5,
            "seconds between cluster-controller polls of the published-"
            "models root (checkpoint.ModelWatcher): a new verified COMMIT "
            "manifest triggers the rolling swap")
define_flag("cluster_max_restarts", 5,
            "respawn budget per replica slot: a replica that dies is "
            "relaunched (router.replica_restarts) up to this many times")

# -- fault injection, tracing, live metrics (core/faults.py, core/trace.py,
#    core/telemetry.py)

define_flag("fault_spec", "",
            "fault-injection spec (core/faults.py grammar: "
            "'site:trigger[:Exc]' clauses); the PT_FAULT_SPEC env var is a "
            "lower-precedence alias; empty disables injection")
define_flag("fault_seed", 0,
            "seed of probabilistic fault rules (PT_FAULT_SEED env alias "
            "when 0)")
define_flag("trace_sample_rate", 0.0,
            "probability that a root span starts a sampled trace "
            "(core/trace.py); 0 disables; an X-Request-Id forces one")
define_flag("metrics_window_s", 60.0,
            "rolling window of the live metrics (telemetry.windowed, "
            "prometheus_text, /metrics), in seconds")

# -- the observability plane (core/telemetry.py, costmodel.py, goodput.py,
#    incidents.py, profiler.py; the executor's verifier gate) -------------

define_flag("telemetry_path", "",
            "path of the structured-telemetry JSONL run log (core/"
            "telemetry.py); empty disables the sink. The PT_TELEMETRY_LOG "
            "env var is an alias with lower precedence. Render with "
            "tools/perf_report.py")
define_flag("telemetry_buffer_lines", 64,
            "JSONL sink line-batching: records buffer in memory and are "
            "written as one batched write once this many lines are "
            "pending (or telemetry_flush_s elapses, or flush_sink() is "
            "called); 1 restores write-through. Sink write failures are "
            "counted in telemetry.dropped_records, never raised into the "
            "instrumented thread")
define_flag("telemetry_flush_s", 0.25,
            "max seconds a buffered JSONL record waits before the sink "
            "flushes it (inline on the next emit + a lazy daemon flusher "
            "thread); flush also happens at exit and on path change")
define_flag("cost_capture", "auto",
            "per-capture cost/memory capture level (core/costmodel.py): "
            "'off' disables; 'cost' counts the step's flops once per "
            "capture key by running its lowerings on meta tensors under "
            "FlopCounterMode, and its bytes from each op's meta shapes; "
            "'full' adds the peak/argument/temp bytes of the CUDA-graph "
            "capture from torch.cuda.memory_stats; 'auto' (default) "
            "behaves as 'cost' when the run is instrumented (telemetry "
            "sink or metrics server active) and 'off' otherwise. On the "
            "CPU a memory analysis that is unavailable is counted "
            "(costmodel.unavailable); on a CUDA device a failed capture "
            "raises")
define_flag("device_peak_flops", 0.0,
            "peak dense flops/s of one device for the live MFU gauge "
            "and roofline verdicts (core/costmodel.py); <= 0 uses the "
            "built-in device table keyed on the device name and the "
            "dtype of the program's GEMM operands")
define_flag("device_peak_bw", 0.0,
            "peak memory bytes/s of one device for the roofline ridge "
            "point (core/costmodel.py); <= 0 uses the built-in device "
            "table")
define_flag("goodput_publish_s", 2.0,
            "seconds between goodput-ledger publishes on the executor "
            "hot path (goodput.* counters + the goodput.ratio gauge "
            "refreshed on /metrics while the run is live)")
define_flag("profiler_max_events", 1_000_000,
            "ring-buffer bound on the profiler's host-span store — long "
            "runs overwrite the oldest spans instead of growing host "
            "memory without limit; drops are counted in the "
            "profiler.events_dropped telemetry counter")
define_flag("blackbox_max_records", 2048,
            "bound on the always-on flight-recorder ring "
            "(core/incidents.py): the last this-many telemetry records / "
            "trace spans / decode-router events are kept in memory — "
            "independent of any JSONL sink — and bundled into every "
            "kind:'incident' dump; 0 disables the recorder entirely "
            "(incident dumps then carry an empty ring)")
define_flag("blackbox_seconds", 120.0,
            "time horizon of the flight-recorder ring: a snapshot taken "
            "for an incident dump drops records older than this many "
            "seconds even when the ring's record bound has not evicted "
            "them yet")
define_flag("verify_program", False,
            "static program verification gate (core/verify.py): every "
            "program an Executor runs is checked once per (program, "
            "version) — structural integrity (vars exist, ops "
            "registered, required attrs), dataflow (def-before-use, "
            "dangling reads vs the actual feed/scope), write-write "
            "hazards — raising a typed ProgramVerifyError before the "
            "first run instead of an opaque error inside a lowering. "
            "Cheap pure-Python checks only")


# -- knobs of the reference's search space with no reader in the port
#    (see the module docstring) -------------------------------------------

define_flag("exec_steps_per_dispatch", 1,
            "K-step fused execution in the reference; the port has "
            "Executor.run_steps, but the flag's readers (train_from_dataset, "
            "hapi.Model.fit) are ROADMAP A9/A11, so the tuner refuses a "
            "profile that moves it off 1")
define_flag("pallas_kv_chunk_tokens", 1024,
            "KV tokens a chunk of the reference's Pallas paged-attention "
            "kernel; the CUDA kernel's chunk is fixed at 128 tokens, so "
            "the tuner refuses a profile that moves it off 1024")

# -- SLO watchdog and incident records (core/incidents.py) -----------------

define_flag("slo_watchdog", "auto",
            "SLO rule engine arming: 'on' arms rule evaluation, 'off' "
            "disarms it everywhere, 'auto' arms when the router starts or "
            "incidents.arm() is called. Armed, incidents.tick() on the "
            "router's probe cadence evaluates the rules at most every "
            "slo_eval_s")
define_flag("slo_eval_s", 5.0,
            "min seconds between two SLO rule evaluations (inline tick() "
            "or the pt-incidents-watchdog thread)")
define_flag("slo_rules", "",
            "declarative SLO rules: a JSON array of rule objects ({name, "
            "metric, kind: counter|hist|gauge, stat, window_s, threshold "
            "| ratio, direction, min_samples, cooldown_s}) or "
            "@/path/to/rules.json; empty uses the built-in set")
define_flag("incident_rate_limit_s", 30.0,
            "global min spacing between two incident records (per-rule "
            "cooldowns apply on top); a storm of trips counts "
            "incidents.rate_limited instead")
define_flag("incident_ring_records", 256,
            "most recent telemetry events embedded in one incident record")

# -- signal-driven scaling (distributed/scaler.py, serving/cluster.py) -----

define_flag("scaler_min_world", 1,
            "lower bound on the world size a ScalerPolicy may target: "
            "ScaleDown decisions clamp here (scaler.clamped)")
define_flag("scaler_max_world", 8,
            "upper bound on the world size a ScalerPolicy may target: "
            "ScaleUp decisions clamp here (scaler.clamped)")
define_flag("scaler_cooldown_s", 30.0,
            "minimum seconds between two ScalerPolicy decisions: one "
            "inside the cooldown is suppressed (scaler.suppressed_"
            "cooldown), so one saturated window cannot thrash the world")
define_flag("scaler_window_s", 30.0,
            "metrics window (seconds) a ScalerPolicy reads its signals "
            "from (queue saturation, step-time p99, heartbeat verdicts)")
define_flag("scaler_queue_high_frac", 0.85,
            "queue fraction (depth / admission bound) at or above which "
            "the policy scales up (reason queue_saturation)")
define_flag("scaler_queue_low_frac", 0.10,
            "queue fraction at or below which the policy scales down "
            "(reason underutilized), only when the window carried "
            "traffic evidence")
define_flag("scaler_step_p99_high_ms", 0.0,
            "step-time p99 (ms) over the scaler window above which the "
            "policy scales up (reason step_time_p99); 0 disables the rule")

# -- the autotuner (core/tuner.py, tools/autotune.py) ----------------------

define_flag("tuner_traffic_fraction", 0.25,
            "traffic slice the router steers onto the trial replica of an "
            "online A/B trial: every ~1/fraction-th routed request; "
            "clamped to (0, 0.5] so the control arm carries the majority")
define_flag("tuner_eval_interval_s", 1.0,
            "seconds between two online-trial evaluation ticks")
define_flag("tuner_min_requests", 8,
            "requests each arm must have served before a latency verdict "
            "(an SLO trip aborts regardless)")
define_flag("tuner_promote_ratio", 0.95,
            "promotion gate: the trial arm's p99 <= control p99 * this")
define_flag("tuner_abort_ratio", 1.25,
            "abort gate: a trial arm whose p99 exceeds control p99 * this "
            "rolls back at once")
define_flag("tuner_max_evals", 10,
            "evaluation ticks before an undecided trial rolls back")
define_flag("tuner_hbm_capacity_bytes", 0,
            "per-device memory capacity the offline tuner's headroom "
            "constraint gates batch-size candidates against (rejected "
            "above capacity * 0.92); 0: batch scaling is unprovable")
