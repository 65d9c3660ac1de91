"""Elastic replica scaling and the scale policy, on the CPU.

* The reference's own cases (``tests/test_elastic_resize.py``
  ``TestScalerPolicy``, ``TestSLOScalerPolicy``, ``TestClusterAutoscale``),
  imported and run as they are with the names they import pointed at the
  port's (the policy, the incident watchdog, telemetry, the cluster
  controller on the CPU). The models they serve are the reference's
  (its ``_save_mlp``), published with the reference's
  ``checkpoint.publish_model``.
* The same ``ScaleDecision`` from both packages' policies on the same
  signals and clock, and the same ``ScaleSignals`` from the same window.
* The monitor's retired guard, on replica processes: after ``scale_to``
  retires a replica, a monitor pass over a fleet snapshot that still
  holds it counts no death and respawns nothing; the same pass with the
  guard lifted counts the death and respawns the slot. The guard holds
  the retired replica itself, so a later newcomer is never taken for it.
* ``retune_replica`` on a replica process: the controller's
  ``serving_*`` flags reach the replica's ServingConfig.
* ``scale_tier`` grows and shrinks one tier, one scale event each.
"""

import dataclasses
import functools
import gc
import json
import urllib.request
import weakref

import numpy as np
import pytest
import torch

import paddle_tpu.core.incidents as j_incidents
import paddle_tpu.distributed.scaler as j_scaler
import paddle_tpu.serving as jserving
from paddle_tpu import checkpoint as jckpt

from paddle_tpu_torch.core import flags as p_flags
from paddle_tpu_torch.core import incidents as p_incidents
from paddle_tpu_torch.core import telemetry as p_telemetry
import paddle_tpu_torch.distributed.scaler as p_scaler
import paddle_tpu_torch.serving as pserving

import tests.test_elastic_resize as ref_elastic

torch.set_num_threads(2)


@pytest.fixture
def port_in_reference(monkeypatch):
    """The reference's scaler and autoscale cases on the port: the names
    they import at call time point at the port's, their module's
    ``telemetry`` is the port's, and the port's flags and telemetry start
    clean, as the reference's own fixture leaves its own."""
    snap = p_flags.snapshot()
    p_flags.apply({k[len("FLAGS_"):]: v
                   for k, v in ref_elastic._FLAG_DEFAULTS.items()
                   if k[len("FLAGS_"):] in snap})
    p_telemetry.reset()
    p_incidents.reset()
    monkeypatch.setattr(ref_elastic, "telemetry", p_telemetry)
    for name in ("ScalerPolicy", "SLOScalerPolicy", "ScaleSignals",
                 "ScaleDecision", "gather_signals", "SCALE_UP",
                 "SCALE_DOWN"):
        monkeypatch.setattr(j_scaler, name, getattr(p_scaler, name))
    for name in ("Rule", "Watchdog"):
        monkeypatch.setattr(j_incidents, name, getattr(p_incidents, name))
    monkeypatch.setattr(jserving, "ClusterController", functools.partial(
        pserving.ClusterController, device="cpu"))
    for name in ("ServingConfig", "ClusterError"):
        monkeypatch.setattr(jserving, name, getattr(pserving, name))
    yield
    p_flags.apply(snap)
    p_incidents.reset()


SCALER_CASES = [
    ("TestScalerPolicy", "test_rule_order_and_directions"),
    ("TestScalerPolicy", "test_no_queue_evidence_means_no_queue_rules"),
    ("TestScalerPolicy", "test_step_p99_rule_when_bound_set"),
    ("TestScalerPolicy", "test_cooldown_suppresses_thrash"),
    ("TestScalerPolicy", "test_clamp_to_bounds_and_to_current"),
    ("TestScalerPolicy", "test_decision_counters_exactly_once"),
    ("TestScalerPolicy", "test_bounds_validated"),
    ("TestScalerPolicy", "test_gather_signals_from_window"),
    ("TestSLOScalerPolicy",
     "test_one_saturation_trip_one_cooldown_gated_scale_up"),
    ("TestSLOScalerPolicy", "test_down_rule_and_injected_firing_set"),
    ("TestSLOScalerPolicy", "test_quiet_gauges_mean_no_decision")]


@pytest.mark.parametrize("cls,case", SCALER_CASES,
                         ids=[c for _, c in SCALER_CASES])
def test_reference_scaler_cases_on_the_port(cls, case, port_in_reference):
    getattr(getattr(ref_elastic, cls)(), case)()


@pytest.mark.parametrize("case", [
    "test_scale_up_and_down_exactly_once_no_dropped_requests",
    "test_scale_to_bounds"])
def test_reference_cluster_autoscale_cases_on_the_port(case, tmp_path,
                                                       port_in_reference):
    getattr(ref_elastic.TestClusterAutoscale(), case)(tmp_path)


# ---------------------------------------------------------------------------
# the same decisions as the reference
# ---------------------------------------------------------------------------

SIGNALS = [
    dict(dead_workers=2), dict(joined_workers=3),
    dict(queue_frac=0.9, queue_evidence=True),
    dict(queue_frac=0.05, queue_evidence=True),
    dict(queue_frac=0.5, queue_evidence=True), dict(queue_frac=0.0),
    dict(step_p99_ms=80.0), dict(dead_workers=1, joined_workers=1,
                                 queue_frac=0.99, queue_evidence=True),
    dict(extra={"slo_firing": ["live_mfu_drop"]}),
    dict(extra={"slo_firing": ["live_mfu_drop", "router_failover_burst"]}),
]
POLICIES = [("plain", dict(min_world=1, max_world=4, cooldown_s=10.0,
                           step_p99_high_ms=50.0)),
            ("slo", dict(min_world=2, max_world=8, cooldown_s=0.0))]


def _decide(scaler, kind, kw, world, sig, now):
    policy = scaler.ScalerPolicy.from_slo_rules(**kw) if kind == "slo" \
        else scaler.ScalerPolicy(**kw)
    d = policy.decide(world, signals=scaler.ScaleSignals(**sig), now=now)
    return None if d is None else dataclasses.asdict(d)


@pytest.mark.parametrize("kind,kw", POLICIES, ids=[k for k, _ in POLICIES])
def test_same_decisions_as_the_reference(kind, kw):
    for world in (1, 2, 4, 8):
        for sig in SIGNALS:
            want = _decide(j_scaler, kind, kw, world, sig, 100.0)
            got = _decide(p_scaler, kind, kw, world, sig, 100.0)
            assert got == want, (world, sig)


def test_same_signals_from_the_same_window():
    windows = [
        {"counters": {"ps.trainer_dead": {"delta": 2},
                      "ps.trainer_revived": {"delta": 1}},
         "gauges": {"fleet.queue_frac": 0.5},
         "hists": {"serving.request_ms": {"count": 4, "p99": 12.5}}},
        {"counters": {}, "gauges": {"serving.queue_depth": 200},
         "hists": {"executor.run_ms": {"count": 0, "p99": 9.0}}},
        {"counters": {"ps.barrier_regrown": {"delta": "x"}}, "gauges": {},
         "hists": {}},
    ]
    for win in windows:
        assert p_scaler.gather_signals(window=win).as_dict() == \
            j_scaler.gather_signals(window=win).as_dict()


# ---------------------------------------------------------------------------
# the cluster controller's scaling, retired guard and retune
# ---------------------------------------------------------------------------

def _published_mlp(tmp_path, seed=61):
    model = ref_elastic._save_mlp(tmp_path / "m1", seed=seed)
    root = str(tmp_path / "models")
    jckpt.publish_model(root, model, version=1)
    return root


def _stats(url):
    with urllib.request.urlopen(url + "/v1/stats", timeout=30) as r:
        return json.loads(r.read())


def _infer(url, rows=2):
    x = np.random.RandomState(1).randn(rows, ref_elastic.IN_DIM)
    code, doc = ref_elastic._post_infer(url, x.astype(np.float32))
    assert code == 200, doc
    return doc


def test_retired_replica_is_not_respawned_and_retune_reaches_a_process(
        tmp_path):
    """Replica processes: scale_to(2), then a retune of the newcomer with
    this process's serving flags (its /v1/stats shows the new buckets),
    then scale_to(1). A monitor pass over a snapshot still holding the
    retired replica counts no death and respawns nothing; with the guard
    lifted the same pass counts the death and respawns the slot."""
    root = _published_mlp(tmp_path)
    cluster = pserving.ClusterController(
        root, replicas=1, device="cpu", auto_swap=False,
        serving_config=pserving.ServingConfig(max_batch_size=4,
                                              batch_timeout_ms=1.0),
        replica_ready_timeout_s=120).start(ready_timeout_s=120)
    try:
        before = p_telemetry.counters()
        assert cluster.scale_to(2, reason="test") == 2
        newcomer = cluster.replicas[-1]
        assert _stats(newcomer.url)["model_version"] == 1
        with p_flags.overrides(serving_buckets="2,4",
                               serving_max_batch_size=4):
            assert cluster.retune_replica(newcomer.name)
        assert _stats(newcomer.url)["serving_config"]["buckets"] == [2, 4]
        assert _infer(cluster.url)["outputs"]
        assert cluster.scale_to(1, reason="test") == 1
        assert not newcomer.alive()
        assert [h.name for h in cluster.router.handles()] == ["replica-0"]

        def delta(name):
            return p_telemetry.counter_get(name) - before.get(name, 0)

        assert delta("router.scale_events") == 2
        assert delta("incidents.scale_events") == 2
        cluster._supervise([newcomer])
        assert delta("router.replica_deaths") == 0
        assert delta("router.replica_restarts") == 0
        # the guard lifted: the same pass takes the retirement for a death
        cluster._retired.discard(newcomer)
        cluster._supervise([newcomer])
        assert delta("router.replica_deaths") == 1
        assert delta("router.replica_restarts") == 1
        deaths = [e for e in p_telemetry.recent_events("incident")
                  if e["name"] == "replica_death"]
        assert deaths[-1]["attrs"]["context"]["replica"] == newcomer.name
        assert len(cluster.replicas) == 1 and _infer(cluster.url)["outputs"]
    finally:
        cluster.close()


def test_retired_guard_holds_the_replica_not_its_address(tmp_path):
    """In-process replicas: scale_to(2), scale_to(1), scale_to(2). The
    guard keeps the retired replica object alive, so the later newcomer
    cannot share its id (a guard of ids, as the reference keeps, can take
    a newcomer at a collected victim's address for retired), and the
    newcomer's death is counted."""
    root = _published_mlp(tmp_path, seed=81)
    cluster = pserving.ClusterController(
        root, replicas=1, inprocess=True, device="cpu", auto_swap=False,
        serving_config=pserving.ServingConfig(max_batch_size=4,
                                              batch_timeout_ms=1.0)
    ).start(ready_timeout_s=120)
    try:
        assert cluster.scale_to(2, reason="test") == 2
        victim = cluster.replicas[-1]
        assert cluster.scale_to(1, reason="test") == 1
        assert victim in cluster._retired
        held = weakref.ref(victim)
        del victim
        gc.collect()
        assert held() is not None
        assert cluster.scale_to(2, reason="test") == 2
        newcomer = cluster.replicas[-1]
        assert newcomer not in cluster._retired
        assert newcomer.name == "replica-2"
        before = p_telemetry.counter_get("router.replica_deaths")
        newcomer.stop()
        cluster._supervise([newcomer])
        assert p_telemetry.counter_get("router.replica_deaths") - before == 1
    finally:
        cluster.close()


def test_scale_tier_grows_and_shrinks_one_tier(tmp_path):
    root = _published_mlp(tmp_path, seed=71)
    cluster = pserving.ClusterController(
        root, replicas=1, inprocess=True, device="cpu", auto_swap=False,
        serving_config=pserving.ServingConfig(max_batch_size=4,
                                              batch_timeout_ms=1.0)
    ).start(ready_timeout_s=120)
    try:
        before = p_telemetry.counter_get("router.scale_events")
        assert cluster.scale_tier("unified", 2) == 2
        assert [r.role for r in cluster.replicas] == ["unified", "unified"]
        names = {_infer(cluster.url)["replica"] for _ in range(8)}
        assert names == {"replica-0", "replica-1"}
        assert cluster.scale_tier("unified", 1) == 1
        assert cluster.scale_tier("unified", 1) == 1   # no transition
        assert p_telemetry.counter_get("router.scale_events") - before == 2
        with pytest.raises(pserving.ClusterError, match="n >= 0"):
            cluster.scale_tier("unified", -1)
        assert _infer(cluster.url)["replica"] == "replica-0"
    finally:
        cluster.close()
