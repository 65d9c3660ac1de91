"""The autotuner, the flag surface it searches and the router's trial
split, on the CPU.

* The reference's own cases (``tests/test_autotune.py`` ``TestFlagsAPI``,
  ``TestBucketValidation``, ``TestSearchSpace``, ``TestOfflineReplay``,
  ``TestProfiles``, ``TestOnlineTrial``, ``TestRouterTrialSteering``),
  imported and run as they are with the names they import pointed at the
  port's (flags, tuner, incidents, telemetry, the engine and decode
  configs, the router, an in-process cluster of two replicas on the CPU
  serving the reference's published MLP).
* The one stated divergence: ``TestProfiles`` applies a profile with
  ``exec_steps_per_dispatch=2``, a flag nothing in the port reads, so
  ``test_roundtrip_and_apply`` runs here as a copy that asserts the typed
  refusal and makes the same round trip on a serving knob
  (``serving_buckets``); its provenance case runs the same way against
  the port's ``profile_provenance``. The reference's
  ``finalize_bench_result`` / ``tools/slo_check.py`` provenance cases
  exercise the bench and SLO-history tools of ROADMAP A10 and are not
  run. A profile or trial candidate that moves ``exec_steps_per_dispatch``
  or ``pallas_kv_chunk_tokens``, or asks for ``zero_stage > 0``, raises
  ``ProfileError`` before any flag changes.
* Against the reference on the same inputs: the search space's JSON, the
  constraint verdicts, the offline ranking (labels, scores, bases) and the
  ``profile_hash`` of the same run logs, equal.
* ``python -m paddle_tpu_torch.tools.autotune``: offline emits the
  reference's profile, a junk log exits 2, ``space`` dumps the knobs,
  ``online`` reaches a verdict on a CPU cluster with no residual flag
  override and refuses a candidate that moves an unread flag.
"""

import inspect
import json
import os
import subprocess
import sys

import pytest
import torch

import paddle_tpu.core.flags as j_flags_mod
import paddle_tpu.core.tuner as j_tuner
import paddle_tpu.serving.decode as j_decode
import paddle_tpu.serving.engine as j_engine
import paddle_tpu.serving.router as j_router

from paddle_tpu_torch.core import flags as p_flags
from paddle_tpu_torch.core import incidents as p_incidents
from paddle_tpu_torch.core import telemetry as p_telemetry
from paddle_tpu_torch.core import tuner as p_tuner
import paddle_tpu_torch.serving as pserving
from paddle_tpu_torch.serving import decode as p_decode
from paddle_tpu_torch.serving import router as p_router

import tests.test_autotune as ref_tune

torch.set_num_threads(2)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def port_in_reference(monkeypatch):
    """The reference's autotune cases on the port, with the reference's
    own per-case reset (flag snapshot, active profile, incidents) done on
    the port's modules."""
    for name, mod in (("_flags", p_flags), ("tuner", p_tuner),
                      ("incidents", p_incidents),
                      ("telemetry", p_telemetry)):
        monkeypatch.setattr(ref_tune, name, mod)
    for name in ("BucketConfigError", "ConfigError", "UnknownFlagError"):
        monkeypatch.setattr(ref_tune, name, getattr(p_flags, name))
    monkeypatch.setattr(j_engine, "ServingConfig", pserving.ServingConfig)
    monkeypatch.setattr(j_decode, "DecodeConfig", p_decode.DecodeConfig)
    for name in ("ReplicaHandle", "Router"):
        monkeypatch.setattr(j_router, name, getattr(p_router, name))
    snap = p_flags.snapshot()
    p_tuner.clear_active_profile()
    p_incidents.reset()
    yield
    p_flags.apply(snap)
    p_tuner.clear_active_profile()
    p_incidents.reset()


@pytest.fixture
def port_cluster(tmp_path, port_in_reference):
    """The reference's ``mlp_cluster`` on the port: its published MLP
    behind two in-process replicas on the CPU."""
    root = ref_tune._publish_mlp(tmp_path)
    cluster = pserving.ClusterController(root, replicas=2, inprocess=True,
                                         device="cpu").start()
    try:
        yield cluster
    finally:
        cluster.close()


FLAG_CASES = [("TestFlagsAPI", "test_snapshot_apply_roundtrip"),
              ("TestFlagsAPI", "test_unknown_flag_is_typed_and_atomic"),
              ("TestFlagsAPI", "test_uncoercible_value_is_typed"),
              ("TestFlagsAPI",
               "test_overrides_context_restores_on_exception"),
              ("TestFlagsAPI", "test_set_flags_stays_compatible"),
              ("TestBucketValidation", "test_parse_good"),
              ("TestBucketValidation", "test_cover"),
              ("TestBucketValidation",
               "test_serving_config_rejects_bad_flag"),
              ("TestBucketValidation",
               "test_decode_config_rejects_bad_flag"),
              ("TestSearchSpace", "test_enumerate_default_first_and_counted"),
              ("TestSearchSpace", "test_bucket_constraints"),
              ("TestSearchSpace", "test_hbm_headroom_gates_batch"),
              ("TestSearchSpace", "test_sharding_needs_mesh_evidence"),
              ("TestProfiles", "test_load_rejects_junk"),
              ("TestRouterTrialSteering", "test_split_and_exclusion"),
              ("TestRouterTrialSteering", "test_dispatch_latency_ring")]


@pytest.mark.parametrize("cls,case", FLAG_CASES,
                         ids=[c for _, c in FLAG_CASES])
def test_reference_tuner_cases_on_the_port(cls, case, tmp_path,
                                           port_in_reference):
    fn = getattr(getattr(ref_tune, cls)(), case)
    if "tmp_path" in inspect.signature(fn).parameters:
        fn(tmp_path)
    else:
        fn()


@pytest.mark.parametrize("bad", ["0,4", "4,2", "4,4", "-1,2", "2,x"])
def test_reference_bad_buckets_on_the_port(bad, port_in_reference):
    ref_tune.TestBucketValidation().test_parse_bad_is_typed(bad)


REPLAY_CASES = ["test_known_best_amortization",
                "test_measured_beats_bad_incumbent",
                "test_single_k_cannot_invent_a_win",
                "test_raw_jsonl_timer_observations",
                "test_empty_log_is_typed_error",
                "test_roofline_and_bench_wrapper_ingest"]


@pytest.mark.parametrize("case", REPLAY_CASES)
def test_reference_offline_replay_on_the_port(case, tmp_path,
                                              port_in_reference):
    getattr(ref_tune.TestOfflineReplay(), case)(tmp_path)


TRIAL_CASES = ["test_candidate_lands_on_one_replica_then_promotes",
               "test_latency_regression_rolls_back_clean",
               "test_slo_trip_aborts_within_one_tick",
               "test_undecided_trial_keeps_incumbent"]


@pytest.mark.parametrize("case", TRIAL_CASES)
def test_reference_online_trial_on_the_port(case, port_cluster):
    getattr(ref_tune.TestOnlineTrial(), case)(port_cluster)


# ---------------------------------------------------------------------------
# TestProfiles' stated divergence
# ---------------------------------------------------------------------------

def _serving_profile():
    cand = p_tuner.Candidate(flags={"serving_buckets": "2,8"}, changes=1,
                             label="buckets")
    return p_tuner.make_profile(cand, objective="step_ms", replayed=5.0,
                                default_objective=10.0,
                                origin={"run_id": "r42"}, workload="mlp")


def test_profiles_roundtrip_refuses_an_unread_flag(tmp_path,
                                                   port_in_reference):
    """The reference's ``test_roundtrip_and_apply`` profile (k = 2) is
    refused with ProfileError and changes nothing; the same round trip on
    ``serving_buckets`` applies, counts and reports its provenance."""
    ref_doc = ref_tune.TestProfiles()._profile()
    path = str(tmp_path / "k2.json")
    p_tuner.save_profile(ref_doc, path)
    loaded = p_tuner.load_profile(path)
    assert loaded["profile_hash"] == ref_doc["profile_hash"]
    snap = p_flags.snapshot()
    with pytest.raises(p_tuner.ProfileError, match="no reader"):
        p_tuner.apply_profile(loaded, origin_path=path)
    assert p_flags.snapshot() == snap
    assert p_tuner.active_profile() is None
    assert p_tuner.profile_provenance() == "hand-picked"

    doc = _serving_profile()
    path = str(tmp_path / "buckets.json")
    p_tuner.save_profile(doc, path)
    loaded = p_tuner.load_profile(path)
    assert loaded["profile_hash"] == doc["profile_hash"]
    before = p_telemetry.counter_get("tuner.profiles_loaded")
    prior = p_tuner.apply_profile(loaded, origin_path=path)
    assert p_flags.flag("serving_buckets") == "2,8"
    assert pserving.ServingConfig().buckets == [2, 8]
    assert p_telemetry.counter_get("tuner.profiles_loaded") - before == 1
    assert p_tuner.profile_provenance() == {
        "profile_hash": doc["profile_hash"], "origin": "r42"}
    assert [e["name"] for e in p_telemetry.recent_events("tuner")][-1] == \
        "profile_applied"
    p_flags.apply(prior)
    assert p_flags.snapshot() == snap


@pytest.mark.parametrize("flags,zero_stage", [
    ({"exec_steps_per_dispatch": 2}, None),
    ({"FLAGS_pallas_kv_chunk_tokens": 256}, None),
    ({"serving_buckets": "4,8", "pallas_kv_chunk_tokens": "x"}, None),
    ({"serving_buckets": "4,8"}, 1)])
def test_profiles_the_port_cannot_honour_are_refused(flags, zero_stage,
                                                     port_in_reference):
    doc = p_tuner.make_profile(
        p_tuner.Candidate(flags=flags, zero_stage=zero_stage),
        objective="step_ms", replayed=None, default_objective=None)
    snap = p_flags.snapshot()
    with pytest.raises(p_tuner.ProfileError):
        p_tuner.apply_profile(doc)
    assert p_flags.snapshot() == snap


def test_profile_at_the_defaults_of_unread_flags_applies(port_in_reference):
    doc = p_tuner.make_profile(
        p_tuner.Candidate(flags={"exec_steps_per_dispatch": 1,
                                 "pallas_kv_chunk_tokens": 1024,
                                 "serving_batch_timeout_ms": 2.0},
                          zero_stage=0),
        objective="step_ms", replayed=None, default_objective=None)
    p_tuner.apply_profile(doc)
    assert p_flags.flag("serving_batch_timeout_ms") == 2.0


def test_trial_of_an_unread_flag_is_refused_before_anything_moves(
        port_cluster):
    snap = p_flags.snapshot()
    trials = p_telemetry.counter_get("tuner.trials")
    trial = p_tuner.OnlineTrial(port_cluster, {"exec_steps_per_dispatch": 4})
    with pytest.raises(p_tuner.ProfileError, match="no reader"):
        trial.start()
    assert p_flags.snapshot() == snap
    assert p_telemetry.counter_get("tuner.trials") == trials
    assert port_cluster.router.trial() is None


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def test_search_space_equals_the_reference():
    assert [k.as_dict() for k in p_tuner.default_space()] == \
        [k.as_dict() for k in j_tuner.default_space()]
    assert p_flags.snapshot()["exec_steps_per_dispatch"] == \
        j_flags_mod.snapshot()["exec_steps_per_dispatch"]
    assert p_flags.snapshot()["pallas_kv_chunk_tokens"] == \
        j_flags_mod.snapshot()["pallas_kv_chunk_tokens"]
    for name in [n for n in p_flags.snapshot() if n.startswith(
            ("scaler_", "tuner_", "slo_", "incident_"))]:
        assert p_flags.snapshot()[name] == j_flags_mod.snapshot()[name], name
    cands = [({"serving_buckets": "8,4"}, 1.0, None),
             ({"serving_buckets": "2,4", "serving_max_batch_size": 16},
              1.0, None),
             ({"decode_buckets": "2,4", "decode_max_slots": 8}, 1.0, None),
             ({"exec_steps_per_dispatch": 0}, 1.0, None),
             ({"pallas_kv_chunk_tokens": 0}, 1.0, None),
             ({}, 2.0, None), ({}, 1.0, 2), ({}, -1.0, None)]
    for flags, mult, zero in cands:
        got = p_tuner.SearchSpace().check(p_tuner.Candidate(
            flags=flags, batch_multiplier=mult, zero_stage=zero))
        want = j_tuner.SearchSpace().check(j_tuner.Candidate(
            flags=flags, batch_multiplier=mult, zero_stage=zero))
        assert got == want, (flags, mult, zero)


LOGS = {
    "amortised": [ref_tune._metric_record(10.0, 1),
                  ref_tune._metric_record(7.0, 4)],
    "fused_loses": [ref_tune._metric_record(57.0, 1),
                    ref_tune._metric_record(379.0, 4)],
    "single_k": [ref_tune._metric_record(10.0, 1)],
    "mixed": [ref_tune._metric_record(12.0, 1),
              {"parsed": ref_tune._bench_row(8.0, 2)},
              ref_tune._metric_record(6.5, 8),
              {"ts": 1.0, "kind": "gauge", "name": "mem.hbm_total_bytes",
               "value": 10e9},
              {"ts": 1.0, "kind": "cost", "name": "costmodel.jit",
               "value": 1e9, "attrs": {"roofline": "compute_bound"}}],
}


def _ranking(tuner, obs_path):
    res = tuner.offline_search(tuner.RunLogObservations.load(obs_path))
    best = res.best or tuner.Candidate()
    top = res.ranked[0]
    doc = tuner.make_profile(best, objective=res.objective,
                             replayed=top["score"],
                             default_objective=res.default_score,
                             origin={"run_id": "x"}, workload="w")
    return ([(r["candidate"].label, r["score"], r.get("basis"),
              r.get("reason")) for r in res.ranked],
            res.default_score, res.improved(), doc)


@pytest.mark.parametrize("log", sorted(LOGS))
def test_offline_ranking_and_profile_hash_equal_the_reference(log,
                                                              tmp_path):
    path = ref_tune._write_log(tmp_path, LOGS[log])
    got, want = _ranking(p_tuner, path), _ranking(j_tuner, path)
    assert got[:3] == want[:3]
    pdoc, jdoc = got[3], want[3]
    assert pdoc["profile_hash"] == jdoc["profile_hash"]
    for key in ("format", "flags", "batch_multiplier", "axis_rules",
                "zero_stage", "objective", "workload", "origin"):
        assert pdoc[key] == jdoc[key], key
    assert pdoc["fingerprints"]["axis_rules"] == \
        jdoc["fingerprints"]["axis_rules"]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.autotune", *args],
        capture_output=True, text=True, timeout=120, cwd=REPO_ROOT,
        env=dict(os.environ, PYTHONPATH=REPO_ROOT))


def test_autotune_cli_offline_space_and_junk(tmp_path):
    log = ref_tune._write_log(tmp_path, LOGS["amortised"])
    out = str(tmp_path / "profile.json")
    proc = _cli("offline", "--log", log, "--out", out,
                "--require-improvement", "--json")
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["improved"] is True
    assert doc["profile"]["flags"] == {"exec_steps_per_dispatch": 8}
    saved = p_tuner.load_profile(out)
    assert saved["profile_hash"] == doc["profile"]["profile_hash"] == \
        _ranking(j_tuner, log)[3]["profile_hash"]
    junk = str(tmp_path / "empty.jsonl")
    open(junk, "w").close()
    proc = _cli("offline", "--log", junk)
    assert proc.returncode == 2 and "no step-time" in proc.stderr
    proc = _cli("space", "--json")
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == [k.as_dict()
                                       for k in j_tuner.default_space()]


def test_autotune_cli_online_trial_on_the_cpu(tmp_path):
    """``online`` over the reference's published MLP: an in-process
    cluster on the CPU under synthetic load reaches a verdict with no
    residual flag override."""
    root = ref_tune._publish_mlp(tmp_path)
    proc = _cli("online", "--model-root", root, "--device", "cpu",
                "--set", "serving_batch_timeout_ms=1.0", "--eval-interval",
                "0.2", "--min-requests", "4", "--json")
    assert proc.returncode == 0, proc.stderr[-2000:]
    doc = json.loads(proc.stdout)
    assert doc["status"] in ("promoted", "rolled_back")
    assert doc["residual_overrides"] == {}
    assert doc["fleet_on_incumbent_version"] is True
    proc = _cli("online", "--model-root", root, "--device", "cpu",
                "--set", "exec_steps_per_dispatch=2")
    assert proc.returncode == 2 and "no reader" in proc.stderr
