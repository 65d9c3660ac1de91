"""The port's flight recorder and incident pipeline
(``core/incidents.py``) against the reference's, on the CPU.

* The reference's own cases (``tests/test_incidents.py``) run on the
  port by import, with the names they use pointed at the port's
  telemetry, trace, costmodel and incidents: the flight recorder (always
  on without a sink, bounded keeping the newest, 0 disables it, pruned by
  time and capped), the rule semantics (latching, cooldown, a learned
  baseline, a gauge below its baseline, a queue threshold, a declarative
  spec, a clean executor run that trips nothing, the executor's tick),
  the incident record (its schema with the ring, the ledger, the trace
  ids and the counters; the global rate limit; an OOM's legacy record;
  the health and Prometheus surfaces) and the tools that render it
  (``incident_report.py`` as a library and a CLI, ``trace_view.py``'s
  incident markers, ``perf_report.py``'s incidents section).
* An incident's goodput attachment; a port incident rendered by
  ``tools/incident_report.py`` with rc 0; the serving HTTP server arms
  the watchdog while it runs and shows its ``health`` in ``/v1/stats``.
"""

import inspect
import json
import os
import subprocess
import sys
import types
import urllib.request

import numpy as np
import pytest

import paddle_tpu_torch as ptt
from paddle_tpu_torch import layers as pt_layers
from paddle_tpu_torch import optimizer as pt_opt
from paddle_tpu_torch.core import costmodel, goodput, incidents, telemetry
from paddle_tpu_torch.core import trace
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.flags import flag as pt_flag
from paddle_tpu_torch.core.flags import set_flags

import tests.test_incidents as ref_cases

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FLAGS = {"blackbox_max_records": 2048, "blackbox_seconds": 120.0,
          "slo_watchdog": "auto", "slo_rules": "",
          "incident_rate_limit_s": 30.0, "slo_eval_s": 5.0,
          "trace_sample_rate": 0.0}


@pytest.fixture(autouse=True)
def _fresh_plane(monkeypatch):
    def fresh():
        telemetry.configure(None)
        telemetry.reset()
        costmodel.reset()
        incidents.reset()
        goodput.reset()
        set_flags(_FLAGS)

    fresh()
    port = types.SimpleNamespace(
        Program=ptt.Program, program_guard=ptt.program_guard,
        optimizer=pt_opt, Scope=ptt.Scope,
        Executor=lambda *a, **kw: Executor(device="cpu"))
    for name, value in (("pt", port), ("layers", pt_layers),
                        ("costmodel", costmodel), ("incidents", incidents),
                        ("telemetry", telemetry), ("trace", trace),
                        ("set_flags", set_flags), ("_flag", pt_flag)):
        monkeypatch.setattr(ref_cases, name, value)
    yield
    fresh()


REF_CASES = [
    ("TestFlightRecorder", "test_always_on_without_sink"),
    ("TestFlightRecorder", "test_ring_bounded_keeps_newest"),
    ("TestFlightRecorder", "test_zero_disables"),
    ("TestFlightRecorder", "test_snapshot_prunes_by_time_and_caps"),
    ("TestRuleSemantics", "test_counter_rule_trips_once_latched"),
    ("TestRuleSemantics", "test_cooldown_gates_retrigger"),
    ("TestRuleSemantics", "test_hist_baseline_learning_and_regression"),
    ("TestRuleSemantics", "test_gauge_below_rule_mfu_drop"),
    ("TestRuleSemantics", "test_threshold_gauge_queue_saturation"),
    ("TestRuleSemantics", "test_declarative_spec_overrides"),
    ("TestRuleSemantics", "test_clean_executor_run_trips_zero_rules"),
    ("TestRuleSemantics", "test_executor_tick_drives_evaluation"),
    ("TestIncidentPipeline", "test_incident_record_schema"),
    ("TestIncidentPipeline", "test_global_rate_limit"),
    ("TestIncidentPipeline", "test_oom_flows_through_pipeline_legacy_intact"),
    ("TestIncidentPipeline", "test_health_and_prometheus_surfaces"),
    ("TestCLIs", "test_incident_report_renders_postmortem"),
    ("TestCLIs", "test_incident_report_cli_smoke"),
    ("TestCLIs", "test_trace_view_incident_markers"),
    ("TestCLIs", "test_perf_report_incidents_section"),
]


@pytest.mark.parametrize("cls,name", REF_CASES,
                         ids=[f"{c}.{n}" for c, n in REF_CASES])
def test_reference_cases_on_the_port(cls, name, tmp_path):
    method = getattr(getattr(ref_cases, cls)(), name)
    args = {"tmp_path": tmp_path, "scope": ptt.Scope()}
    method(**{k: v for k, v in args.items()
              if k in inspect.signature(method).parameters})


def _read(path):
    telemetry.flush_sink()
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_a_port_incident_carries_goodput_and_renders(tmp_path):
    set_flags({"trace_sample_rate": 1.0})
    log = tmp_path / "run.jsonl"
    telemetry.configure(str(log))
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = pt_layers.data("x", [4], stop_gradient=True)
        loss = pt_layers.mean(pt_layers.fc(x, 8))
    exe, scope = Executor(device="cpu"), ptt.Scope()
    exe.run(startup, scope=scope, use_compiled=False)
    goodput.start_run()
    for _ in range(3):
        exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                fetch_list=[loss], scope=scope)
    telemetry.gauge_set("decode.queue_depth", 3)
    rules = incidents.rules_from_spec(json.dumps([{
        "name": "decode_queue", "metric": "decode.queue_depth",
        "kind": "gauge", "threshold": 0.5, "cooldown_s": 600}]))
    assert incidents.Watchdog(rules).evaluate() == ["decode_queue"]
    (inc,) = [r for r in _read(log) if r["kind"] == "incident"]
    a = inc["attrs"]
    assert sorted(a["goodput"]) == ["badput_ms", "phases", "productive_ms",
                                    "ratio", "wall_ms", "window"]
    assert a["ring"] and a["traces"]
    assert any(r["kind"] == "span" and r["attrs"]["trace"] in a["traces"]
               for r in a["ring"])
    telemetry.flush()
    r = subprocess.run([sys.executable, os.path.join(REPO_ROOT, "tools",
                                                     "incident_report.py"),
                        str(log)], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert "slo.decode_queue" in r.stdout


def test_serving_server_arms_the_watchdog_and_reports_health(tmp_path):
    from paddle_tpu_torch import io as pt_io
    from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving.server import ServingHTTPServer

    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        y = pt_layers.fc(pt_layers.data("x", [4], stop_gradient=True), 2)
    scope = ptt.Scope()
    Executor(device="cpu").run(startup, scope=scope, use_compiled=False)
    pt_io.save_inference_model(str(tmp_path / "m"), ["x"], [y],
                               main_program=main, scope=scope)
    engine = ServingEngine(create_predictor(AnalysisConfig(
        str(tmp_path / "m"), device="cpu"))).start(warmup=False)
    srv = ServingHTTPServer(engine).start()
    try:
        assert incidents.armed()
        doc = json.loads(urllib.request.urlopen(srv.url + "/v1/stats",
                                                timeout=10).read())
        assert doc["health"]["watchdog_armed"] is True
        assert "incidents_reported" in doc["health"]
        assert "blackbox_records" in doc["health"]
    finally:
        srv.shutdown()
        engine.close()
    assert not incidents.armed()
