"""The port's run-log sink and metrics server against the reference's
``core/telemetry.py``, on the CPU.

* Record parity: the same calls (counters with keyword attributes, a
  counter set, gauges, histogram and timer samples, events) through both
  packages' telemetry write the same JSONL records, apart from ``ts``.
* The sink: ``FLAGS_telemetry_path`` wins over ``PT_TELEMETRY_LOG``, a
  disabled sink writes nothing, lines buffer until
  ``FLAGS_telemetry_buffer_lines`` (or ``flush_sink``), a failing file is
  counted in ``telemetry.dropped_records``, and ``flush`` ends the log
  with a ``snapshot`` record and the profiler's summary rows.
* ``start_metrics_server``: ``/metrics`` is ``prometheus_text()``,
  ``/healthz`` and ``/varz`` answer, and the server arms the watchdog
  under 'auto' while it runs.
* ``core/monitor.py``'s StatRegistry is a shim over the counters.
* The reference's own sink cases (``tests/test_telemetry.py``: the env
  var, the flag over the env var, a disabled sink, the timer and
  histogram summary) run on the port by import.
"""

import inspect
import json
import urllib.error
import urllib.request

import pytest

from paddle_tpu.core import flags as ref_flags
from paddle_tpu.core import telemetry as ref_tm
from paddle_tpu_torch import profiler as pt_prof
from paddle_tpu_torch.core import flags as pt_flags
from paddle_tpu_torch.core import incidents as pt_incidents
from paddle_tpu_torch.core import monitor as pt_monitor
from paddle_tpu_torch.core import telemetry as pt_tm

import tests.test_telemetry as ref_cases


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("PT_TELEMETRY_LOG", raising=False)
    for tm in (ref_tm, pt_tm):
        tm.configure(None)
        tm.reset()
    yield
    for tm in (ref_tm, pt_tm):
        tm.configure(None)
        tm.reset()
    pt_flags.set_flags({"telemetry_buffer_lines": 64})


def _read(tm, path):
    tm.flush_sink()
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _calls(tm):
    """One script of telemetry calls, run the same way on either
    package."""
    tm.counter_add("executor.cache_hits", 1)
    tm.counter_add("decode.kv_pages_allocated", 3, pages=3, slot=2)
    tm.counter_add("decode.kv_pages_allocated", 2)
    tm.counter_set("goodput.wall_ms", 12.5, source="probe")
    tm.gauge_set("mem.serving.kv_used_bytes", 4096, layer="all")
    tm.observe("decode.batch_occupancy", 0.123456789)
    tm.observe("executor.run_ms", 3.25, kind="timer", program=7)
    tm.event("compile", "executor", 12.5, {"cause": "first_compile"})
    tm.event("fault", "decode.step", 1, {"exc": "RuntimeError"})
    tm.counter_quiet("trace.spans", 4)


def _strip_ts(recs):
    return [{k: v for k, v in r.items() if k != "ts"} for r in recs]


def test_same_calls_write_the_same_records(tmp_path):
    logs = {}
    for name, tm in (("ref", ref_tm), ("port", pt_tm)):
        logs[name] = tmp_path / f"{name}.jsonl"
        tm.configure(str(logs[name]))
        _calls(tm)
        tm.configure(None)
    ref = _strip_ts(_read(ref_tm, logs["ref"]))
    port = _strip_ts(_read(pt_tm, logs["port"]))
    assert port == ref
    assert {r["kind"] for r in port} == {"counter", "gauge", "hist",
                                          "timer", "compile", "fault"}
    assert port[1]["attrs"] == {"delta": 3, "pages": 3, "slot": 2}
    assert port[3]["attrs"] == {"set": True, "source": "probe"}
    # the in-memory aggregates agree too
    assert pt_tm.counters() == ref_tm.counters()
    assert pt_tm.gauges() == ref_tm.gauges()


def test_flush_ends_the_log_with_a_snapshot_and_profiler_rows(tmp_path):
    log = tmp_path / "run.jsonl"
    pt_tm.configure(str(log))
    pt_tm.counter_add("flush_probe", 3)
    for v in (1.0, 2.0, 3.0):
        pt_tm.observe("h_probe", v)
    pt_prof.start_profiler()
    with pt_prof.RecordEvent("flush_span"):
        pass
    pt_tm.flush()
    pt_prof.stop_profiler()
    recs = _read(pt_tm, log)
    snap = [r for r in recs if r["kind"] == "snapshot"][-1]
    assert snap["name"] == "telemetry"
    assert snap["attrs"]["counters"]["flush_probe"] == 3
    assert snap["attrs"]["hists"]["h_probe"]["p50"] == 2.0
    rows = [r for r in recs if r["kind"] == "profiler_summary"]
    assert [r["name"] for r in rows] == ["flush_span"]
    assert rows[0]["attrs"]["calls"] == 1


def test_flag_wins_over_env_and_both_off_write_nothing(tmp_path,
                                                       monkeypatch):
    env_log, flag_log = tmp_path / "env.jsonl", tmp_path / "flag.jsonl"
    monkeypatch.setenv("PT_TELEMETRY_LOG", str(env_log))
    assert pt_tm.enabled()
    pt_tm.counter_add("env_probe", 1)
    assert _read(pt_tm, env_log)[-1]["name"] == "env_probe"
    pt_tm.configure(str(flag_log))
    pt_tm.counter_add("flag_probe", 1)
    assert [r["name"] for r in _read(pt_tm, flag_log)] == ["flag_probe"]
    assert [r["name"] for r in _read(pt_tm, env_log)] == ["env_probe"]
    monkeypatch.delenv("PT_TELEMETRY_LOG")
    pt_tm.configure(None)
    assert not pt_tm.enabled()
    pt_tm.counter_add("mem_only", 2)
    assert pt_tm.counter_get("mem_only") == 2
    assert [r["name"] for r in _read(pt_tm, flag_log)] == ["flag_probe"]


def test_lines_buffer_until_the_bound_or_a_flush(tmp_path):
    log = tmp_path / "run.jsonl"
    pt_flags.set_flags({"telemetry_buffer_lines": 5,
                        "telemetry_flush_s": 60.0})
    try:
        pt_tm.configure(str(log))
        for i in range(4):
            pt_tm.counter_add("buf_probe", 1, i=i)
        assert log.read_text() == ""            # 4 < 5 pending
        pt_tm.counter_add("buf_probe", 1, i=4)  # the 5th writes the batch
        assert len(log.read_text().splitlines()) == 5
        pt_tm.counter_add("buf_probe", 1, i=5)
        assert len(log.read_text().splitlines()) == 5
        pt_tm.flush_sink()
        lines = log.read_text().splitlines()
        assert [json.loads(ln)["attrs"]["i"] for ln in lines] == \
            list(range(6))
    finally:
        pt_flags.set_flags({"telemetry_flush_s": 0.25})


def test_a_failing_sink_counts_its_drops_and_never_raises(tmp_path):
    log = tmp_path / "run.jsonl"
    pt_flags.set_flags({"telemetry_buffer_lines": 1})
    pt_tm.configure(str(log))
    pt_tm._REG._file.close()            # every later write fails
    pt_tm.counter_add("lost", 1)
    pt_tm.gauge_set("lost_gauge", 1)
    assert pt_tm.counter_get("telemetry.dropped_records") == 2
    # a record that cannot be serialised is counted as well
    pt_tm.configure(str(tmp_path / "second.jsonl"))

    class Unprintable:
        def __str__(self):
            raise TypeError("no text")

    pt_tm.event("probe", "bad", None, {"x": Unprintable()})
    assert pt_tm.counter_get("telemetry.dropped_records") == 3


def test_metrics_server_serves_the_live_registry():
    pt_tm.counter_add("serving.requests", 3)
    pt_tm.gauge_set("serving.queue_depth", 2)
    pt_tm.observe("serving.request_ms", 4.5, kind="timer")
    pt_incidents.reset()
    assert not pt_incidents.armed()
    srv = pt_tm.start_metrics_server(0)
    try:
        assert pt_tm.metrics_server_active() and pt_incidents.armed()
        body = urllib.request.urlopen(srv.url + "/metrics",
                                      timeout=10).read().decode()
        assert body == pt_tm.prometheus_text()
        assert "pt_serving_requests_total 3" in body
        health = json.loads(urllib.request.urlopen(
            srv.url + "/healthz", timeout=10).read())
        assert health == {"status": "ok"}
        varz = json.loads(urllib.request.urlopen(
            srv.url + "/varz", timeout=10).read())
        assert varz["snapshot"]["counters"]["serving.requests"] == 3
        assert "serving.request_ms" in varz["window"]["hists"]
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(srv.url + "/nope", timeout=10)
    finally:
        srv.shutdown()
    assert not pt_tm.metrics_server_active()
    assert not pt_incidents.armed()


def test_the_same_registry_renders_the_same_prometheus_text():
    for tm in (ref_tm, pt_tm):
        tm.counter_add("router.requests", 7)
        tm.gauge_set("decode.active_slots", 3)
        for v in (0.5, 2.0, 40.0):
            tm.observe("decode.step_ms", v, kind="timer")
    assert pt_tm.prometheus_text() == ref_tm.prometheus_text()


def test_stat_registry_is_a_shim_over_the_counters():
    pt_monitor.stat_add("alias_probe", 3)
    pt_monitor.stat_add("alias_probe", 4)
    assert pt_monitor.stat_get("alias_probe") == 7
    assert pt_tm.counter_get("alias_probe") == 7
    reg = pt_monitor.StatRegistry.instance()
    assert reg.stats()["alias_probe"] == 7
    reg.set("set_probe", 42)
    assert reg.get("set_probe") == 42


REF_CASES = [("TestSink", "test_env_var_enables_sink"),
             ("TestSink", "test_flag_wins_over_env"),
             ("TestSink", "test_disabled_writes_nothing_but_counts"),
             ("TestSink", "test_timer_and_histogram_summary")]


@pytest.mark.parametrize("cls,name", REF_CASES,
                         ids=[f"{c}.{n}" for c, n in REF_CASES])
def test_reference_sink_cases_on_the_port(cls, name, tmp_path, monkeypatch):
    monkeypatch.setattr(ref_cases, "telemetry", pt_tm)
    method = getattr(getattr(ref_cases, cls)(), name)
    args = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    method(**{k: v for k, v in args.items()
              if k in inspect.signature(method).parameters})


def test_flags_match_the_reference():
    names = ("telemetry_path", "telemetry_buffer_lines",
             "telemetry_flush_s", "cost_capture", "device_peak_flops",
             "device_peak_bw", "goodput_publish_s", "profiler_max_events",
             "blackbox_max_records", "blackbox_seconds", "verify_program")
    for n in names:
        assert pt_flags._REGISTRY[n].default == \
            ref_flags._REGISTRY[n].default, n
        assert pt_flags._REGISTRY[n].doc, n
