"""The executor's spans, counters, timers and compile events, the goodput
ledger and the profiler, held against the reference's on the CPU.

* One MLP program (fc + relu + mean + SGD) run op by op through both
  packages' executors with tracing on writes the same span names and the
  same counter names; run compiled, the port writes one compile event,
  and a changed fetch list gives the recompile cause ``fetch_names`` in
  both packages (the port's capture comes at a key's second run).
* ``tools/perf_report.py --json`` over a port log and over the
  reference's log of the same program has the same section keys, and
  reads one compile and cache hits = compiled runs - 1 from the port's.
* ``FLAGS_verify_program`` runs the verifier once a (program, op count)
  and raises a typed error on a corrupt program.
* The goodput breakdown has the reference's keys, and its phases add up
  to its wall; the executor's device / host split adds up to each run's
  wall.
* The profiler's summary names and call counts equal the reference's
  for the same op-by-op run, its chrome trace is valid JSON, and the
  span ring is bounded with its drops counted.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu import layers as ref_layers
from paddle_tpu import profiler as ref_prof
from paddle_tpu.core import costmodel as ref_costmodel
from paddle_tpu.core import flags as ref_flags
from paddle_tpu.core import goodput as ref_goodput
from paddle_tpu.core import telemetry as ref_tm
import paddle_tpu_torch as ptt
from paddle_tpu_torch import layers as pt_layers
from paddle_tpu_torch import optimizer as pt_opt
from paddle_tpu_torch import profiler as pt_prof
from paddle_tpu_torch.core import costmodel as pt_costmodel
from paddle_tpu_torch.core import flags as pt_flags
from paddle_tpu_torch.core import goodput as pt_goodput
from paddle_tpu_torch.core import telemetry as pt_tm
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.verify import ProgramVerifyError

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
X = np.random.RandomState(0).randn(4, 16).astype(np.float32)


def _isolate():
    """Both packages' telemetry, flags and cost ledgers as a fresh process
    has them. ``costmodel.reset`` also clears the live-MFU gauge's
    once-a-second throttle (``_last_mfu_set``), which is process-wide:
    without it, a test that dispatched a captured program less than a
    second before (an earlier test of this file or of another file on the
    same worker) keeps ``cost.live_mfu`` out of the next log, and the two
    packages' memcost sections differ by that key."""
    for tm, fl, cm in ((ref_tm, ref_flags, ref_costmodel),
                       (pt_tm, pt_flags, pt_costmodel)):
        tm.configure(None)
        tm.reset()
        cm.reset()
        fl.set_flags({"trace_sample_rate": 1.0})


@pytest.fixture(autouse=True)
def _fresh():
    _isolate()
    yield
    for tm, fl in ((ref_tm, ref_flags), (pt_tm, pt_flags)):
        tm.configure(None)
        tm.reset()
        fl.set_flags({"trace_sample_rate": 0.0, "verify_program": False})
    pt_goodput.reset()
    ref_goodput.reset()


def _ref_mlp():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = ref_layers.data("x", [16], stop_gradient=True)
        loss = ref_layers.mean(ref_layers.fc(x, 8, act="relu"))
        pt.optimizer.SGDOptimizer(0.1).minimize(loss)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope, use_compiled=False)
    return exe, scope, main, loss


def _port_mlp():
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = pt_layers.data("x", [16], stop_gradient=True)
        loss = pt_layers.mean(pt_layers.fc(x, 8, act="relu"))
        pt_opt.SGDOptimizer(0.1).minimize(loss)
    exe, scope = Executor(device="cpu"), ptt.Scope()
    exe.run(startup, scope=scope, use_compiled=False)
    return exe, scope, main, loss


def _read(tm, path):
    tm.flush_sink()
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _names(recs, kind):
    return {r["name"] for r in recs if r["kind"] == kind}


def test_op_by_op_runs_write_the_same_spans_and_counters(tmp_path):
    logs = {}
    for name, tm, build in (("ref", ref_tm, _ref_mlp),
                            ("port", pt_tm, _port_mlp)):
        exe, scope, main, loss = build()
        logs[name] = tmp_path / f"{name}.jsonl"
        tm.configure(str(logs[name]))
        for _ in range(3):
            exe.run(main, feed={"x": X}, fetch_list=[loss], scope=scope,
                    use_compiled=False)
        tm.configure(None)
    ref, port = (_read(tm, logs[n]) for tm, n in ((ref_tm, "ref"),
                                                 (pt_tm, "port")))
    assert _names(port, "span") == _names(ref, "span") == {
        "executor.run", "executor.feed", "executor.dispatch",
        "executor.fetch"}
    assert _names(port, "counter") == _names(ref, "counter")
    assert _names(port, "timer") == _names(ref, "timer") == \
        {"executor.interpret_ms"}
    runs = [r for r in port if r["kind"] == "span"
            and r["name"] == "executor.run"]
    assert len(runs) == 3 and len({r["attrs"]["trace"] for r in runs}) == 3
    child = next(r for r in port if r["kind"] == "span"
                 and r["name"] == "executor.dispatch")
    assert child["attrs"]["parent"] in {r["attrs"]["span"] for r in runs}


def test_compiled_runs_count_one_compile_and_name_the_recompile_cause(
        tmp_path):
    log = tmp_path / "port.jsonl"
    pt_tm.configure(str(log))
    exe, scope, main, loss = _port_mlp()
    for _ in range(4):
        exe.run(main, feed={"x": X}, fetch_list=[loss], scope=scope)
    exe.run(main, feed={"x": X}, fetch_list=[], scope=scope)   # seen
    exe.run(main, feed={"x": X}, fetch_list=[], scope=scope)   # captured
    recs = _read(pt_tm, log)
    compiles = [r for r in recs if r["kind"] == "compile"]
    assert [c["attrs"]["cause"] for c in compiles] == \
        ["first_compile", "fetch_names"]
    assert pt_tm.counter_get("executor.compiles") == 2
    assert pt_tm.counter_get("executor.cache_hits") == 2
    assert pt_tm.snapshot()["hists"]["executor.run_ms"]["count"] == 2
    # the reference names the same cause for the same change
    ref_exe, ref_scope, ref_main, ref_loss = _ref_mlp()
    ref_tm.configure(str(tmp_path / "ref.jsonl"))
    ref_exe.run(ref_main, feed={"x": X}, fetch_list=[ref_loss],
                scope=ref_scope)
    ref_exe.run(ref_main, feed={"x": X}, fetch_list=[], scope=ref_scope)
    ref_causes = [r["attrs"]["cause"] for r in
                  _read(ref_tm, tmp_path / "ref.jsonl")
                  if r["kind"] == "compile"]
    assert ref_causes == ["first_compile", "fetch_names"]


def _perf_json(log):
    r = subprocess.run([sys.executable,
                        os.path.join(REPO_ROOT, "tools", "perf_report.py"),
                        str(log), "--json"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout)


def test_perf_report_reads_both_logs_to_the_same_sections(tmp_path):
    _perf_report_sections(tmp_path)


def test_isolation_clears_a_live_mfu_gauge_set_just_before(tmp_path):
    """The port's gauge set a moment ago by an earlier test (its throttle
    stamped later than this test's runs) must not keep ``cost.live_mfu``
    out of the port's log once the fixture's isolation ran: the perf
    report sections agree. Without ``costmodel.reset`` the memcost
    sections differ (the failure of the original test, intermittent
    where the earlier dispatch came less than a second before)."""
    pt_costmodel._last_mfu_set[0] = __import__("time").time() + 3600.0
    _isolate()
    _perf_report_sections(tmp_path)


def _perf_report_sections(tmp_path):
    logs = {}
    for name, tm, fl, gp, build in (
            ("ref", ref_tm, ref_flags, ref_goodput, _ref_mlp),
            ("port", pt_tm, pt_flags, pt_goodput, _port_mlp)):
        fl.set_flags({"cost_capture": "cost"})
        exe, scope, main, loss = build()
        logs[name] = tmp_path / f"{name}.jsonl"
        tm.configure(str(logs[name]))
        gp.start_run()
        for _ in range(5):
            exe.run(main, feed={"x": X}, fetch_list=[loss], scope=scope)
        gp.publish()
        tm.flush()
        tm.configure(None)
        fl.set_flags({"cost_capture": "auto"})
    ref, port = _perf_json(logs["ref"]), _perf_json(logs["port"])
    assert sorted(port) == sorted(ref)
    for section in ("memcost", "goodput", "tracing"):
        assert port[section] and ref[section], section
        assert sorted(port[section]) == sorted(ref[section]), section
    assert len(port["compiles"]) == 1
    # 5 runs: the first op by op, then the capture and 3 replays
    assert port["counters"]["executor.cache_hits"]["last"] == 3
    assert port["memcost"]["captures"] == 1


def test_verify_gate_runs_once_and_raises_typed(tmp_path):
    pt_flags.set_flags({"verify_program": True})
    exe, scope, main, loss = _port_mlp()
    before = pt_tm.counter_get("verifier.programs")
    for _ in range(3):
        exe.run(main, feed={"x": X}, fetch_list=[loss], scope=scope)
    assert pt_tm.counter_get("verifier.programs") == before + 1
    # a read of a var that nothing defines fails the gate before any op
    bad = main.clone()
    bad.global_block().ops[0].inputs["X"] = ["no_such_var"]
    with pytest.raises(ProgramVerifyError):
        exe.run(bad, feed={"x": X}, fetch_list=[], scope=scope)


def test_goodput_breakdown_keys_and_phases_add_up():
    exe, scope, main, loss = _port_mlp()
    pt_goodput.start_run()
    for _ in range(5):
        exe.run(main, feed={"x": X}, fetch_list=[loss], scope=scope)
    port = pt_goodput.breakdown()
    ref = ref_goodput.breakdown()
    assert sorted(port) == sorted(ref)
    assert sorted(port["phases"]) == sorted(ref["phases"])
    assert port["window"] == "run"
    total = port["productive_ms"] + sum(port["phases"].values())
    assert total == pytest.approx(port["wall_ms"], rel=0.01)
    assert port["productive_ms"] > 0 and port["phases"]["compile"] > 0
    # each replay's device and host parts add up to its wall
    h = pt_tm.snapshot()["hists"]
    assert h["executor.device_ms"]["count"] == h["executor.run_ms"]["count"]
    assert h["executor.device_ms"]["total"] + \
        h["executor.host_dispatch_ms"]["total"] == \
        pytest.approx(h["executor.run_ms"]["total"], rel=1e-6)
    b = pt_goodput.publish()
    assert pt_tm.gauges()["goodput.ratio"] == b["ratio"]
    assert pt_tm.counter_get("goodput.wall_ms") == b["wall_ms"]


def test_profiler_summary_matches_the_reference(tmp_path, capsys):
    summaries = {}
    for name, prof, build in (("ref", ref_prof, _ref_mlp),
                              ("port", pt_prof, _port_mlp)):
        exe, scope, main, loss = build()
        path = tmp_path / f"{name}_trace.json"
        with prof.profiler(profile_path=str(path)):
            for _ in range(2):
                exe.run(main, feed={"x": X}, fetch_list=[loss],
                        scope=scope, use_compiled=False)
        summaries[name] = {n: s["calls"] for n, s in prof.summarize().items()}
        doc = json.loads(path.read_text())
        assert len(doc["traceEvents"]) == len(prof.events())
        assert all(e["ph"] == "X" and "dur" in e
                   for e in doc["traceEvents"])
    capsys.readouterr()
    assert summaries["port"] == summaries["ref"]
    assert summaries["port"]["mul"] == 2
    # off: nothing is recorded
    pt_prof.reset_profiler()
    exe, scope, main, loss = _port_mlp()
    exe.run(main, feed={"x": X}, fetch_list=[loss], scope=scope,
            use_compiled=False)
    assert pt_prof.events() == []


def test_profiler_ring_is_bounded_and_counts_its_drops(capsys):
    pt_flags.set_flags({"profiler_max_events": 10})
    try:
        pt_prof.start_profiler()
        for i in range(25):
            with pt_prof.RecordEvent(f"ev{i}"):
                pass
        evs = pt_prof.events()
        assert [e["name"] for e in evs] == [f"ev{i}" for i in range(15, 25)]
        assert pt_tm.counter_get("profiler.events_dropped") == 15
    finally:
        pt_prof.stop_profiler()
        capsys.readouterr()
        pt_flags.set_flags({"profiler_max_events": 1_000_000})


def test_exclusive_times_nest_as_the_reference_does():
    def ev(ts, dur, pid=1, tid=1):
        return {"ts": ts, "dur": dur, "pid": pid, "tid": tid}

    for evs in ([ev(0, 100), ev(10, 20), ev(12, 5)],
                [ev(0, 100), ev(10, 20), ev(50, 30)],
                [ev(0, 50), ev(40, 30)],
                [ev(0, 100), ev(10, 20), ev(10, 20, pid=2),
                 ev(5, 90, tid=2)]):
        port = pt_prof._exclusive_times(evs)
        ref = ref_prof._exclusive_times(evs)
        assert {evs.index(next(e for e in evs if id(e) == k)): v
                for k, v in port.items()} == \
            {evs.index(next(e for e in evs if id(e) == k)): v
             for k, v in ref.items()}


def test_device_profile_on_the_cpu_attributes_nothing_to_the_device():
    exe, scope, main, loss = _port_mlp()
    out = pt_prof.device_profile(
        lambda: exe.run(main, feed={"x": X}, fetch_list=[loss],
                        scope=scope, use_compiled=False), steps=2)
    assert out["rows"] == [] and out["ms_per_step"] == 0.0
    assert out["kernels"] == {}


def test_trace_writes_a_chrome_trace_with_the_op_ranges(tmp_path):
    exe, scope, main, loss = _port_mlp()
    with pt_prof.trace(str(tmp_path)):
        exe.run(main, feed={"x": X}, fetch_list=[loss], scope=scope,
                use_compiled=False)
    doc = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"mul", "elementwise_add", "sgd"} <= names
    assert not pt_prof.active()
