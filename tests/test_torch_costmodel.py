"""The port's cost and memory plane (``core/costmodel.py``) on the CPU.

* Flops counted on meta tensors under FlopCounterMode: a forward fc
  stack equals its analytic sum of 2MKN exactly, and the reference's XLA
  cost analysis of the same program within 5 %; the weight-only
  ``int8_matmul`` equals the reference's CostEstimate at
  ``ops/pallas/int8_gemm.py:131`` (2 * Mp * K * Np); paged attention its
  estimate at ``paged_attention.py:165`` (4 * B * n * S * hd); a flash
  op 4 * B * H * Sq * Sk * D forward and 10 (five products) backward,
  where the reference's flash sites declare no estimate.
* The executor's capture: one record per capture key, ``cost.captures``,
  ``cost.dispatch_flops`` booked per replay and k times for
  ``run_steps``, the ledger gauges, the live MFU and roofline verdict;
  level ``full`` on the CPU counts the memory analysis as unavailable;
  'auto' is off without a sink and 'cost' with one.
* OOM forensics: a ``torch.OutOfMemoryError`` in a run becomes
  ``costmodel.OutOfMemoryError`` with one ``kind:"oom"`` record and one
  incident; ``tools/mem_report.py`` renders the log.
* Serving: the engine's warmed buckets publish their cost records in
  ``/v1/stats``'s ``memory`` section; the KV pool's three gauges.
* The reference's cases that touch no jax (``tests/test_costmodel.py``:
  the OOM markers, the peak override, 'auto' without a sink, the metrics
  server's cost gauges) run on the port by import.
"""

import inspect
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import layers as ref_layers
from paddle_tpu.core import costmodel as ref_cost
from paddle_tpu.core import flags as ref_flags
from paddle_tpu.core import telemetry as ref_tm
import paddle_tpu_torch as ptt
from paddle_tpu_torch import layers as pt_layers
from paddle_tpu_torch import optimizer as pt_opt
from paddle_tpu_torch.core import costmodel, incidents, registry, telemetry
from paddle_tpu_torch.core import flags as pt_flags
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.kernels import paged_attention as pt_paged

import tests.test_costmodel as ref_cases

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh():
    for tm, cm in ((telemetry, costmodel), (ref_tm, ref_cost)):
        tm.configure(None)
        tm.reset()
        cm.reset()
    incidents.reset()
    yield
    pt_flags.set_flags({"cost_capture": "auto", "device_peak_flops": 0.0,
                        "device_peak_bw": 0.0})
    ref_flags.set_flags({"cost_capture": "auto"})
    for tm, cm in ((telemetry, costmodel), (ref_tm, ref_cost)):
        tm.configure(None)
        tm.reset()
        cm.reset()
    incidents.reset()


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _count(op_type, ins, attrs):
    def run(each):
        registry.get(op_type).forward(ins, attrs)
    return costmodel.count_ops(run)[0]


FC_DIMS = (64, 512, 512, 256, 10)      # batch, then each layer's width


def _fc_stack(package, layers_mod):
    main, startup = package.Program(), package.Program()
    with package.program_guard(main, startup):
        h = layers_mod.data("x", [FC_DIMS[1]], stop_gradient=True)
        for width in FC_DIMS[2:-1]:
            h = layers_mod.fc(h, width, act="relu")
        out = layers_mod.mean(layers_mod.fc(h, FC_DIMS[-1]))
    return main, startup, out


def test_fc_stack_flops_are_its_gemms_and_near_xla():
    x = np.random.RandomState(0).randn(*FC_DIMS[:2]).astype(np.float32)
    analytic = sum(2 * FC_DIMS[0] * k * n
                   for k, n in zip(FC_DIMS[1:-1], FC_DIMS[2:]))
    pt_flags.set_flags({"cost_capture": "cost"})
    main, startup, out = _fc_stack(ptt, pt_layers)
    exe, scope = Executor(device="cpu"), ptt.Scope()
    exe.run(startup, scope=scope)
    for _ in range(2):     # the key's first run, then its capture
        exe.run(main, feed={"x": x}, fetch_list=[out], scope=scope)
    (rec,) = costmodel.programs()
    assert rec.flops == analytic
    assert rec.source == "meta" and rec.gemm_dtype == "float32"
    ref_flags.set_flags({"cost_capture": "cost"})
    rmain, rstartup, rout = _fc_stack(pt, ref_layers)
    rexe, rscope = pt.Executor(), pt.Scope()
    rexe.run(rstartup, scope=rscope, use_compiled=False)
    rexe.run(rmain, feed={"x": x}, fetch_list=[rout], scope=rscope)
    (xla,) = ref_cost.programs()
    assert rec.flops == pytest.approx(xla.flops, rel=0.05)


def test_int8_matmul_counts_the_reference_estimate():
    from paddle_tpu.ops.pallas import int8_gemm as ref_int8

    for m, k, n in ((64, 256, 512), (256, 128, 384)):
        flops = _count("int8_matmul", {
            "X": [_meta(m, k)], "Y": [_meta(k, n, dtype=torch.int8)],
            "YScale": [_meta(n)], "Bias": [_meta(n)]}, {"act": "relu"})
        bm, bn = min(ref_int8.BLOCK_M, m), min(ref_int8.BLOCK_N, n)
        mp, np_ = -(-m // bm) * bm, -(-n // bn) * bn
        assert flops == 2.0 * mp * k * np_


def test_paged_attention_counts_the_reference_estimate():
    b, n, hd, pages, page, mp = 3, 4, 16, 10, 8, 5
    def run(each):
        pt_paged.paged_decode_attention(
            _meta(b, n * hd), _meta(pages, page, n * hd),
            _meta(pages, page, n * hd), _meta(b, mp, dtype=torch.int32),
            _meta(b, dtype=torch.int32), n, hd, 0.25)
    assert costmodel.count_ops(run)[0] == 4.0 * b * n * (mp * page) * hd


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_op_counts_its_products(dtype):
    b, h, sq, sk, d = 2, 4, 64, 32, 16
    q, k, v = (_meta(b, h, s, d, dtype=dtype) for s in (sq, sk, sk))
    assert _count("flash_attention", {"Q": [q], "K": [k], "V": [v]},
                  {"scale": 0.25}) == 4.0 * b * h * sq * sk * d
    grad = {"Q": [q], "K": [k], "V": [v], "Out": [_meta(b, h, sq, d,
                                                        dtype=dtype)],
            "Lse": [_meta(b, h, sq)],
            "OutGrad": [_meta(b, h, sq, d, dtype=dtype)]}
    assert _count("flash_attention_grad", grad, {"scale": 0.25}) == \
        10.0 * b * h * sq * sk * d


def _mlp(hidden=8):
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = pt_layers.data("x", [4], stop_gradient=True)
        loss = pt_layers.mean(pt_layers.fc(x, hidden, act="relu"))
        pt_opt.SGDOptimizer(0.1).minimize(loss)
    exe, scope = Executor(device="cpu"), ptt.Scope()
    exe.run(startup, scope=scope, use_compiled=False)
    return exe, scope, main, loss


def _read(path):
    telemetry.flush_sink()
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_capture_books_each_dispatch_and_run_steps_k_times(tmp_path):
    log = tmp_path / "run.jsonl"
    telemetry.configure(str(log))
    assert costmodel.capture_mode() == "cost"
    exe, scope, main, loss = _mlp()
    x = np.ones((4, 4), np.float32)
    for _ in range(4):
        exe.run(main, feed={"x": x}, fetch_list=[loss], scope=scope)
    (rec,) = costmodel.programs()
    assert rec.flops > 0 and rec.bytes_accessed > 0
    assert rec.roofline() in ("compute_bound", "memory_bound")
    assert telemetry.counter_get("cost.captures") == 1
    # the capture and two replays
    assert telemetry.counter_get("cost.dispatch_flops") == 3 * rec.flops
    before = telemetry.counter_get("cost.dispatch_flops")
    exe.run_steps(main, feed={"x": np.stack([x] * 4)}, fetch_list=[loss],
                  k=4, scope=scope)
    assert telemetry.counter_get("cost.dispatch_flops") - before == \
        4 * int(rec.flops)
    assert telemetry.counter_get("executor.fused_steps") == 4
    assert costmodel.live_mfu() > 0
    g = telemetry.gauges()
    assert g["mem.param_bytes"] > 0 and g["cost.live_mfu"] > 0
    led = costmodel.ledger()
    assert g["mem.hbm_total_bytes"] == led["total_bytes"] == \
        led["param_bytes"] + led["opt_state_bytes"] + led["peak_temp_bytes"]
    (cost_rec,) = [r for r in _read(log) if r["kind"] == "cost"]
    assert cost_rec["attrs"]["flops"] == rec.flops
    assert cost_rec["attrs"]["key"] == rec.key_id
    assert costmodel.peak_device_flops("bfloat16") == 989e12
    assert costmodel.peak_device_flops("float32") == 67e12
    assert costmodel.peak_device_flops("int8") == 1979e12
    assert costmodel.peak_device_bandwidth() == 3.35e12


def test_full_capture_on_the_cpu_counts_the_memory_analysis(tmp_path):
    pt_flags.set_flags({"cost_capture": "full"})
    exe, scope, main, loss = _mlp()
    x = np.ones((4, 4), np.float32)
    for _ in range(2):
        exe.run(main, feed={"x": x}, fetch_list=[loss], scope=scope)
    (rec,) = costmodel.programs()
    assert rec.flops > 0 and rec.peak_bytes == 0 and rec.source == "meta"
    assert telemetry.counter_get("costmodel.unavailable") == 1
    # a count that cannot run on meta is counted on the CPU as well
    got = costmodel.capture(lambda: 1 / 0, key_id="k", kind="executor",
                            program="p", device="cpu")
    assert got is None
    assert telemetry.counter_get("costmodel.unavailable") == 2
    with pytest.raises(ZeroDivisionError):
        costmodel.capture(lambda: 1 / 0, key_id="k", kind="executor",
                          program="p", device="cuda")


def test_out_of_memory_in_a_run_is_typed_with_its_forensics(tmp_path,
                                                           monkeypatch):
    log = tmp_path / "run.jsonl"
    telemetry.configure(str(log))
    exe, scope, main, loss = _mlp()
    x = np.ones((4, 4), np.float32)
    exe.run(main, feed={"x": x}, fetch_list=[loss], scope=scope)
    opdef = registry.get("mean")

    def exhausted(ins, attrs):
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                     "allocate 4.00 TiB")

    monkeypatch.setattr(opdef, "forward", exhausted)
    with pytest.raises(costmodel.OutOfMemoryError, match="4.00 TiB"):
        exe.run(main, feed={"x": x}, fetch_list=[loss], scope=scope,
                use_compiled=False)
    monkeypatch.undo()
    recs = _read(log)
    (oom,) = [r for r in recs if r["kind"] == "oom"]
    assert oom["attrs"]["where"] == "executor.dispatch"
    assert "ledger" in oom["attrs"] and "top_programs" in oom["attrs"]
    (inc,) = [r for r in recs if r["kind"] == "incident"]
    assert inc["attrs"]["source"] == "oom"
    assert telemetry.counter_get("mem.oom_events") == 1
    # the program runs on
    out = exe.run(main, feed={"x": x}, fetch_list=[loss], scope=scope)
    assert np.isfinite(out[0]).all()
    telemetry.flush()
    r = subprocess.run([sys.executable, os.path.join(REPO_ROOT, "tools",
                                                     "mem_report.py"),
                        str(log), "--json"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert len(json.loads(r.stdout)["ooms"]) == 1


def test_engine_buckets_publish_their_cost_records(tmp_path):
    from paddle_tpu_torch import io as pt_io
    from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    pt_flags.set_flags({"cost_capture": "cost"})
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = pt_layers.data("x", [4], stop_gradient=True)
        y = pt_layers.fc(x, 3)
    scope = ptt.Scope()
    Executor(device="cpu").run(startup, scope=scope, use_compiled=False)
    pt_io.save_inference_model(str(tmp_path / "m"), ["x"], [y],
                               main_program=main, scope=scope)
    pred = create_predictor(AnalysisConfig(str(tmp_path / "m"),
                                           device="cpu"))
    engine = ServingEngine(pred, ServingConfig(max_batch_size=4)).start()
    try:
        mem = engine.stats()["memory"]
    finally:
        engine.close()
    assert sorted(mem["buckets"], key=int) == ["1", "2", "4"]
    for b, row in mem["buckets"].items():
        assert row["flops"] == 2 * int(b) * 4 * 3
    assert mem["ledger"]["param_bytes"] > 0


def test_kv_pool_publishes_its_three_gauges():
    from paddle_tpu_torch.serving.kv_cache import KVPagePool

    pool = KVPagePool(n_layers=2, num_pages=9, page_size=4, kv_dim=8)
    g = telemetry.gauges()
    assert g["mem.serving.kv_pool_bytes"] == pool.pool_bytes
    pages = pool.try_alloc(3)
    pool.free(pages[:2])
    g = telemetry.gauges()
    per_page = pool.pool_bytes // 9
    assert g["mem.serving.kv_used_bytes"] == per_page
    assert g["mem.serving.kv_high_water_bytes"] == 3 * per_page
    led = costmodel.ledger()
    assert led["serving_kv_pool_bytes"] == pool.pool_bytes
    assert led["serving_kv_high_water_bytes"] == 3 * per_page


@pytest.fixture
def port_in_reference(monkeypatch):
    port = types.SimpleNamespace(
        Program=ptt.Program, program_guard=ptt.program_guard,
        optimizer=pt_opt, Scope=ptt.Scope,
        Executor=lambda *a, **kw: Executor(device="cpu"))
    monkeypatch.setattr(ref_cases, "pt", port)
    monkeypatch.setattr(ref_cases, "layers", pt_layers)
    monkeypatch.setattr(ref_cases, "costmodel", costmodel)
    monkeypatch.setattr(ref_cases, "telemetry", telemetry)
    monkeypatch.setattr(ref_cases, "set_flags", pt_flags.set_flags)


REF_CASES = [("TestOOMForensics", "test_is_oom_error_markers"),
             ("TestCaptureExecutor", "test_peak_flops_override"),
             ("TestCaptureExecutor", "test_auto_is_off_when_uninstrumented"),
             ("TestLiveMetricsPlane",
              "test_metrics_server_exposes_cost_and_mem_gauges")]


@pytest.mark.parametrize("cls,name", REF_CASES,
                         ids=[f"{c}.{n}" for c, n in REF_CASES])
def test_reference_cases_on_the_port(cls, name, port_in_reference, tmp_path):
    method = getattr(getattr(ref_cases, cls)(), name)
    args = {"tmp_path": tmp_path, "scope": ptt.Scope()}
    method(**{k: v for k, v in args.items()
              if k in inspect.signature(method).parameters})


def test_a_fresh_count_of_the_program_equals_the_capture():
    from paddle_tpu_torch.core.executor import program_cost

    pt_flags.set_flags({"cost_capture": "cost"})
    exe, scope, main, loss = _mlp(hidden=16)
    feed = {"x": np.ones((4, 4), np.float32)}
    for _ in range(2):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    (rec,) = costmodel.programs()
    flops, nbytes, gemm = program_cost(main, feed, [loss], scope)
    assert (flops, nbytes, gemm) == (rec.flops, rec.bytes_accessed,
                                     rec.gemm_dtype)
