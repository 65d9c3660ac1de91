"""The micro-batching ServingEngine, its admission queue and its HTTP
front end, on the CPU.

* The reference's own engine cases (``tests/test_serving.py``: batched
  responses bit for bit equal to unbatched predictor runs across
  buckets, coalescing, the batch timeout, backpressure, deadlines, the
  drain, warm-up entries, the HTTP round trip, an injected
  ``serving.handler`` fault, feed validation, bucket boundaries),
  imported and run as they are with the names they import pointed at
  the port's engine, predictor, errors, telemetry and fault registry.
  They run on the serving tests' MLP, which the reference writes.
* BERT-tiny through the engine: requests of 1-4 rows coalesced into
  bucket 8 equal ``predictor.run`` of their rows padded to the bucket
  bit for bit, and the unbatched run within 1e-5 with the same argmax
  (the CPU's BLAS breaks the reference's bit-for-bit promise there).
* ``swap_predictor`` under concurrent traffic: every response carries
  the version that served it and equals that version's predictor output.
* Over HTTP: 429 on a full queue, 504 on an expired deadline, and
  ``/v1/infer`` and ``/v1/admin/swap`` answer the reference server's
  JSON for the same dir and inputs.
"""

import functools
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu.core.faults as jfaults
import paddle_tpu.core.telemetry as jtelemetry
import paddle_tpu.inference as jinference
import paddle_tpu.serving as jserving

import paddle_tpu_torch.inference as pinference
import paddle_tpu_torch.serving as pserving
from paddle_tpu_torch.core import faults as pfaults
from paddle_tpu_torch.core import telemetry as ptelemetry

import tests.test_serving as ref_serving
from tests.test_torch_inference_io import save_reference
from tests.test_torch_passes import bert_batch

torch.set_num_threads(2)


def _predictor(path):
    return pinference.create_predictor(
        pinference.AnalysisConfig(path, device="cpu"))


@pytest.fixture
def port_in_reference(monkeypatch):
    """Point the names the reference's serving cases import at call time
    at the port's."""
    monkeypatch.setattr(jinference, "create_predictor",
                        pinference.create_predictor)
    monkeypatch.setattr(jinference, "AnalysisConfig", functools.partial(
        pinference.AnalysisConfig, device="cpu"))
    for name in ("ServingConfig", "ServingEngine", "ServerOverloadedError",
                 "DeadlineExceededError", "EngineClosedError"):
        monkeypatch.setattr(jserving, name, getattr(pserving, name))
    monkeypatch.setattr(jserving, "serve",
                        functools.partial(pserving.serve, device="cpu"))
    monkeypatch.setattr(jtelemetry, "counter_get", ptelemetry.counter_get)
    monkeypatch.setattr(jfaults, "configure", pfaults.configure)


SERVING_CASES = [
    ("TestBatchedEquivalence", "test_batched_bitwise_identical_across_buckets"),
    ("TestBatchedEquivalence", "test_concurrent_clients_coalesce"),
    ("TestBatchingPolicy", "test_timeout_flushes_partial_batch"),
    ("TestBatchingPolicy", "test_backpressure_rejects_when_saturated"),
    ("TestBatchingPolicy", "test_expired_deadline_fails_at_dequeue"),
    ("TestBatchingPolicy", "test_graceful_drain_serves_backlog"),
    ("TestWarmup", "test_warmup_compiles_every_bucket_once"),
    ("TestHTTP", "test_http_round_trip_and_health"),
    ("TestHandlerFaults", "test_injected_fault_is_per_request_not_wedge"),
    ("TestValidation", "test_bad_feeds_rejected_before_queueing")]


@pytest.mark.parametrize("cls,case", SERVING_CASES,
                         ids=[c for _, c in SERVING_CASES])
def test_reference_serving_cases_on_the_port(cls, case, tmp_path,
                                             port_in_reference):
    try:
        getattr(getattr(ref_serving, cls)(), case)(tmp_path)
    finally:
        pfaults.configure("")


def test_reference_bucket_boundaries_on_the_port(port_in_reference):
    ref_serving.TestValidation().test_bucket_boundaries()


def padded_run(pred, feed, bucket):
    """``pred.run`` of ``feed``'s rows padded with zero rows to
    ``bucket``, sliced back to them: what the engine's batch computes for
    these rows, whatever the other rows hold."""
    rows = len(next(iter(feed.values())))
    out, = pred.run({k: np.concatenate([v, np.zeros(
        (bucket - rows,) + v.shape[1:], v.dtype)]) for k, v in feed.items()})
    return out[:rows]


def test_bert_tiny_batches_against_unbatched_runs(tmp_path):
    """The reference promises each caller the bits of an unbatched run of
    its own rows. The CPU's BLAS breaks it at BERT-tiny: the pooler's fc
    (M = rows) takes another path at one row than at several (the
    NSP logits differ by up to a few 1e-8). So each response is held bit
    for bit to the predictor's run of its rows padded to the bucket its
    batch ran at, and to the unbatched run within 1e-5 with the same
    argmax."""
    path = str(tmp_path / "bert")
    save_reference("bert", path)
    ref = _predictor(path)
    engine = pserving.ServingEngine(_predictor(path), pserving.ServingConfig(
        max_batch_size=8, batch_timeout_ms=20.0))
    client = pserving.LocalClient(engine)
    b0 = ptelemetry.counter_get("serving.batches")
    feeds = [bert_batch(n, seed) for seed, n in enumerate((1, 3, 2, 4, 1, 2))]
    # all queued before the worker starts: batches of 1+3+2+1 and 4+2 rows
    reqs = [engine.submit(f) for f in feeds]
    engine.start()
    try:
        for f, req in zip(feeds, reqs):
            got, = req.result(timeout=60)
            assert req.served_bucket == 8
            want = padded_run(ref, f, req.served_bucket)
            assert got.tobytes() == want.tobytes()
            alone, = ref.run(f)
            np.testing.assert_allclose(got, alone, rtol=0, atol=1e-5)
            assert (got.argmax(1) == alone.argmax(1)).all()
        out = client.infer(feeds[1], timeout=60)
        assert list(out) == engine.fetch_names
        assert out[engine.fetch_names[0]].shape == (3, 2)
    finally:
        engine.close(drain=True, timeout=30)
    assert ptelemetry.counter_get("serving.batches") - b0 == 3


def test_swap_predictor_under_traffic(tmp_path):
    """Clients keep submitting while the engine swaps from version 1 to
    version 2: every response names its version and equals that
    version's predictor output; both versions answer."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    save_reference("mlp", a)
    save_reference("mlp", b, seed=1)
    refs = {1: _predictor(a), 2: _predictor(b)}
    x0 = np.ones((1, 6), np.float32)
    assert not np.array_equal(refs[1].run({"x": x0})[0],
                              refs[2].run({"x": x0})[0])
    engine = pserving.ServingEngine(_predictor(a), pserving.ServingConfig(
        max_batch_size=8, batch_timeout_ms=2.0), version=1).start()
    done, seen, errors = threading.Event(), [], []

    def client(i):
        rng = np.random.RandomState(i)
        while not done.is_set():
            x = rng.randn(1 + i % 3, 6).astype(np.float32)
            try:
                req = engine.submit({"x": x})
                out, = req.result(timeout=30)
                seen.append((req.served_version, x, out))
            except Exception as e:   # recorded: the test fails on any
                errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.2)
        fresh = engine.swap_predictor(_predictor(b), version=2)
        assert fresh == len(engine.config.buckets)
        time.sleep(0.2)
    finally:
        done.set()
        for t in threads:
            t.join(30)
        engine.close(drain=True, timeout=30)
    assert not errors
    assert {v for v, _, _ in seen} == {1, 2}
    assert engine.version == 2 and engine.stats()["model_version"] == 2
    for v, x, out in seen:
        want, = refs[v].run({"x": x})
        assert out.tobytes() == want.tobytes()


def _post(url, path, doc, timeout=30):
    req = urllib.request.Request(url + path, data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_429_on_a_full_queue_and_504_on_an_expired_deadline(tmp_path):
    path = str(tmp_path / "mlp")
    save_reference("mlp", path)
    engine = pserving.ServingEngine(_predictor(path), pserving.ServingConfig(
        max_batch_size=8, max_queue_depth=1))
    server = pserving.ServingHTTPServer(engine).start()
    x = np.ones((1, 6), np.float32).tolist()
    first = {}
    try:
        # the worker is not started: the first request holds the one slot
        t = threading.Thread(target=lambda: first.update(r=_post(
            server.url, "/v1/infer", {"inputs": {"x": x},
                                      "deadline_ms": 50})))
        t.start()
        deadline = time.monotonic() + 10
        while engine.queue.depth() < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        code, doc = _post(server.url, "/v1/infer", {"inputs": {"x": x}})
        assert code == 429 and "queue full" in doc["error"]
        time.sleep(0.1)
        engine.start(warmup=False)
        t.join(30)
        assert first["r"][0] == 504
        code, doc = _post(server.url, "/v1/infer", {"inputs": {"x": x}})
        assert code == 200 and doc["model_version"] == 0
        code, doc = _post(server.url, "/v1/infer", {"inputs": {}})
        assert code == 400
    finally:
        server.shutdown()
        engine.close(drain=True, timeout=30)


def test_infer_and_swap_answer_the_reference_servers_json(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    save_reference("mlp", a)
    save_reference("mlp", b, seed=1)
    jsrv = jserving.serve(a, port=0)
    psrv = pserving.serve(a, port=0, device="cpu")
    body = {"inputs": {"x": np.random.RandomState(5).randn(3, 6)
                       .astype(np.float32).tolist()}}
    try:
        for step in ("infer", "swap", "infer"):
            if step == "swap":
                doc = {"model_dir": b, "version": 7}
                jr, pr = (_post(s.url, "/v1/admin/swap", doc)
                          for s in (jsrv, psrv))
                assert jr == pr
                assert pr == (200, {"status": "ok", "model_version": 7,
                                    "warmup_compiles": 4})
                continue
            (jc, jd), (pc, pd) = (_post(s.url, "/v1/infer", body)
                                  for s in (jsrv, psrv))
            assert jc == pc == 200
            assert sorted(pd) == sorted(jd)
            for key in ("model_version", "trace_id"):
                assert pd[key] == jd[key]
            assert list(pd["outputs"]) == list(jd["outputs"])
            for n in jd["outputs"]:
                np.testing.assert_allclose(pd["outputs"][n],
                                           jd["outputs"][n], rtol=0,
                                           atol=1e-6)
        bad = {"model_dir": str(tmp_path / "missing")}
        assert _post(psrv.url, "/v1/admin/swap", bad)[0] == 500
        assert _post(psrv.url, "/v1/admin/swap", {})[0] == 400
        with urllib.request.urlopen(psrv.url + "/v1/stats") as resp:
            stats = json.loads(resp.read())
        assert stats["model_version"] == 7 and stats["swaps"] >= 1
    finally:
        for s in (jsrv, psrv):
            s.shutdown()
            s.engine.close(drain=True, timeout=30)
