"""Published models and the rolling swap, on the CPU.

* ``publish_model`` / ``verify_model_dir`` / ``ModelWatcher`` agree
  across the packages: a dir published by either verifies in the other
  with the same manifest fields, versions number alike, and a torn or
  corrupt publish (a missing manifest, a truncated file, a flipped byte,
  an uncommitted staging dir) is invisible to both watchers, which fall
  back to the newest version that verifies.
* The controller over a models root rolls from version 1 to version 2
  under closed-loop traffic through the router, with in-process replicas
  and with two replica processes: no request fails, every response names
  its version and equals that version's predictor output (bit for bit the
  run of its rows padded to the bucket it was served at), both versions
  answer, at most one replica is not ready at any moment, and afterwards
  every replica reports version 2.
* The knobs off the controller's path: a replica process with
  ``--poll-s`` watches its root and swaps itself to a new publish, one
  with ``--no-warmup`` builds no bucket before its first request, and a
  controller with ``auto_swap=False`` leaves the fleet on its version
  until ``roll_to``.
"""

import json
import os
import queue
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu import checkpoint as jckpt

import paddle_tpu_torch.inference as pinference
from paddle_tpu_torch import checkpoint as pckpt
from paddle_tpu_torch.serving import ClusterController, ServingConfig
from paddle_tpu_torch.serving.router import _http_json

from tests.test_torch_inference_io import save_reference
from tests.test_torch_serving_engine import padded_run

torch.set_num_threads(2)

PKGS = {"reference": jckpt, "port": pckpt}


@pytest.mark.parametrize("publisher", ["reference", "port"])
def test_publish_verifies_in_both_packages(tmp_path, publisher):
    src = str(tmp_path / "src")
    save_reference("mlp", src)
    root = str(tmp_path / "models")
    pub = PKGS[publisher]
    p1 = pub.publish_model(root, src)
    p2 = pub.publish_model(root, src, extras={"note": "second"})
    assert [os.path.basename(p) for p in (p1, p2)] == \
        ["model-000001", "model-000002"]
    for mod in PKGS.values():
        assert mod.list_model_versions(root) == [(1, p1), (2, p2)]
        m = mod.verify_model_dir(p2)
        assert m["format"] == "paddle_tpu-model-v1" and m["version"] == 2
        assert m["committed"] and m["extras"] == {"note": "second"}
        assert sorted(m["files"]) == sorted(os.listdir(src))
        w = mod.ModelWatcher(root)
        assert w.poll() == (2, p2) and w.poll() is None
        assert mod.ModelWatcher(root, last_version=2).poll() is None
    with pytest.raises(pckpt.CheckpointError, match="immutable"):
        pckpt.publish_model(root, src, version=2)


def _corrupt(path, how):
    if how == "no_manifest":
        os.remove(os.path.join(path, "MANIFEST.json"))
    elif how == "uncommitted":
        mpath = os.path.join(path, "MANIFEST.json")
        with open(mpath) as f:
            m = json.load(f)
        m["committed"] = False
        with open(mpath, "w") as f:
            json.dump(m, f)
    else:
        name = next(n for n in sorted(os.listdir(path)) if n.endswith(".npy"))
        fpath = os.path.join(path, name)
        data = bytearray(open(fpath, "rb").read())
        if how == "torn":
            data = data[:len(data) // 2]
        else:                       # one flipped byte, same size
            data[-1] ^= 0xFF
        with open(fpath, "wb") as f:
            f.write(data)


@pytest.mark.parametrize("how", ["no_manifest", "uncommitted", "torn",
                                 "bitflip"])
def test_torn_or_corrupt_publish_is_invisible_to_both(tmp_path, how):
    src = str(tmp_path / "src")
    save_reference("mlp", src)
    root = str(tmp_path / "models")
    p1 = pckpt.publish_model(root, src)
    p2 = jckpt.publish_model(root, src)
    _corrupt(p2, how)
    # a staging dir left by a killed publish is not a version either
    shutil.copytree(p1, os.path.join(root, ".tmp-model-000003-1-1"))
    for mod in PKGS.values():
        with pytest.raises(mod.CheckpointCorruptError):
            mod.verify_model_dir(p2)
        assert mod.ModelWatcher(root).latest() == (1, p1)
        assert [v for v, _ in mod.list_model_versions(root)] == [1, 2]


def _roll_under_traffic(tmp_path, inprocess):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    save_reference("mlp", a)
    save_reference("mlp", b, seed=1)
    refs = {v: pinference.create_predictor(
        pinference.AnalysisConfig(d, device="cpu")) for v, d in
        ((1, a), (2, b))}
    root = str(tmp_path / "models")
    pckpt.publish_model(root, a)
    cluster = ClusterController(
        root, replicas=2, inprocess=inprocess, device="cpu",
        serving_config=ServingConfig(max_batch_size=8, batch_timeout_ms=2.0),
        model_poll_s=0.1).start()
    done, answers, failures, not_ready = threading.Event(), [], [], []

    def client(i):
        rng = np.random.RandomState(i)
        while not done.is_set():
            x = rng.randn(1 + i % 3, 6).astype(np.float32)
            try:
                code, doc = _http_json(
                    "POST", cluster.url, "/v1/infer",
                    body=json.dumps({"inputs": {"x": x.tolist()}}).encode(),
                    timeout=60)
            except OSError as e:
                failures.append(repr(e))
                continue
            if code != 200:
                failures.append((code, doc))
            else:
                answers.append((x, doc))

    def watch_health():
        while not done.is_set():
            states = []
            for r in cluster.replicas:
                try:
                    states.append(_http_json("GET", r.url, "/healthz",
                                             timeout=5)[0])
                except OSError:
                    states.append(-1)
            not_ready.append(sum(s != 200 for s in states))
            time.sleep(0.02)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    threads.append(threading.Thread(target=watch_health))
    try:
        for t in threads:
            t.start()
        time.sleep(0.5)
        pckpt.publish_model(root, b)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and \
                cluster.current_version != 2:
            time.sleep(0.05)
        time.sleep(0.5)
    finally:
        done.set()
        for t in threads:
            t.join(60)
        versions = [_http_json("GET", r.url, "/v1/stats")[1]["model_version"]
                    for r in cluster.replicas]
        cluster.close()
    assert not failures, failures[:3]
    assert cluster.current_version == 2 and versions == [2, 2]
    assert max(not_ready) <= 1, "two replicas were not ready at once"
    seen = {doc["model_version"] for _, doc in answers}
    assert seen == {1, 2}, seen
    name = refs[1].fetch_names[0]
    for x, doc in answers:
        got = np.asarray(doc["outputs"][name], np.float32)
        ref = refs[doc["model_version"]]
        alone, = ref.run({"x": x})
        np.testing.assert_allclose(got, alone, rtol=0, atol=1e-5)
        assert any(got.tobytes() == padded_run(ref, {"x": x}, b_).tobytes()
                   for b_ in (1, 2, 4, 8) if b_ >= len(x))


def test_inprocess_controller_rolls_under_traffic(tmp_path):
    _roll_under_traffic(tmp_path, inprocess=True)


def test_process_controller_rolls_under_traffic(tmp_path):
    _roll_under_traffic(tmp_path, inprocess=False)


def test_controller_refuses_a_root_with_no_verified_model(tmp_path):
    from paddle_tpu_torch.serving import ClusterError

    with pytest.raises(ClusterError, match="no verified published model"):
        ClusterController(str(tmp_path / "empty"), inprocess=True,
                          device="cpu").start()


def _spawn_replica(*args):
    """A replica process on the CPU; returns it, its URL and a queue of
    its output lines (None once the output ends)."""
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.replica",
         "--port", "0", "--device", "cpu", *args], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        bufsize=1)
    lines = queue.Queue()

    def read():
        for line in proc.stdout:
            lines.put(line.rstrip())
        lines.put(None)

    threading.Thread(target=read, daemon=True).start()
    ready = _await_line(lines, "PT_REPLICA_READY ")
    return proc, json.loads(ready[len("PT_REPLICA_READY "):])["url"], lines


def _await_line(lines, prefix, timeout=120.0):
    deadline = time.monotonic() + timeout
    seen = []
    while time.monotonic() < deadline:
        try:
            line = lines.get(timeout=max(0.0, deadline - time.monotonic()))
        except queue.Empty:
            break
        if line is None:
            break
        seen.append(line)
        if line.startswith(prefix):
            return line
    raise AssertionError(f"no {prefix!r} line; output:\n" +
                         "\n".join(seen[-20:]))


def _await_ready(url, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if _http_json("GET", url, "/healthz", timeout=5)[0] == 200:
            return
        time.sleep(0.05)
    raise AssertionError(f"{url} never became ready")


def _infer(url, x):
    code, doc = _http_json("POST", url, "/v1/infer", body=json.dumps(
        {"inputs": {"x": x.tolist()}}).encode(), timeout=60)
    assert code == 200, doc
    return doc


def _stop(proc):
    proc.terminate()
    try:
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()


@pytest.mark.parametrize("warmup", [True, False])
def test_replica_warms_its_buckets_unless_told_not_to(tmp_path, warmup):
    a = str(tmp_path / "a")
    save_reference("mlp", a)
    ref = pinference.create_predictor(
        pinference.AnalysisConfig(a, device="cpu"))
    x = np.random.RandomState(0).randn(3, 6).astype(np.float32)
    proc, url, _ = _spawn_replica("--model-dir", a, "--max-batch-size", "4",
                                  *([] if warmup else ["--no-warmup"]))
    try:
        _await_ready(url)
        stats = _http_json("GET", url, "/v1/stats")[1]
        buckets = stats["serving_config"]["buckets"]
        assert buckets == [1, 2, 4]
        assert stats.get("warmup_compiles", 0) == \
            (len(buckets) if warmup else 0)
        doc = _infer(url, x)
        assert doc["model_version"] == 0
        got = np.asarray(doc["outputs"][ref.fetch_names[0]], np.float32)
        assert got.tobytes() == padded_run(ref, {"x": x}, 4).tobytes()
    finally:
        _stop(proc)


def test_replica_polls_its_root_and_swaps_itself(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    save_reference("mlp", a)
    save_reference("mlp", b, seed=1)
    refs = {v: pinference.create_predictor(
        pinference.AnalysisConfig(d, device="cpu")) for v, d in
        ((1, a), (2, b))}
    root = str(tmp_path / "models")
    pckpt.publish_model(root, a)
    x = np.random.RandomState(1).randn(2, 6).astype(np.float32)
    name = refs[1].fetch_names[0]
    proc, url, lines = _spawn_replica("--model-root", root, "--poll-s", "0.1")
    try:
        _await_ready(url)
        for version, publish in ((1, None), (2, b)):
            if publish:
                pckpt.publish_model(root, publish)
                assert _await_line(lines, "PT_REPLICA_SWAP") == \
                    f"PT_REPLICA_SWAPPED {version}"
                _await_ready(url)
            doc = _infer(url, x)
            assert doc["model_version"] == version
            got = np.asarray(doc["outputs"][name], np.float32)
            assert got.tobytes() == \
                padded_run(refs[version], {"x": x}, 2).tobytes()
        assert refs[1].run({"x": x})[0].tobytes() != got.tobytes()
    finally:
        _stop(proc)


def test_controller_without_auto_swap_waits_for_roll_to(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    save_reference("mlp", a)
    save_reference("mlp", b, seed=1)
    root = str(tmp_path / "models")
    pckpt.publish_model(root, a)
    cluster = ClusterController(root, replicas=2, inprocess=True,
                                device="cpu", model_poll_s=0.05,
                                auto_swap=False).start()
    x = np.ones((1, 6), np.float32)
    try:
        p2 = pckpt.publish_model(root, b)
        time.sleep(0.5)   # ten polls of a watcher, were one running
        for want in (1, 2):
            if want == 2:
                cluster.roll_to(2, p2)
            assert cluster.current_version == want
            assert [_http_json("GET", r.url, "/v1/stats")[1]
                    ["model_version"] for r in cluster.replicas] == \
                [want, want]
            assert _infer(cluster.url, x)["model_version"] == want
    finally:
        cluster.close()
