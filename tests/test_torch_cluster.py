"""The port's cluster controller (paddle_tpu_torch/serving/cluster.py) and
replica process (serving/replica.py) held against paddle_tpu's.

The tiny decoder LM of ``tests/test_orchestrator.py`` (``CFG_KW``, seed
0) in one servable dir written by the reference's ``save_decoder_lm``;
the JAX side on its stock CPU route (``PT_PALLAS=off``), the port on the
CPU (``device="cpu"``).

* In-process controllers, ``{"decode": 1}`` and ``{"prefill": 1,
  "decode": 1}``: greedy and sampled ids through the router equal the
  reference controller's; behind a prefill tier the decode replica pulls
  every prefill through the router (``router.prefill_forwards``) and
  installs it (``disagg.installs``).
* Process replicas (``python -m paddle_tpu_torch.serving.replica
  --device cpu``), ``{"decode": 2}``: a journaled sampled request's
  replica is SIGKILLed mid-generation; the router resumes the session on
  the survivor and the ids equal the reference's uninterrupted in-process
  run, ``failed_over`` is set, ``session.failovers`` counts it, and the
  monitor respawns the slot with its role.
* The replica refuses ``--telemetry-log`` (ROADMAP A10); its predictor
  mode (ROADMAP A5b, ported since) refuses a decoder-LM dir, which is no
  inference model, and a controller needs a models root or a decode model
  dir (``tests/test_torch_model_swap.py`` holds the predictor fleet).

Every wait carries its own deadline; every controller is closed in a
``finally``.
"""

import json
import os
import signal
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu.models import decoder_lm as jax_lm
from paddle_tpu.serving import cluster as jax_cluster

from paddle_tpu_torch.core import telemetry as pt_telemetry
from paddle_tpu_torch.serving import cluster as pt_cluster
from paddle_tpu_torch.serving import replica as pt_replica

from tests.test_orchestrator import CFG_KW, PROMPT

torch.set_num_threads(2)

SAMPLED = {"prompt_ids": PROMPT, "max_new_tokens": 14, "temperature": 0.8,
           "seed": 11}
GREEDY = {"prompt_ids": [int(t) for t in
                         np.random.RandomState(5).randint(3, 96, 24)],
          "max_new_tokens": 6, "temperature": 0.0}


@pytest.fixture(scope="module")
def lm_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cluster_lm")
    cfg = jax_lm.DecoderLMConfig(**CFG_KW)
    jax_lm.save_decoder_lm(str(d), cfg, jax_lm.decoder_lm_params(cfg, 0))
    return str(d)


@pytest.fixture(scope="module", autouse=True)
def jax_pallas_off():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PT_PALLAS", "off")
        yield


def _generate(url, body, timeout=120):
    req = urllib.request.Request(
        url + "/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _inproc_ids(mod, lm_dir, role_counts, **kw):
    cluster = mod.ClusterController(
        "", decode_model_dir=lm_dir, role_counts=role_counts,
        inprocess=True, **kw).start(ready_timeout_s=120)
    try:
        return [_generate(cluster.url, b)["tokens"]
                for b in (GREEDY, SAMPLED)]
    finally:
        cluster.close()


@pytest.fixture(scope="module")
def reference_ids(lm_dir, jax_pallas_off):
    return _inproc_ids(jax_cluster, lm_dir, {"decode": 1})


def test_inprocess_decode_tier_matches_reference(lm_dir, reference_ids):
    got = _inproc_ids(pt_cluster, lm_dir, {"decode": 1}, device="cpu")
    assert got == reference_ids
    assert len(got[1]) == 14


def test_inprocess_prefill_tier_matches_reference(lm_dir, reference_ids):
    forwards0 = pt_telemetry.counter_get("router.prefill_forwards")
    installs0 = pt_telemetry.counter_get("disagg.installs")
    got = _inproc_ids(pt_cluster, lm_dir, {"prefill": 1, "decode": 1},
                      device="cpu")
    want = _inproc_ids(jax_cluster, lm_dir, {"prefill": 1, "decode": 1})
    assert got == want == reference_ids
    assert pt_telemetry.counter_get("router.prefill_forwards") - \
        forwards0 >= 2
    assert pt_telemetry.counter_get("disagg.installs") - installs0 >= 2


def test_process_replica_sigkill_resumes_bitwise(lm_dir, reference_ids):
    """SIGKILL the serving decode replica process mid-generation: the
    journaled session resumes on the survivor, bit for bit the reference's
    uninterrupted ids, and the slot comes back with its role."""
    env = dict(os.environ, FLAGS_decode_step_delay_ms="60")
    failovers0 = pt_telemetry.counter_get("session.failovers")
    restarts0 = pt_telemetry.counter_get("router.replica_restarts")
    cluster = pt_cluster.ClusterController(
        "", decode_model_dir=lm_dir, role_counts={"decode": 2},
        replica_env=env, device="cpu").start(ready_timeout_s=120)
    try:
        result = {}
        client = threading.Thread(target=lambda: result.update(
            _generate(cluster.url, dict(SAMPLED, request_id="s-cpu"))))
        client.start()
        victim = None
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            rec = cluster.router.sessions.get("s-cpu")
            if rec and len(rec["accepted"]) >= 3:
                handle = cluster.router.pick_generate(PROMPT)
                victim = cluster.replica_named(handle.name)
                victim.kill(signal.SIGKILL)
                break
            time.sleep(0.01)
        assert victim is not None, "the session journal never moved"
        client.join(timeout=120)
        assert not client.is_alive() and result, "client never completed"
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            members = cluster.tier_members("decode")
            if victim not in members and all(r.alive() for r in members):
                break
            time.sleep(0.1)
        members = cluster.tier_members("decode")
    finally:
        cluster.close()
    assert result["tokens"] == reference_ids[1]
    assert result.get("failed_over") is True and result.get("resumed")
    assert pt_telemetry.counter_get("session.failovers") - failovers0 >= 1
    assert victim not in members and len(members) == 2
    assert {r.role for r in members} == {"decode"}
    assert pt_telemetry.counter_get("router.replica_restarts") - \
        restarts0 == 1


def test_replica_refuses_what_is_not_ported(lm_dir, tmp_path):
    # --telemetry-log is ported: the replica points its run-log sink at
    # the path before it loads the model (here a dir that holds none)
    log = tmp_path / "replica.jsonl"
    try:
        with pytest.raises(FileNotFoundError, match="__model__.json"):
            pt_replica.main(["--model-dir", lm_dir, "--device", "cpu",
                             "--telemetry-log", str(log)])
        assert pt_telemetry.enabled()
        pt_telemetry.counter_add("replica.log_probe", 1, probe=True)
        pt_telemetry.flush_sink()
        recs = [json.loads(line) for line in log.read_text().splitlines()]
        assert recs[-1]["name"] == "replica.log_probe"
        assert recs[-1]["attrs"] == {"delta": 1, "probe": True}
    finally:
        pt_telemetry.configure(None)
    with pytest.raises(FileNotFoundError, match="__model__.json"):
        pt_replica.main(["--model-dir", lm_dir, "--device", "cpu"])
    with pytest.raises(ValueError, match="models root"):
        pt_cluster.ClusterController("")

