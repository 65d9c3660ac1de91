"""The port's generative HTTP surface (paddle_tpu_torch/serving/server.py)
held against paddle_tpu's on the same servable dir.

Both packages serve one model dir, written once by the reference's
``save_decoder_lm`` with the reference's tiny decoder LM
(``tests/test_orchestrator.py`` ``CFG_KW``: vocab 97, d_model 32, 2
heads, 2 layers, d_inner 64, max_seq_len 64, seed 0); the JAX side runs
its stock CPU route (``PT_PALLAS=off``), the port ``device="cpu"``.

* One request script over real sockets to both ``serve_decode``s:
  greedy, sampled (seed), a deadline that has passed, a request whose KV
  pages can never fit (429 ``KVCacheExhaustedError``), malformed JSON
  (400), and after the engine closed (503, and ``/healthz`` 503
  ``stopped``): equal status codes, ``error_type``s, token ids and JSON
  keys (timing values are not compared).
* ``model_version``: both engines built from the dir with ``version=3``
  report it in ``stats()``.
* ``/metrics``: the counters both packages serve have the same metric
  names.
* Interop: the port's decode engine with ``prefill_urls`` pointing at the
  JAX server installs the shipments it fetches (``disagg.installs``) and
  gives the ids of its own local prefill; a dead prefill URL falls back
  to a local prefill (``disagg.fallback_prefills``).
* ROADMAP A5b's micro-batching surface, ported since: ``serve()`` over
  a decoder-LM dir (not an inference model) raises, ``ServingHTTPServer``
  needs an engine, and a decode-only server answers ``/v1/infer`` and
  ``/v1/admin/swap`` 404 as the reference's does with no ServingEngine
  (``tests/test_torch_serving_engine.py`` holds the surface itself).
* The new modules import neither jax nor paddle_tpu.

Every server binds port 0 and is shut down in a ``finally``; every socket
wait carries its own timeout.
"""

import json
import os
import socket
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu.core import telemetry as jax_telemetry
from paddle_tpu.models import decoder_lm as jax_lm
from paddle_tpu.serving import decode as jax_decode
from paddle_tpu.serving import server as jax_server

from paddle_tpu_torch.core import telemetry as pt_telemetry
from paddle_tpu_torch.serving import decode as pt_decode
from paddle_tpu_torch.serving import server as pt_server

from tests.test_orchestrator import CFG_KW

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
# 7 usable pages of 8 tokens: a request of more than 56 tokens in all can
# never fit (the model's max_seq_len is 64)
CONF = dict(kv_pages=8, page_size=8, max_new_tokens=8)
PROMPT = [int(t) for t in np.random.RandomState(3).randint(3, 96, 6)]
PROMPT2 = [int(t) for t in np.random.RandomState(4).randint(3, 96, 21)]

SCRIPT = [
    ("greedy", {"prompt_ids": PROMPT, "max_new_tokens": 8}),
    ("greedy_long", {"prompt_ids": PROMPT2, "max_new_tokens": 8,
                     "stop_at_eos": False}),
    ("sampled", {"prompt_ids": PROMPT2, "max_new_tokens": 8,
                 "temperature": 0.8, "seed": 11, "stop_at_eos": False}),
    ("named", {"prompt_ids": PROMPT, "max_new_tokens": 4,
               "request_id": "req-1"}),
    ("deadline", {"prompt_ids": PROMPT, "max_new_tokens": 8,
                  "deadline_ms": 1e-3}),
    ("never_fits", {"prompt_ids": (PROMPT2 * 3)[:50], "max_new_tokens": 8}),
    ("over_max_seq_len", {"prompt_ids": PROMPT2 * 3, "max_new_tokens": 8}),
    ("no_prompt", {"max_new_tokens": 8}),
]


@pytest.fixture(scope="module")
def lm_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("http_lm")
    cfg = jax_lm.DecoderLMConfig(**CFG_KW)
    jax_lm.save_decoder_lm(str(d), cfg, jax_lm.decoder_lm_params(cfg, 0))
    return str(d)


@pytest.fixture(scope="module")
def jax_pallas_off():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PT_PALLAS", "off")
        yield


def _post(url, path, body, headers=None, timeout=60):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(
        url + path, data=data,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url, path, timeout=30):
    try:
        with urllib.request.urlopen(url + path, timeout=timeout) as resp:
            raw = resp.read()
            code = resp.status
    except urllib.error.HTTPError as e:
        raw, code = e.read(), e.code
    try:
        return code, json.loads(raw)
    except ValueError:
        return code, raw.decode()


def _run_script(server):
    out = {}
    for name, body in SCRIPT:
        out[name] = _post(server.url, "/v1/generate", body)
    out["malformed"] = _post(server.url, "/v1/generate", b"{not json")
    out["infer"] = _post(server.url, "/v1/infer", {"inputs": {}})
    out["healthz_up"] = _get(server.url, "/healthz")
    out["livez_up"] = _get(server.url, "/livez")
    server.decode_engine.close(drain=True, timeout=30)
    out["after_close"] = _post(server.url, "/v1/generate", SCRIPT[0][1])
    out["healthz_closed"] = _get(server.url, "/healthz")
    out["livez_closed"] = _get(server.url, "/livez")
    return out


@pytest.fixture(scope="module")
def scripts(lm_dir, jax_pallas_off):
    """The request script through both packages' serve_decode, and each
    package's /metrics text after it."""
    results = {}
    jsrv = jax_server.serve_decode(lm_dir,
                                   config=jax_decode.DecodeConfig(**CONF))
    try:
        results["jax"] = _run_script(jsrv)
        results["jax_metrics"] = _get(jsrv.url, "/metrics")[1]
    finally:
        jsrv.decode_engine.close(drain=False, timeout=10)
        jsrv.shutdown()
    # the port's /metrics after this script alone: counters an earlier
    # test file left in this worker's registry (a prefix-cache engine's
    # decode.prefill_chunks) are not this engine's
    pt_telemetry.reset()
    psrv = pt_server.serve_decode(lm_dir,
                                  config=pt_decode.DecodeConfig(**CONF),
                                  device="cpu")
    try:
        results["pt"] = _run_script(psrv)
        results["pt_metrics"] = _get(psrv.url, "/metrics")[1]
    finally:
        psrv.decode_engine.close(drain=False, timeout=10)
        psrv.shutdown()
    return results


def _shape(doc):
    """A response's JSON keys with every timing value dropped."""
    return sorted(doc) if isinstance(doc, dict) else doc


@pytest.mark.parametrize("name", [n for n, _ in SCRIPT]
                         + ["malformed", "infer", "after_close"])
def test_request_script_matches_reference(scripts, name):
    jcode, jdoc = scripts["jax"][name]
    pcode, pdoc = scripts["pt"][name]
    assert pcode == jcode, (name, pdoc, jdoc)
    assert _shape(pdoc) == _shape(jdoc), (name, pdoc, jdoc)
    assert pdoc.get("error_type") == jdoc.get("error_type")
    if jcode == 200:
        assert pdoc["tokens"] == jdoc["tokens"]
        assert pdoc["num_tokens"] == len(pdoc["tokens"])
        assert pdoc["model_version"] == jdoc["model_version"] == 0
        assert pdoc.get("request_id") == jdoc.get("request_id")


def test_script_codes(scripts):
    """The codes the script is built to reach, so a package that answered
    everything with one code would not pass by agreeing."""
    codes = {n: scripts["pt"][n][0] for n in scripts["pt"]}
    assert codes["greedy"] == codes["sampled"] == codes["named"] == 200
    assert codes["deadline"] == 504
    assert codes["never_fits"] == 429
    assert scripts["pt"]["never_fits"][1]["error_type"] == \
        "KVCacheExhaustedError"
    assert codes["over_max_seq_len"] == codes["no_prompt"] == 400
    assert codes["malformed"] == 400
    assert codes["infer"] == 404
    assert codes["after_close"] == 503


@pytest.mark.parametrize("probe", ["healthz_up", "livez_up",
                                   "healthz_closed", "livez_closed"])
def test_health_endpoints_match_reference(scripts, probe):
    jcode, jdoc = scripts["jax"][probe]
    pcode, pdoc = scripts["pt"][probe]
    assert pcode == jcode
    assert pdoc["status"] == jdoc["status"]
    assert _shape(pdoc) == _shape(jdoc)
    if probe == "healthz_up":
        assert (pcode, pdoc["status"], pdoc["ready"]) == (200, "ok", True)
    if probe == "healthz_closed":
        assert pcode == 503 and pdoc["status"] in ("draining", "stopped")


def _counter_metric_names(text):
    return {ln.split()[0] for ln in text.splitlines()
            if ln and not ln.startswith("#") and ln.split()[0]
            .endswith("_total")}


def test_metrics_names_match_reference(scripts):
    """Both /metrics carry the decode counters under the reference's
    names; every decode counter the port serves, but for its own two, the
    reference serves under the same name."""
    jnames = _counter_metric_names(scripts["jax_metrics"])
    pnames = _counter_metric_names(scripts["pt_metrics"])
    core = {f"pt_decode_{n}_total" for n in (
        "requests", "prefills", "prefill_tokens", "steps", "tokens",
        "retired", "deadline_expired", "kv_pages_allocated",
        "kv_pages_freed")}
    assert core <= pnames and core <= jnames
    # the port's own two: it builds op-desc programs and captures each as
    # a CUDA graph where the reference jits
    own = {"pt_decode_graph_captures_total", "pt_decode_program_builds_total"}
    pt_decode_names = {n for n in pnames if n.startswith("pt_decode_")}
    assert pt_decode_names - own <= jnames
    assert "# TYPE pt_decode_step_ms summary" in scripts["pt_metrics"]
    assert 'pt_decode_step_ms_bucket{le="+Inf"}' in scripts["pt_metrics"]


def test_version_in_stats(lm_dir, jax_pallas_off):
    jeng = jax_decode.decode_engine_from_dir(lm_dir, version=3)
    peng = pt_decode.decode_engine_from_dir(lm_dir, version=3, device="cpu")
    assert jeng.version == peng.version == 3
    assert jeng.stats()["model_version"] == 3
    assert peng.stats()["model_version"] == 3


def _ids(engine, prompts):
    engine.start(warmup=False)
    try:
        return [engine.generate(p, timeout=60, max_new_tokens=6,
                                stop_at_eos=False).tolist()
                for p in prompts]
    finally:
        engine.close(drain=True, timeout=30)


def _dead_url():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"http://127.0.0.1:{s.getsockname()[1]}"


def test_decode_engine_installs_jax_shipments(lm_dir, jax_pallas_off):
    """The wire format crosses the packages: the port's decode-role engine
    fetches each prompt's prefill from a JAX prefill server and its ids
    equal the port's local prefill; a dead prefill URL falls back to a
    local prefill, counted."""
    prompts = [PROMPT, PROMPT2, PROMPT2[:9]]
    local = _ids(pt_decode.decode_engine_from_dir(lm_dir, device="cpu"),
                 prompts)
    jsrv = jax_server.serve_decode(lm_dir, config=jax_decode.DecodeConfig(
        role="prefill"))
    try:
        ships0 = jax_telemetry.counter_get("disagg.ships")
        installs0 = pt_telemetry.counter_get("disagg.installs")
        fallbacks0 = pt_telemetry.counter_get("disagg.fallback_prefills")
        shipped = _ids(pt_decode.decode_engine_from_dir(
            lm_dir, device="cpu", config=pt_decode.DecodeConfig(
                role="decode", prefill_urls=jsrv.url)), prompts)
        assert jax_telemetry.counter_get("disagg.ships") - ships0 == 3
        assert pt_telemetry.counter_get("disagg.installs") - installs0 == 3
        assert pt_telemetry.counter_get("disagg.fallback_prefills") == \
            fallbacks0
    finally:
        jsrv.decode_engine.close(drain=False, timeout=10)
        jsrv.shutdown()
    assert shipped == local
    dead = _ids(pt_decode.decode_engine_from_dir(
        lm_dir, device="cpu", config=pt_decode.DecodeConfig(
            role="decode", prefill_urls=_dead_url())), prompts)
    assert dead == local
    assert pt_telemetry.counter_get("disagg.fallback_prefills") - \
        fallbacks0 == 3


def test_micro_batching_surface_names_a5b(lm_dir):
    """A5b's surface is ported: a decoder-LM servable dir is no inference
    model, a server needs an engine, and a server with only a decode
    engine answers the micro-batching routes 404."""
    with pytest.raises(FileNotFoundError, match="__model__.json"):
        pt_server.serve(lm_dir, device="cpu")
    with pytest.raises(ValueError, match="needs an engine"):
        pt_server.ServingHTTPServer(None)
    srv = pt_server.serve_decode(lm_dir, device="cpu", warmup=False)
    try:
        for path in ("/v1/infer", "/v1/admin/swap"):
            req = urllib.request.Request(
                srv.url + path, data=b"{}",
                headers={"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=30)
            assert ei.value.code == 404
            assert "no micro-batching engine" in \
                json.loads(ei.value.read())["error"]
    finally:
        srv.shutdown()
        srv.decode_engine.close(drain=False, timeout=30)


def test_new_modules_load_neither_jax_nor_paddle_tpu():
    mods = ["paddle_tpu_torch.core.retry", "paddle_tpu_torch.core.faults",
            "paddle_tpu_torch.core.trace", "paddle_tpu_torch.core.telemetry",
            "paddle_tpu_torch.serving.health",
            "paddle_tpu_torch.serving.admission",
            "paddle_tpu_torch.serving.decode",
            "paddle_tpu_torch.serving.disagg",
            "paddle_tpu_torch.serving.server",
            "paddle_tpu_torch.serving.router",
            "paddle_tpu_torch.serving.replica",
            "paddle_tpu_torch.serving.cluster",
            "paddle_tpu_torch.serving.engine",
            "paddle_tpu_torch.serving",
            "paddle_tpu_torch.inference",
            "paddle_tpu_torch.io",
            "paddle_tpu_torch.checkpoint",
            "paddle_tpu_torch.core.verify",
            "paddle_tpu_torch.core.passes"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'paddle_tpu' "
            "or m.startswith('paddle_tpu.'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)
