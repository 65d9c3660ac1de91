"""The port's router, retry schedule, health state machine and fault
sites (paddle_tpu_torch/serving/router.py, core/retry.py,
serving/health.py, core/faults.py) held against paddle_tpu's.

* ``RetrySchedule``: the same (outcome, delay) sequence as the reference
  on the same seeded ``random.Random``: exponential doubling, the
  ``max_delay`` cap, jitter, the budget, and deadline clipping.
* ``HealthState`` / ``ReadyGate``: the same states, readiness, liveness
  and snapshot keys through one transition script.
* ``Router.pick`` over stub handles, the reference's ``TestRouterPick``
  cases (``tests/test_cluster_serving.py``): the same picks in the same
  order; ``pick_generate``: the same replica for the same prompts, the
  same tier fallbacks.
* Over real sockets, each package's router in front of its own package's
  ``serve_decode`` replicas (the tiny decoder LM of
  ``tests/test_orchestrator.py``, JAX on ``PT_PALLAS=off``, the port on
  the CPU): dedup replays an answered request id with no new prefill;
  a shut-down replica fails over to the survivor; an armed
  ``router.dispatch`` fault is retried. Token ids and the deltas of the
  router's counters are equal in the two packages.
* The engine's fault sites (``decode.step``, ``decode.kv_alloc``,
  ``kv.prefix_lookup``, ``disagg.ship``), each armed on its first call:
  the same typed error, the same ids after it, the same counter deltas.
* A client's ``X-Request-Id`` pins one trace id on the router's root
  span, its ``router.dispatch`` child and the replica's root span.
* ``Router.attach_fleet`` raises naming ROADMAP A10.

The routers here are not started (no probe thread), so which attempt
finds a replica down does not depend on a probe's timing.
"""

import contextlib
import json
import random
import time
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu.core import faults as jax_faults
from paddle_tpu.core import retry as jax_retry
from paddle_tpu.core import telemetry as jax_telemetry
from paddle_tpu.models import decoder_lm as jax_lm
from paddle_tpu.serving import health as jax_health
from paddle_tpu.serving import router as jax_router
from paddle_tpu.serving import server as jax_server

from paddle_tpu_torch.core import faults as pt_faults
from paddle_tpu_torch.core import retry as pt_retry
from paddle_tpu_torch.core import telemetry as pt_telemetry
from paddle_tpu_torch.serving import health as pt_health
from paddle_tpu_torch.serving import router as pt_router
from paddle_tpu_torch.serving import server as pt_server

from tests.test_orchestrator import CFG_KW, PROMPT

torch.set_num_threads(2)

PKGS = {"jax": (jax_router, jax_server, jax_telemetry, jax_faults),
        "pt": (pt_router, pt_server, pt_telemetry, pt_faults)}
ROUTER_COUNTERS = ("router.requests", "router.retries",
                   "router.dispatch_errors", "router.replica_down",
                   "router.dedup_hits", "router.rejects",
                   "router.outage_waits", "router.deadline_exceeded",
                   "faults.injected", "decode.prefills", "decode.requests",
                   "session.failovers")


# ---------------------------------------------------------------------------
# core/retry.py
# ---------------------------------------------------------------------------

def _schedule_trace(mod, seed, n, **policy):
    sched = mod.RetryPolicy(**policy).start(rng=random.Random(seed))
    return [sched.note_failure() for _ in range(n)], sched.attempt


@pytest.mark.parametrize("policy", [
    dict(max_retries=5, backoff=0.1, jitter=0.0, max_delay=0.4),
    dict(max_retries=6, backoff=0.05, jitter=0.5, max_delay=1.0),
    dict(max_retries=3, backoff=1.0, jitter=0.5, max_delay=10.0),
    dict(max_retries=0, backoff=0.1),
], ids=["caps", "jitter", "wide_jitter", "no_retry"])
def test_retry_schedule_matches_reference(policy):
    for seed in range(4):
        got = _schedule_trace(pt_retry, seed, policy["max_retries"] + 2,
                              **policy)
        want = _schedule_trace(jax_retry, seed, policy["max_retries"] + 2,
                               **policy)
        assert got == want
    outcomes = [o for o, _ in got[0]]
    assert outcomes[-1] == pt_retry.EXHAUSTED
    assert outcomes[:policy["max_retries"]] == \
        [pt_retry.RETRY] * policy["max_retries"]


def test_retry_deadline_clipping_matches_reference():
    for mod in (pt_retry, jax_retry):
        sched = mod.RetryPolicy(max_retries=10, backoff=10.0, jitter=0.0,
                                max_delay=10.0, deadline=0.2).start()
        outcome, delay = sched.note_failure()
        assert outcome == mod.RETRY and 0.0 < delay <= 0.2
        gone = mod.RetryPolicy(max_retries=100, backoff=0.001,
                               deadline=0.02).start()
        time.sleep(0.03)
        assert gone.note_failure() == (mod.DEADLINE, 0.0)
        assert gone.expired()
        assert mod.RetryPolicy(deadline=None).start().remaining(
            default=7.5) == 7.5


# ---------------------------------------------------------------------------
# serving/health.py
# ---------------------------------------------------------------------------

def _health_trace(mod):
    h = mod.HealthState()
    rows = [(h.state, h.is_ready(), h.is_alive(), sorted(h.snapshot(
        queue_depth=0, model_version=0)))]
    for state in (mod.READY, mod.SWAPPING, mod.READY, mod.DRAINING,
                  mod.STOPPED):
        h.set(state)
        rows.append((h.state, h.is_ready(), h.is_alive()))
    gate = mod.HealthState(mod.READY)
    with mod.ReadyGate(gate, mod.SWAPPING):
        rows.append(gate.state)
    rows.append(gate.state)
    gate.set(mod.DRAINING)
    with mod.ReadyGate(gate, mod.SWAPPING):
        pass
    rows.append(gate.state)   # a failed swap must not resurrect
    return rows


def test_health_transitions_match_reference():
    got, want = _health_trace(pt_health), _health_trace(jax_health)
    assert got == want
    assert got[-1] == pt_health.DRAINING and got[-2] == pt_health.READY


# ---------------------------------------------------------------------------
# Router.pick / pick_generate over stub handles
# ---------------------------------------------------------------------------

def _router_with(mod, states, roles=None):
    """states: list of (ready, queue_depth[, status])."""
    router = mod.Router()
    for i, st in enumerate(states):
        handle = mod.ReplicaHandle(f"r{i}", f"http://127.0.0.1:{40000 + i}",
                                   role=(roles or {}).get(i, "unified"))
        handle.ready = st[0]
        handle.queue_depth = st[1]
        if len(st) > 2:
            handle.status = st[2]
        router._handles.append(handle)
    return router


def _picks(router, n, inflight=None, exclude_first=False):
    if inflight:
        for i, v in inflight.items():
            router._handles[i].inflight = v
    out = []
    for _ in range(n):
        first = router.pick()
        out.append(first.name if first else None)
        if exclude_first and first is not None:
            other = router.pick(exclude={first})
            out.append(other.name if other else None)
    return out


PICK_CASES = {
    "lowest_queue_depth": ([(True, 5), (True, 1), (True, 9)], {}),
    "skips_not_ready": ([(False, 0), (True, 7)], {}),
    "inflight_counts": ([(True, 2), (True, 2)], {"inflight": {0: 5}}),
    "round_robin_ties": ([(True, 0), (True, 0), (True, 0)], {}),
    "ready_beats_swapping": ([(False, 0, "swapping"), (True, 50)], {}),
    "swapping_fallback": ([(False, 0, "swapping"), (False, 0, "down")], {}),
    "nothing_routable": ([(False, 0, "down"), (False, 0, "down")], {}),
    "exclude": ([(True, 0), (True, 5)], {"exclude_first": True}),
}


@pytest.mark.parametrize("case", sorted(PICK_CASES))
def test_pick_matches_reference(case):
    states, kw = PICK_CASES[case]
    got = _picks(_router_with(pt_router, states), 9, **kw)
    want = _picks(_router_with(jax_router, states), 9, **kw)
    assert got == want
    if case == "round_robin_ties":
        assert set(got) == {"r0", "r1", "r2"}
    if case == "nothing_routable":
        assert got == [None] * 9


def _affinity(mod, prompts, roles, ready):
    router = _router_with(mod, [(r, 0) for r in ready],
                          dict(enumerate(roles)))
    return [getattr(router.pick_generate(p), "name", None) for p in prompts]


@pytest.mark.parametrize("layout", ["decode_tier", "unified_only",
                                    "decode_down", "prefill_only"])
def test_pick_generate_affinity_matches_reference(layout):
    roles, ready = {
        "decode_tier": (["decode", "decode", "decode", "prefill"],
                        [True] * 4),
        "unified_only": (["unified", "unified"], [True, True]),
        "decode_down": (["decode", "unified", "prefill"],
                        [False, True, True]),
        "prefill_only": (["prefill"], [True]),
    }[layout]
    rng = np.random.RandomState(0)
    system = [int(t) for t in rng.randint(3, 96, 40)]
    prompts = [[int(t) for t in rng.randint(3, 96, n)]
               for n in (3, 9, 17, 33, 64)]
    prompts += [system + [int(t) for t in rng.randint(3, 96, n)]
                for n in (1, 5, 7)]
    got = _affinity(pt_router, prompts, roles, ready)
    want = _affinity(jax_router, prompts, roles, ready)
    assert got == want
    if layout == "decode_tier":
        # the three prompts of 41-47 tokens share their full pages (the
        # first 32 tokens, two pages of 16): one replica
        assert len(set(got[-3:])) == 1
    if layout == "prefill_only":
        assert got == [None] * len(prompts)


def test_attach_fleet_names_a10():
    with pytest.raises(NotImplementedError, match="A10"):
        pt_router.Router().attach_fleet(object())


# ---------------------------------------------------------------------------
# over real sockets: dedup, failover, the router.dispatch fault site
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("router_lm")
    cfg = jax_lm.DecoderLMConfig(**CFG_KW)
    jax_lm.save_decoder_lm(str(d), cfg, jax_lm.decoder_lm_params(cfg, 0))
    return str(d)


@pytest.fixture(scope="module", autouse=True)
def jax_pallas_off():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PT_PALLAS", "off")
        yield


@contextlib.contextmanager
def _fleet(pkg, lm_dir, n):
    """A router (not started) over n of the package's serve_decode
    replicas, all shut down on exit."""
    rmod, smod = PKGS[pkg][:2]
    kw = {"device": "cpu"} if pkg == "pt" else {}
    servers = []
    try:
        for _ in range(n):
            servers.append(smod.serve_decode(lm_dir, **kw))
        router = rmod.Router()
        for i, s in enumerate(servers):
            router.add_replica(f"replica-{i}", s.url)
        yield router, servers
    finally:
        for s in servers:
            s.decode_engine.close(drain=False, timeout=10)
            s.shutdown()


def _counters(pkg):
    tel = PKGS[pkg][2]
    return {k: tel.counter_get(k) for k in ROUTER_COUNTERS}


def _delta(before, after):
    return {k: after[k] - before[k] for k in before}


BODY = dict(max_new_tokens=8, temperature=0.8, seed=11)


def _dedup_script(pkg, lm_dir):
    with _fleet(pkg, lm_dir, 1) as (router, _):
        first = router.route_generate(PROMPT, request_id="dedup-1", **BODY)
        c0 = _counters(pkg)
        second = router.route_generate(PROMPT, request_id="dedup-1", **BODY)
        return first, second, _delta(c0, _counters(pkg))


def test_dedup_replays_without_generating(lm_dir):
    out = {pkg: _dedup_script(pkg, lm_dir) for pkg in PKGS}
    (pf, ps, pd), (jf, js, jd) = out["pt"], out["jax"]
    assert pf[0] == ps[0] == 200
    assert ps[1]["deduped"] is True
    assert ps[1]["tokens"] == pf[1]["tokens"] == jf[1]["tokens"]
    assert sorted(ps[1]) == sorted(js[1])
    assert pd == jd
    assert pd["router.dedup_hits"] == 1 and pd["decode.prefills"] == 0


def _failover_script(pkg, lm_dir):
    with _fleet(pkg, lm_dir, 2) as (router, servers):
        code0, ok = router.route_generate(PROMPT, **BODY)
        victim = router.pick_generate(PROMPT)
        i = int(victim.name.rsplit("-", 1)[1])
        servers[i].decode_engine.close(drain=False, timeout=10)
        servers[i].shutdown()
        c0 = _counters(pkg)
        code, moved = router.route_generate(PROMPT, **BODY)
        return (code0, ok, victim.name, code, moved,
                _delta(c0, _counters(pkg)))


def test_failover_after_replica_shutdown(lm_dir):
    got = _failover_script("pt", lm_dir)
    want = _failover_script("jax", lm_dir)
    code0, ok, victim, code, moved, delta = got
    assert code0 == code == 200
    assert moved["replica"] != victim == ok["replica"]
    assert moved["tokens"] == ok["tokens"] == want[1]["tokens"]
    assert (victim, moved["replica"]) == (want[2], want[4]["replica"])
    assert delta == want[5]
    assert delta["router.retries"] == 1 and delta["router.replica_down"] == 1


def _fault_script(pkg, lm_dir):
    faults = PKGS[pkg][3]
    with _fleet(pkg, lm_dir, 1) as (router, _):
        c0 = _counters(pkg)
        faults.configure("router.dispatch:@1")
        try:
            code, doc = router.route_generate(PROMPT, **BODY)
        finally:
            faults.configure(None)
        return code, doc, _delta(c0, _counters(pkg))


def test_router_dispatch_fault_retried(lm_dir):
    code, doc, delta = _fault_script("pt", lm_dir)
    jcode, jdoc, jdelta = _fault_script("jax", lm_dir)
    assert code == jcode == 200
    assert doc["tokens"] == jdoc["tokens"]
    assert delta == jdelta
    assert delta["faults.injected"] == 1 and delta["router.retries"] == 1


def test_router_http_front_end(lm_dir):
    """The port's RouterHTTPServer: /v1/generate through the router,
    /healthz, a journal batch and /v1/stats."""
    with _fleet("pt", lm_dir, 1) as (router, _):
        front = pt_router.RouterHTTPServer(router).start()
        try:
            req = urllib.request.Request(
                front.url + "/v1/generate",
                data=json.dumps(dict(prompt_ids=PROMPT, **BODY)).encode(),
                headers={"Content-Type": "application/json",
                         "X-Request-Id": "front-1"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                doc = json.loads(resp.read())
            assert doc["request_id"] == "front-1"
            assert doc["replica"] == "replica-0"
            jreq = urllib.request.Request(
                front.url + "/v1/session/journal",
                data=json.dumps({"records": [{
                    "request_id": "j-1", "prompt": PROMPT,
                    "accepted": [5]}]}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(jreq, timeout=30) as resp:
                assert json.loads(resp.read()) == {"journaled": 1}
            assert router.sessions.get("j-1")["accepted"] == [5]
            with urllib.request.urlopen(front.url + "/healthz",
                                        timeout=30) as resp:
                assert json.loads(resp.read())["status"] == "ok"
            with urllib.request.urlopen(front.url + "/v1/stats",
                                        timeout=30) as resp:
                stats = json.loads(resp.read())
            assert stats["ready"] is True
            assert stats["replicas"][0]["name"] == "replica-0"
        finally:
            front.shutdown()


# ---------------------------------------------------------------------------
# the engine's fault sites, and the trace id across the router hop
# ---------------------------------------------------------------------------

ENGINE_SITES = ("decode.step", "decode.kv_alloc", "kv.prefix_lookup",
                "disagg.ship")


def _site_script(pkg, lm_dir):
    """Each engine fault site armed on its first call in turn: the failed
    request's error and the ids of the request after it, with the
    deltas of faults.injected and decode.errors."""
    from paddle_tpu.serving import decode as jax_decode
    from paddle_tpu_torch.serving import decode as pt_decode

    mod = pt_decode if pkg == "pt" else jax_decode
    tel, faults = PKGS[pkg][2], PKGS[pkg][3]
    kw = {"device": "cpu"} if pkg == "pt" else {}
    eng = mod.decode_engine_from_dir(
        lm_dir, config=mod.DecodeConfig(prefix_cache=True), **kw)
    eng.start(warmup=False)
    out = {}
    try:
        for site in ENGINE_SITES:
            c0 = {k: tel.counter_get(k)
                  for k in ("faults.injected", "decode.errors")}
            faults.configure(f"{site}:@1")
            try:
                if site == "disagg.ship":
                    first = eng.submit_prefill(PROMPT)
                else:
                    first = eng.submit(PROMPT, max_new_tokens=6)
                try:
                    first.result(60)
                    error = None
                except Exception as e:
                    error = (type(e).__name__, str(e).split(":")[0])
                after = eng.generate(PROMPT, timeout=60, max_new_tokens=6)
            finally:
                faults.configure(None)
            out[site] = (error, [int(t) for t in after],
                         {k: tel.counter_get(k) - v for k, v in c0.items()})
    finally:
        eng.close(drain=True, timeout=30)
    return out


def test_engine_fault_sites_match_reference(lm_dir):
    got = _site_script("pt", lm_dir)
    want = _site_script("jax", lm_dir)
    assert got == want
    for site in ENGINE_SITES:
        error, ids, delta = got[site]
        assert error is not None and error[0] == "ServingError", site
        assert delta["faults.injected"] == 1, site


def test_request_id_pins_one_trace_across_the_hop(lm_dir):
    """A client's X-Request-Id pins the router's root span and, forwarded,
    the replica's: both, and each router.dispatch child, carry it."""
    with _fleet("pt", lm_dir, 1) as (router, _):
        front = pt_router.RouterHTTPServer(router).start()
        try:
            req = urllib.request.Request(
                front.url + "/v1/generate",
                data=json.dumps(dict(prompt_ids=PROMPT, **BODY)).encode(),
                headers={"Content-Type": "application/json",
                         "X-Request-Id": "trace-me-1"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert resp.headers["X-Trace-Id"] == "trace-me-1"
                resp.read()
        finally:
            front.shutdown()
    spans = [e for e in pt_telemetry.recent_events("span")
             if e["attrs"]["trace"] == "trace-me-1"]
    names = sorted(e["name"] for e in spans)
    assert names == ["router.dispatch", "router.request",
                     "serving.http_request"]
    by = {e["name"]: e["attrs"] for e in spans}
    assert by["router.dispatch"]["parent"] == by["router.request"]["span"]
    assert by["router.request"]["parent"] is None
