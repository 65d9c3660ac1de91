"""Session journaling in the port held against the JAX package's
(``paddle_tpu/serving/session.py`` and ``DecodeEngine.journal_sink``), on
the CPU at the reference's prefix-store sizes (vocab 97, d_model 32, 2
heads, 2 layers; 4 slots, page 4, 28 pages).

* ``pack_rng_state`` gives the reference's list, and each package's
  ``unpack_rng_state`` restores the other's state.
* ``resume_args`` gives the reference's dict for the same record.
* The journal records the port's engine hands its sink equal the JAX
  engine's for the same request, greedy and sampled, in every field but
  ``deadline_remaining_ms`` (a wall-clock remainder).
* Resuming a sampled session from its record at 3 accepted tokens gives
  the uninterrupted ids bit for bit, with the prefix cache on (the
  resumed prompt hits the cached chain) and off.
* ``SessionJournal`` keeps the latest record per id, drops a stale one
  and evicts the oldest past its capacity, as the reference's does.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.models import decoder_lm as jax_lm
from paddle_tpu.serving import decode as jax_decode
from paddle_tpu.serving import session as jax_session

from paddle_tpu_torch.core import telemetry as pt_telemetry
from paddle_tpu_torch.models import decoder_lm as pt_lm
from paddle_tpu_torch.serving import decode as pt_decode
from paddle_tpu_torch.serving import session as pt_session

torch.set_num_threads(2)

CFG_KW = dict(vocab_size=97, d_model=32, n_head=2, n_layers=2,
              d_inner=64, max_seq_len=32)
POOL_KW = dict(max_slots=4, page_size=4, kv_pages=28,
               prefill_buckets=[8, 16])
PROMPT = np.random.RandomState(0).randint(3, 90, size=11).astype(np.int32)


def _pt_engine(**over):
    cfg = pt_lm.DecoderLMConfig(**CFG_KW)
    return pt_decode.DecodeEngine(
        cfg, pt_lm.decoder_lm_params(cfg, 0),
        pt_decode.DecodeConfig(**{**POOL_KW, **over}), device="cpu")


def _jax_engine(**over):
    return jax_decode.demo_engine(
        jax_decode.DecodeConfig(**{**POOL_KW, **over}),
        jax_lm.DecoderLMConfig(**CFG_KW))


def _journaled(engine, **kw):
    """(ids, the records the sink got) of one journaled request."""
    records = []
    engine.journal_sink = records.extend
    engine.start()
    try:
        ids = engine.generate(PROMPT, request_id="sess-1", timeout=120,
                              **kw)
    finally:
        engine.close(drain=True, timeout=30)
    return np.asarray(ids), records


def test_rng_state_packs_as_the_reference_and_round_trips():
    rng = np.random.RandomState(7)
    rng.random_sample(5)
    rng.standard_normal()          # leaves a cached gaussian
    packed = pt_session.pack_rng_state(rng)
    assert packed == jax_session.pack_rng_state(rng)
    a = pt_session.unpack_rng_state(jax_session.pack_rng_state(rng))
    b = jax_session.unpack_rng_state(pt_session.pack_rng_state(rng))
    assert a.random_sample(4).tolist() == b.random_sample(4).tolist() == \
        rng.random_sample(4).tolist()
    assert pt_session.pack_rng_state(None) is None
    assert pt_session.unpack_rng_state(None) is None


@pytest.mark.parametrize("remaining", [None, 250.0, 0.2])
def test_resume_args_is_the_reference_dict(remaining):
    rng = np.random.RandomState(3)
    rng.random_sample(2)
    record = {"request_id": "r-9", "prompt": [5, 6, 7],
              "prefix_hash": "root", "accepted": [11, 12],
              "max_new_total": 6, "temperature": 0.8, "seed": 4,
              "stop_at_eos": False,
              "rng_state": pt_session.pack_rng_state(rng),
              "deadline_remaining_ms": remaining}
    assert pt_session.resume_args(record) == jax_session.resume_args(record)


@pytest.mark.parametrize("kw", [dict(max_new_tokens=6),
                                dict(max_new_tokens=6, temperature=0.8,
                                     seed=7, stop_at_eos=False)])
def test_journal_records_equal_the_jax_engines(kw):
    got_ids, got = _journaled(_pt_engine(prefix_cache=True), **kw)
    want_ids, want = _journaled(_jax_engine(prefix_cache=True), **kw)
    np.testing.assert_array_equal(got_ids, want_ids)
    assert len(got) == len(want) == 4      # after steps 1..4 of 5
    for g, w in zip(got, want):
        assert set(g) == set(w)
        g.pop("deadline_remaining_ms")
        w.pop("deadline_remaining_ms")
        assert g == w


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_resumed_sampled_session_equals_the_uninterrupted_run(prefix_cache):
    kw = dict(max_new_tokens=7, temperature=0.8, seed=11, stop_at_eos=False)
    full, records = _journaled(_pt_engine(prefix_cache=prefix_cache), **kw)
    record = next(r for r in records if len(r["accepted"]) == 3)
    args = pt_session.resume_args(record)
    before = pt_telemetry.counter_get("session.resumed_tokens")
    eng = _pt_engine(prefix_cache=prefix_cache)
    eng.start()
    try:
        # the cached chain of the first run is gone with its engine; warm
        # this one with the same prompt first, so the resumption hits
        eng.generate(PROMPT, max_new_tokens=1, timeout=120)
        tail = eng.generate(args.pop("prompt_ids"), timeout=120, **args)
    finally:
        eng.close(drain=True, timeout=30)
    assert pt_telemetry.counter_get("session.resumed_tokens") - before == 3
    np.testing.assert_array_equal(
        np.concatenate([record["accepted"], tail]), full)


def test_session_journal_keeps_the_latest_record_as_the_reference():
    def recs(rid, n):
        return {"request_id": rid, "accepted": list(range(n))}

    journals = [pt_session.SessionJournal(capacity=2),
                jax_session.SessionJournal(capacity=2)]
    script = [[recs("a", 2)], [recs("a", 1)], [recs("b", 1), recs(None, 3)],
              [recs("a", 3)], [recs("c", 1)]]
    for batch in script:
        assert journals[0].update(batch) == journals[1].update(batch)
        assert len(journals[0]) == len(journals[1])
    for rid in ("a", "b", "c"):
        assert journals[0].get(rid) == journals[1].get(rid)
    assert journals[0].get("b") is None          # evicted past capacity 2
    assert journals[0].pop("a") == journals[1].pop("a") == recs("a", 3)
    assert pt_session.SessionJournal().capacity == 4096
