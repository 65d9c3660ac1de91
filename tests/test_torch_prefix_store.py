"""The port's prefix-sharing serving path held against the JAX package's
(``paddle_tpu/serving/prefix_store.py``, ``disagg.py``, ``session.py``,
the chunked prefill of ``serving/decode.py`` and
``models/decoder_lm.build_chunk_prefill_program``), on the CPU at the
reference's own sizes (``tests/test_prefix_store.py``: vocab 97, d_model
32, 2 heads, 2 layers; 4 slots, page 4, 28 pages, prefill buckets 8 and
16). Requests run one at a time: batched runs are not bitwise stable in
the reference here (``tests/test_serving.py::TestBatchedEquivalence``).

* ``prefix_chain_hash`` gives the reference's string for the same tokens.
* Both packages' ``PrefixStore`` driven through the same calls (the
  cases of the reference's ``TestStoreUnit`` and ``TestPoolAudit``: the
  final-chunk cap, a partial hit, a COW fork, a duplicate insert, the
  release guards, LRU leaf-first reclaim, a tampered ledger) return the
  same hashes, pages, refcounts, audit messages and counter deltas.
* The chunk program's JSON equals the reference's; it reads only
  parameters of ``decoder_lm_params`` (fp32 and int8), so the weights
  carry across through ``params_from_numpy`` unchanged.
* ``chunk_cached_attention`` against the reference's lowering on the
  same numpy inputs, with ChunkStart > 0 and a short final chunk: Out
  within rtol = atol = 1e-5, PoolKOut and PoolVOut bit for bit.
* Engines, greedy: the port's prefix engine (cold, then a hit) gives the
  ids of the port's classic engine, the JAX prefix engine and the JAX
  classic engine, fp32 and int8. A sampled hit equals a sampled cold
  run bit for bit; an int8 hit equals the int8 classic run.
* Reclaim under pressure seats every request and leaves a clean audit.
* Shipments: equal bytes from both packages for the same inputs, each
  unpacks the other's, a flipped payload byte raises ShipmentCRCError,
  and ``submit_prefill`` frees its pages and ships the JAX engine's
  logits within 1e-5.

Session journaling is in ``test_torch_session.py``.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu.core import registry as jax_registry
from paddle_tpu.core import telemetry as jax_telemetry
from paddle_tpu.core import unique_name as jax_names
from paddle_tpu.models import decoder_lm as jax_lm
from paddle_tpu.serving import decode as jax_decode
from paddle_tpu.serving import disagg as jax_disagg
from paddle_tpu.serving import kv_cache as jax_kv
from paddle_tpu.serving import prefix_store as jax_ps

from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.core import telemetry as pt_telemetry
from paddle_tpu_torch.core import unique_name as pt_names
from paddle_tpu_torch.models import decoder_lm as pt_lm
from paddle_tpu_torch.serving import decode as pt_decode
from paddle_tpu_torch.serving import disagg as pt_disagg
from paddle_tpu_torch.serving import kv_cache as pt_kv
from paddle_tpu_torch.serving import prefix_store as pt_ps

torch.set_num_threads(2)

CFG_KW = dict(vocab_size=97, d_model=32, n_head=2, n_layers=2,
              d_inner=64, max_seq_len=32)
POOL_KW = dict(max_slots=4, page_size=4, kv_pages=28,
               prefill_buckets=[8, 16])
COUNTERS = ("kv.prefix_hits", "kv.prefix_misses", "kv.bytes_saved",
            "kv.cow_forks", "kv.reclaims", "kv.audit_failures")


def _prompts():
    """Two prompts sharing a 9-token prefix (2 full pages at P = 4), as
    the reference's ``prompts`` fixture makes them."""
    rng = np.random.RandomState(0)
    prefix = rng.randint(3, 90, size=9)
    p1 = np.concatenate([prefix, rng.randint(3, 90, size=3)]).astype(np.int32)
    p2 = np.concatenate([prefix, rng.randint(3, 90, size=2)]).astype(np.int32)
    return p1, p2


# ---------------------------------------------------------------------------
# the store: one script of calls through both packages
# ---------------------------------------------------------------------------

class _Both:
    """The same PrefixStore call on both packages' stores (16 pages of 4
    tokens, 2 layers, kv_dim 8), each call's results and every counter's
    delta compared."""

    def __init__(self):
        self.stores = [
            jax_ps.PrefixStore(jax_kv.KVPagePool(n_layers=2, num_pages=16,
                                                 page_size=4, kv_dim=8)),
            pt_ps.PrefixStore(pt_kv.KVPagePool(n_layers=2, num_pages=16,
                                               page_size=4, kv_dim=8))]

    @staticmethod
    def _counts():
        return [{n: int(jax_telemetry.counter_get(n)) for n in COUNTERS},
                {n: int(pt_telemetry.counter_get(n)) for n in COUNTERS}]

    def call(self, what, *args, **kw):
        before = self._counts()
        outs = []
        for store in self.stores:
            obj = store.pool if what.startswith("pool.") else store
            try:
                outs.append(("ok", getattr(obj, what.split(".")[-1])(
                    *args, **kw)))
            except AssertionError as e:
                outs.append(("raise", str(e)))
        after = self._counts()
        deltas = [{n: a[n] - b[n] for n in COUNTERS}
                  for a, b in zip(after, before)]
        assert outs[0] == outs[1], (what, outs)
        assert deltas[0] == deltas[1], (what, deltas)
        refs = [{h: b.refs for h, b in s._blocks.items()}
                for s in self.stores]
        assert refs[0] == refs[1]
        assert [s.stats() for s in self.stores][0] == \
            [s.stats() for s in self.stores][1]
        assert self.stores[0].pool.free_pages() == \
            self.stores[1].pool.free_pages()
        return outs[0][1]


def test_prefix_chain_hash_is_the_reference_string():
    rng = np.random.RandomState(4)
    for n, page in ((11, 4), (3, 4), (64, 16), (1029, 16)):
        toks = rng.randint(0, 32000, n).tolist()
        assert pt_ps.prefix_chain_hash(toks, page) == \
            jax_ps.prefix_chain_hash(toks, page)
    assert pt_ps._chain_hash("root", [1, 2, 3, 4]) == \
        jax_ps._chain_hash("root", [1, 2, 3, 4])
    assert pt_ps.ROOT_HASH == jax_ps.ROOT_HASH


def test_store_miss_insert_hit_and_final_chunk_cap():
    s = _Both()
    toks = list(range(10, 20))        # 10 tokens -> 2 full pages
    assert s.call("lookup", toks) == ([], [])
    alloc = s.call("pool.try_alloc", 2)
    held, canon = s.call("insert", toks, alloc)
    assert len(held) == 2 and canon == alloc
    s.call("release", held)
    hashes, pages = s.call("lookup", toks)
    assert len(hashes) == 2 and pages == alloc
    s.call("release", hashes)
    # an exactly-two-page prompt matches only one block
    hashes, _ = s.call("lookup", toks[:8])
    assert len(hashes) == 1
    s.call("release", hashes)


def test_store_partial_hit_cow_fork_and_duplicate_insert():
    s = _Both()
    a = [1, 2, 3, 4, 10, 11, 12, 13, 0]
    b = [1, 2, 3, 4, 20, 21, 22, 23, 0]
    pa = s.call("pool.try_alloc", 2)
    held_a, _ = s.call("insert", a, pa)
    hashes, shared = s.call("lookup", b)          # partial hit: block 0
    assert shared == [pa[0]]
    pb1 = s.call("pool.try_alloc", 1)
    held_b, canon = s.call("insert", b, [shared[0], pb1[0]], start_block=1)
    assert canon == pb1                           # a COW fork
    assert s.call("lookup", a)[1] == pa
    assert s.call("lookup", b)[1] == [pa[0], pb1[0]]
    # a duplicate insert: the resident blocks win, the candidates go back
    dup = s.call("pool.try_alloc", 2)
    held_d, canon_d = s.call("insert", a, dup)
    assert canon_d == pa
    for held in (held_a, hashes, held_b, held_d):
        s.call("release", held)


def test_store_release_guards():
    s = _Both()
    held, _ = s.call("insert", [1, 2, 3, 4, 0], s.call("pool.try_alloc", 1))
    s.call("release", ["deadbeef"])               # raises in both
    s.call("release", held)
    s.call("release", held)                       # double release raises


def test_store_reclaim_lru_leaf_first_and_refcount_protected():
    s = _Both()
    a = [1, 2, 3, 4, 5, 6, 7, 8, 0]
    held_a, _ = s.call("insert", a, s.call("pool.try_alloc", 2))
    b = [9, 9, 9, 9, 0]
    held_b, _ = s.call("insert", b, s.call("pool.try_alloc", 1))
    s.call("release", held_a)
    assert s.call("reclaim", 2) == 2              # A's chain, leaf first
    assert s.call("lookup", a) == ([], [])
    assert s.call("lookup", b)[0] == held_b
    s.call("release", held_b)
    s.call("release", held_b)
    assert s.call("reclaim", 5) == 1
    c = [1, 1, 1, 1, 0]
    d = [2, 2, 2, 2, 0]
    held_c, _ = s.call("insert", c, s.call("pool.try_alloc", 1))
    held_d, _ = s.call("insert", d, s.call("pool.try_alloc", 1))
    s.call("release", held_c)
    s.call("release", held_d)
    s.call("release", s.call("lookup", c)[0])     # D is now the LRU leaf
    assert s.call("reclaim", 1) == 1
    assert s.call("lookup", d) == ([], [])
    assert s.call("owned_pages") == s.call("owned_pages")


def test_pool_audit_owned_reconciliation_and_tampered_ledger():
    s = _Both()
    assert s.call("pool.audit") == []
    pages = s.call("pool.try_alloc", 3)
    assert s.call("pool.audit", owned=pages) == []
    assert any("leak" in v for v in s.call("pool.audit", owned=pages[:2]))
    assert any("twice" in v
               for v in s.call("pool.audit", owned=pages + [pages[0]]))
    for store in s.stores:                        # an over-free
        store.pool._lent.discard(pages[0])
    assert s.call("pool.audit", owned=pages)
    for store in s.stores:
        store.pool._lent.add(pages[0])
    s.call("pool.free", pages)
    assert s.call("pool.audit", owned=[]) == []
    s.call("pool.free", [0])                      # corruption raises


# ---------------------------------------------------------------------------
# the chunk program and its op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", ["none", "int8"])
def test_chunk_program_json_equals_the_reference(quant):
    progs = []
    for mod, names in ((jax_lm, jax_names), (pt_lm, pt_names)):
        with names.guard():
            progs.append(mod.build_chunk_prefill_program(
                mod.DecoderLMConfig(**CFG_KW), 1, 4, 28, 4, quant))
    (jprog, jfeeds, jfetch), (pprog, pfeeds, pfetch) = progs
    assert (pfeeds, pfetch) == (jfeeds, jfetch)
    jd = json.loads(json.dumps(jprog.to_dict()))
    pd = json.loads(json.dumps(pprog.to_dict()))
    assert pd == jd
    # every parameter it reads is in decoder_lm_params (or its int8 form)
    cfg = pt_lm.DecoderLMConfig(**CFG_KW)
    params = pt_lm.decoder_lm_params(cfg, 0)
    if quant == "int8":
        params = pt_lm.quantize_decoder_lm_params(params, cfg)
    block = pd["blocks"][0]
    read = {n for op in block["ops"] for vs in op["inputs"].values()
            for n in vs}
    produced = {n for op in block["ops"] for vs in op["outputs"].values()
                for n in vs}
    pools = {f"kv_{kv}_{i}" for i in range(2) for kv in "kv"}
    free = read - produced - pools - set(pfeeds)
    ln = {n for n in free if n.endswith(("_ln1_scale", "_ln1_bias",
                                          "_ln2_scale", "_ln2_bias"))}
    assert free <= set(params) and ln <= set(params)


def _chunk_inputs(start, lengths, seed):
    rng = np.random.RandomState(seed)
    b, c, n, hd, pages, page, mp = 2, 4, 2, 8, 12, 4, 8
    kvdim = n * hd
    pool_k, pool_v = (rng.randn(pages, page, kvdim).astype(np.float32)
                      for _ in range(2))
    table = np.zeros((b, mp), np.int32)
    table[0, :5] = [3, 7, 1, 9, 4]
    table[1, :4] = [2, 5, 11, 6]
    ins = {"Q": rng.randn(b, c, kvdim).astype(np.float32),
           "K": rng.randn(b, c, kvdim).astype(np.float32),
           "V": rng.randn(b, c, kvdim).astype(np.float32),
           "PoolK": pool_k, "PoolV": pool_v, "PageTable": table,
           "ChunkStart": np.asarray(start, np.int32),
           "Lengths": np.asarray(lengths, np.int32)}
    return ins, {"num_heads": n, "head_dim": hd, "scale": hd ** -0.5}


@pytest.mark.parametrize("start,lengths", [([0, 0], [4, 4]),
                                           ([8, 4], [4, 4]),
                                           ([12, 8], [1, 4])])
def test_chunk_cached_attention_matches_the_reference_lowering(start,
                                                               lengths):
    ins, attrs = _chunk_inputs(start, lengths, sum(start) + sum(lengths))
    want = jax_registry.normalize_outputs(
        jax_registry.get("chunk_cached_attention").forward(
            {k: [jnp.asarray(v)] for k, v in ins.items()}, dict(attrs)))
    pins = {k: [torch.from_numpy(v.copy())] for k, v in ins.items()}
    got = pt_registry.normalize_outputs(
        pt_registry.get("chunk_cached_attention").forward(pins, dict(attrs)))
    np.testing.assert_allclose(got["Out"][0].numpy(),
                               np.asarray(want["Out"][0]), rtol=1e-5,
                               atol=1e-5)
    for slot in ("PoolKOut", "PoolVOut"):
        np.testing.assert_array_equal(got[slot][0].numpy(),
                                      np.asarray(want[slot][0]))
    # the pools are written in place, as the engine's captured programs
    # need
    assert got["PoolKOut"][0] is pins["PoolK"][0]


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def _cfgs():
    return (jax_lm.DecoderLMConfig(**CFG_KW),
            pt_lm.DecoderLMConfig(**CFG_KW))


def _pt_engine(**over):
    _, pcfg = _cfgs()
    return pt_decode.DecodeEngine(
        pcfg, pt_lm.decoder_lm_params(pcfg, 0),
        pt_decode.DecodeConfig(**{**POOL_KW, **over}), device="cpu")


def _jax_engine(**over):
    jcfg, _ = _cfgs()
    return jax_decode.demo_engine(
        jax_decode.DecodeConfig(**{**POOL_KW, **over}), jcfg)


def _generate_each(engine, prompts, **kw):
    engine.start()
    try:
        return [np.asarray(engine.generate(p, timeout=120, **kw))
                for p in prompts]
    finally:
        engine.close(drain=True, timeout=30)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_greedy_prefix_engine_matches_every_classic_and_jax_engine(quant):
    p1, p2 = _prompts()
    prompts = [p1, p2, p1]                        # cold, hit, full hit
    hits = pt_telemetry.counter_get("kv.prefix_hits")
    eng = _pt_engine(weight_quant=quant, prefix_cache=True)
    got = _generate_each(eng, prompts, max_new_tokens=6)
    assert pt_telemetry.counter_get("kv.prefix_hits") - hits == 2
    assert eng.pool.audit(owned=eng.prefix_store.owned_pages()) == []
    runs = {
        "port classic": _generate_each(_pt_engine(weight_quant=quant),
                                       prompts, max_new_tokens=6),
        "jax prefix": _generate_each(
            _jax_engine(weight_quant=quant, prefix_cache=True), prompts,
            max_new_tokens=6),
        "jax classic": _generate_each(_jax_engine(weight_quant=quant),
                                      prompts, max_new_tokens=6)}
    for name, ids in runs.items():
        for a, b in zip(got, ids):
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_sampled_and_int8_hits_equal_cold_runs(quant):
    p1, p2 = _prompts()
    kw = dict(max_new_tokens=6, temperature=0.8, seed=7)
    hit = _generate_each(_pt_engine(weight_quant=quant, prefix_cache=True),
                         [p1, p2], **kw)[1]
    cold = _generate_each(_pt_engine(weight_quant=quant, prefix_cache=True),
                          [p2], **kw)[0]
    classic = _generate_each(_pt_engine(weight_quant=quant), [p2], **kw)[0]
    np.testing.assert_array_equal(hit, cold)
    np.testing.assert_array_equal(hit, classic)


def test_reclaim_under_pressure_seats_every_request():
    rng = np.random.RandomState(3)
    eng = _pt_engine(max_slots=2, kv_pages=10, prefill_buckets=[8],
                     prefix_cache=True)
    before = pt_telemetry.counter_get("kv.reclaims")
    # distinct 12-token prompts: each leaves 3 idle blocks behind; the
    # 9-page pool forces eviction by the third
    outs = _generate_each(eng, [rng.randint(3, 90, size=12).astype(np.int32)
                                for _ in range(4)], max_new_tokens=6)
    assert all(o.size == 6 for o in outs)
    assert pt_telemetry.counter_get("kv.reclaims") > before
    assert eng.pool.audit(owned=eng.prefix_store.owned_pages()) == []


def test_warmup_builds_the_chunk_program_once():
    eng = _pt_engine(prefix_cache=True)
    classic = _pt_engine()
    assert eng.warmup() == classic.warmup() + 1
    assert ("chunk", POOL_KW["page_size"]) in eng._graphs
    graphs = len(eng._graphs)
    _generate_each(eng, list(_prompts()), max_new_tokens=4)
    assert len(eng._graphs) == graphs


# ---------------------------------------------------------------------------
# shipments
# ---------------------------------------------------------------------------

def _ship_inputs():
    rng = np.random.RandomState(11)
    layer_pages = {f"kv_{kv}_{i}": rng.randn(3, 4, 8).astype(np.float32)
                   for kv in ("k", "v") for i in range(2)}
    return [5, 6, 7, 8, 9], 4, layer_pages, rng.randn(97).astype(np.float32)


def test_shipment_bytes_equal_across_packages_and_cross_unpack():
    args = _ship_inputs()
    jb = jax_disagg.pack_shipment(*args)
    pb = pt_disagg.pack_shipment(*args)
    assert jb == pb
    for unpack, blob in ((pt_disagg.unpack_shipment, jb),
                         (jax_disagg.unpack_shipment, pb)):
        ship = unpack(blob)
        assert ship["tokens"] == args[0] and ship["n_pages"] == 3
        for name, arr in args[2].items():
            np.testing.assert_array_equal(ship["layers"][name], arr)
        np.testing.assert_array_equal(ship["logits"], args[3])


def test_flipped_payload_byte_raises_crc_error():
    blob = bytearray(pt_disagg.pack_shipment(*_ship_inputs()))
    before = pt_telemetry.counter_get("disagg.crc_rejects")
    for at in (-40, -500):
        bad = bytearray(blob)
        bad[at] ^= 0xFF
        with pytest.raises(pt_disagg.ShipmentCRCError):
            pt_disagg.unpack_shipment(bytes(bad))
    assert pt_telemetry.counter_get("disagg.crc_rejects") == before + 2
    with pytest.raises(pt_disagg.ShipmentError):
        pt_disagg.unpack_shipment(b"NOPE" + bytes(blob)[4:])


def test_submit_prefill_frees_its_pages_and_ships_the_reference_logits():
    _, p2 = _prompts()
    eng = _pt_engine()
    jeng = _jax_engine()
    eng.start()
    jeng.start()
    try:
        free = eng.pool.free_pages()
        ship = pt_disagg.unpack_shipment(
            bytes(eng.submit_prefill(p2).result(timeout=120)))
        jship = jax_disagg.unpack_shipment(
            bytes(jeng.submit_prefill(p2).result(timeout=120)))
        assert eng.pool.free_pages() == free
        assert eng.pool.audit(owned=[]) == []
    finally:
        eng.close(drain=True, timeout=30)
        jeng.close(drain=True, timeout=30)
    assert ship["tokens"] == [int(t) for t in p2]
    assert ship["n_pages"] == jship["n_pages"] == eng.pool.pages_for_tokens(
        p2.size)
    assert set(ship["layers"]) == set(jship["layers"])
    np.testing.assert_allclose(ship["logits"], jship["logits"], rtol=1e-5,
                               atol=1e-5)
    for name, arr in jship["layers"].items():
        np.testing.assert_allclose(ship["layers"][name], arr, rtol=1e-5,
                                   atol=1e-5)
