"""The port's serving slice, end to end on the CPU, held against
paddle_tpu's decode path on its default CPU route (PT_PALLAS unset:
stock paged attention, stock int8 GEMM, reference attention).

* prefill + 6 decode steps of the small model, fp32 and int8: the
  port's programs and the JAX programs, run op by op on the same params,
  pools and feeds, give logits within ``rtol=1e-4, atol=1e-5`` (the two
  frameworks sum in different orders inside matmul and softmax);
* the two DecodeEngines give the same greedy ids and, under the same
  seeds, the same sampled ids;
* inside the port, continuous batching equals one-at-a-time decode bit
  for bit;
* entry points never fall back: no device means CUDA, which raises here;
  the replica's ``--telemetry-log`` and ``Router.attach_fleet`` (ROADMAP
  A10) refuse to run;
* ``import paddle_tpu_torch`` loads neither jax nor paddle_tpu.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.core import executor as jax_executor
from paddle_tpu.models import decoder_lm as jax_lm
from paddle_tpu.serving import decode as jax_decode

from paddle_tpu_torch.core.executor import run_block
from paddle_tpu_torch.models import decoder_lm as pt_lm
from paddle_tpu_torch.serving import decode as pt_decode

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(vocab_size=256, d_model=128, n_head=2, n_layers=2, d_inner=256,
             max_seq_len=64)
PAGE, PAGES = 8, 24


def _params(quant, seed=1):
    p = jax_lm.decoder_lm_params(jax_lm.DecoderLMConfig(**SMALL), seed)
    if quant == "int8":
        p = jax_lm.quantize_decoder_lm_params(p, jax_lm.DecoderLMConfig(
            **SMALL))
    return p


class _Pair:
    """The same program run by both packages on the same inputs."""

    def __init__(self, quant):
        self.quant = quant
        self.params = _params(quant)
        self.jcfg = jax_lm.DecoderLMConfig(**SMALL)
        self.pcfg = pt_lm.DecoderLMConfig(**SMALL)
        shape = (PAGES, PAGE, SMALL["d_model"])
        names = [f"kv_{kv}_{i}" for i in range(SMALL["n_layers"])
                 for kv in "kv"]
        self.jpools = {n: jnp.zeros(shape, jnp.float32) for n in names}
        self.ppools = {n: torch.zeros(shape) for n in names}
        self.jparams = {n: jnp.asarray(v) for n, v in self.params.items()}
        self.pparams = pt_lm.params_from_numpy(self.params, "cpu")

    def run(self, builder_args, feed):
        jprog = builder_args(jax_lm, self.jcfg)
        pprog = builder_args(pt_lm, self.pcfg)
        jenv = dict(self.jparams, **self.jpools)
        jenv.update({n: jnp.asarray(v) for n, v in feed.items()})
        jax_executor.run_block(jprog.global_block(), jenv)
        penv = dict(self.pparams, **self.ppools)
        penv.update({n: torch.from_numpy(v.copy()) for n, v in feed.items()})
        run_block(pprog.global_block(), penv)
        self.jpools = {n: jenv[n + "_out"] for n in self.jpools}
        self.ppools = {n: penv[n + "_out"] for n in self.ppools}
        return np.asarray(jenv["logits"]), penv["logits"].numpy()


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_prefill_and_six_steps_match_reference(quant):
    pair = _Pair(quant)
    mp = SMALL["max_seq_len"] // PAGE
    rng = np.random.RandomState(11)
    prompts = [rng.randint(3, 256, 11), rng.randint(3, 256, 5)]
    rows = [[1, 2, 3], [4, 5]]
    last = []
    for prompt, pages in zip(prompts, rows):
        bucket = 16
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :len(prompt)] = prompt
        oh = np.zeros((1, bucket), np.float32)
        oh[0, len(prompt) - 1] = 1.0
        table = np.zeros((1, mp), np.int32)
        table[0, :len(pages)] = pages
        feed = {"tokens": tokens,
                "lengths": np.array([len(prompt)], np.int32),
                "last_onehot": oh, "page_table": table}
        want, got = pair.run(lambda m, c: m.build_prefill_program(
            c, 1, bucket, PAGES, PAGE, quant)[0], feed)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        last.append(int(np.argmax(want[0])))
    table = np.zeros((4, mp), np.int32)
    table[0, :3], table[1, :2] = rows
    pos = np.array([11, 5, 0, 0], np.int32)
    for _ in range(6):
        feed = {"tokens": np.array(last + [0, 0], np.int32),
                "positions": pos.copy(), "page_table": table}
        want, got = pair.run(lambda m, c: m.build_step_program(
            c, 4, PAGES, PAGE, quant)[0], feed)
        np.testing.assert_allclose(got[:2], want[:2], rtol=1e-4, atol=1e-5)
        last = [int(np.argmax(want[i])) for i in range(2)]   # teacher-forced
        pos[:2] += 1
    for n in pair.jpools:   # the KV pages both packages wrote agree too
        np.testing.assert_allclose(pair.ppools[n][1:].numpy(),
                                   np.asarray(pair.jpools[n])[1:],
                                   rtol=1e-4, atol=1e-5)


def _requests(rng):
    prompts = [rng.randint(3, 250, n).astype(np.int32) for n in (7, 19, 3)]
    greedy = [dict(prompt=p, max_new_tokens=6) for p in prompts]
    sampled = [dict(prompt=p, max_new_tokens=6, temperature=0.8,
                    seed=100 + i) for i, p in enumerate(prompts)]
    return greedy + sampled


def _serve(engine, reqs, concurrent=True):
    engine.start()
    try:
        if concurrent:
            handles = [engine.submit(**r) for r in reqs]
            return [np.asarray(h.result(timeout=120)) for h in handles]
        return [np.asarray(engine.generate(timeout=120, **r)) for r in reqs]
    finally:
        engine.close(drain=True, timeout=30)


def _config(mod, quant):
    return mod.DecodeConfig(max_slots=4, page_size=PAGE, kv_pages=PAGES,
                            weight_quant=quant, prefill_buckets=[32])


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_engine_ids_match_reference_engine(quant):
    reqs = _requests(np.random.RandomState(5))
    fp32 = _params("none")
    jax_ids = _serve(jax_decode.DecodeEngine(
        jax_lm.DecoderLMConfig(**SMALL), fp32, _config(jax_decode, quant)),
        reqs)
    eng = pt_decode.DecodeEngine(pt_lm.DecoderLMConfig(**SMALL), fp32,
                                 _config(pt_decode, quant), device="cpu")
    pt_ids = _serve(eng, reqs)
    for a, b in zip(pt_ids, jax_ids):
        np.testing.assert_array_equal(a, b)
    stats = eng.stats()
    assert stats["kv_cache"]["pages_free"] == PAGES - 1
    assert stats["kernels"] == {"flash_attention_fwd": 0,
                                "paged_attention": 0, "int8_gemm": 0,
                                "flash_attention_bwd": 0, "fused_adamw": 0,
                                "layer_norm": 0, "conv_bn_relu": 0}
    assert stats["device"] == "cpu"


def test_continuous_equals_sequential_in_port():
    reqs = _requests(np.random.RandomState(9))
    cfg = pt_lm.DecoderLMConfig(**SMALL)

    def engine():
        return pt_decode.DecodeEngine(cfg, _params("none", seed=2),
                                      _config(pt_decode, "none"),
                                      device="cpu")

    together = _serve(engine(), reqs, concurrent=True)
    alone = _serve(engine(), reqs, concurrent=False)
    for a, b in zip(together, alone):
        assert np.array_equal(a, b)


def test_many_client_threads_get_sequential_results():
    """16 client threads submit at once with a short switch interval:
    every request gets exactly its one-at-a-time ids, and the page pool
    ends where it started."""
    import threading

    cfg = pt_lm.DecoderLMConfig(**SMALL)
    rng = np.random.RandomState(13)
    reqs = [dict(prompt=rng.randint(3, 250, rng.randint(2, 30)).astype(
        np.int32), max_new_tokens=int(rng.randint(1, 8)),
        temperature=0.8 if i % 3 == 0 else 0.0, seed=i)
        for i in range(32)]
    eng = pt_decode.DecodeEngine(cfg, _params("none", seed=3),
                                 _config(pt_decode, "none"), device="cpu")
    alone = _serve(eng, reqs, concurrent=False)
    eng = pt_decode.DecodeEngine(cfg, _params("none", seed=3),
                                 _config(pt_decode, "none"), device="cpu")
    eng.start()
    got = [None] * len(reqs)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def client(lo):
            for i in range(lo, len(reqs), 16):
                got[i] = np.asarray(eng.generate(timeout=120, **reqs[i]))

        threads = [threading.Thread(target=client, args=(lo,))
                   for lo in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        eng.close(drain=True, timeout=30)
    for a, b in zip(got, alone):
        assert a is not None and np.array_equal(a, b)
    assert eng.pool.stats()["pages_free"] == PAGES - 1


def test_servable_dir_from_reference_loads_in_port(tmp_path):
    cfg = jax_lm.DecoderLMConfig(**SMALL)
    jax_lm.save_decoder_lm(str(tmp_path), cfg, _params("none"))
    eng = pt_decode.decode_engine_from_dir(
        str(tmp_path), _config(pt_decode, "none"), device="cpu")
    direct = pt_decode.DecodeEngine(pt_lm.DecoderLMConfig(**SMALL),
                                    _params("none"),
                                    _config(pt_decode, "none"),
                                    device="cpu")
    prompt = dict(prompt=np.arange(3, 12, dtype=np.int32), max_new_tokens=4)
    assert np.array_equal(_serve(eng, [prompt])[0],
                          _serve(direct, [prompt])[0])


def test_no_silent_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = pt_lm.DecoderLMConfig(**SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_decode.DecodeEngine(cfg, _params("none"),
                               _config(pt_decode, "none"))
    with pytest.raises(RuntimeError):
        pt_decode.resolve_device("cuda:0")


def test_paths_outside_the_slice_raise(tmp_path):
    # prefill tiers over HTTP are ported (test_torch_serving_http.py,
    # test_torch_cluster.py): prefill_urls is kept, not refused
    assert pt_decode.DecodeConfig(prefill_urls="http://h:1").prefill_urls \
        == ["http://h:1"]
    # the replica's JSONL run log is ported: --telemetry-log configures
    # the sink before the engine loads (here from a dir that is absent)
    from paddle_tpu_torch.core import telemetry
    from paddle_tpu_torch.serving import replica, router

    log = tmp_path / "run.jsonl"
    try:
        with pytest.raises(FileNotFoundError):
            replica.main(["--decode-model-dir", str(tmp_path / "lm"),
                          "--device", "cpu", "--telemetry-log", str(log)])
        assert telemetry.enabled()
        telemetry.flush_sink()
        assert log.exists()
    finally:
        telemetry.configure(None)
    # the router's fleet observatory is not (ROADMAP A10b)
    with pytest.raises(NotImplementedError, match="A10"):
        router.Router().attach_fleet(object())


def test_import_loads_neither_jax_nor_paddle_tpu():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.serving, "
            "paddle_tpu_torch.models.decoder_lm, paddle_tpu_torch.kernels, "
            "paddle_tpu_torch.layers, paddle_tpu_torch.ops.rnn_ops, "
            "paddle_tpu_torch.ops.sequence_ops, "
            "paddle_tpu_torch.ops.beam_search_ops, "
            "paddle_tpu_torch.models.seq2seq, "
            "paddle_tpu_torch.models.sentiment, "
            "paddle_tpu_torch.models.vision_extra\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'paddle_tpu' "
            "or m.startswith('paddle_tpu.'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)
    pattern = re.compile(r"^\s*(import|from)\s+(jax|paddle_tpu)(\s|\.|$)",
                         re.M)
    for path in [REPO / "chip_smoke.py",
                 *(REPO / "paddle_tpu_torch").rglob("*.py")]:
        assert not pattern.search(path.read_text()), path
