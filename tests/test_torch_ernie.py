"""The training slice as a whole: ERNIE/BERT pre-training in
paddle_tpu_torch held against paddle_tpu, on the CPU, at a tiny size (2
layers, hidden 128, 2 heads of 64, FFN 512, seq 64, batch 4, 8 masked
predictions).

* Both packages build the same program: forward, backward and optimizer
  ops, var dtypes, shapes and sharding annotations serialise to equal
  JSON after ``minimize`` (fp32 and bf16, Adam and AdamW, with and
  without the masked gather, the NSP head and the optimizer).
* From one state (the JAX startup's, carried over by
  ``scope_from_numpy``), 5 steps give the same dropout masks bit for bit
  and the same losses: fp32 within 1e-4 of the JAX interpreting executor
  (``use_compiled=False``) and of the compiled one (5 steps of 2 layers,
  sums in different orders, AdamW in its one-pass form); bf16 within 5e-2
  (the two frameworks round bf16 at different points inside gelu, layer
  norm and the log-softmax).
* The port's own startup program runs, and its parameters pass the
  distribution checks.
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core import unique_name as jax_names
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch  # noqa: F401
from paddle_tpu_torch.core import unique_name as pt_names
from paddle_tpu_torch.core.executor import STEP_COUNTER, Executor
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.models import bert as pbert

torch.set_num_threads(2)

TINY = dict(vocab_size=512, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=512,
            max_position_embeddings=64)
SEQ, BATCH, PREDS = 64, 4, 8


def _build(mod, names, dtype="float32", flash=True, optimizer="adamw",
           preds=PREDS, **kw):
    cfg = mod.BertConfig(dtype=dtype, use_flash_attention=flash, **TINY)
    with names.guard():
        return (cfg,) + tuple(mod.build_pretraining_program(
            cfg, seq_len=SEQ, optimizer_name=optimizer,
            max_predictions_per_seq=preds, **kw))


def _json(prog):
    return json.loads(json.dumps(prog.to_dict()))


@pytest.mark.parametrize("dtype,optimizer,preds", [
    ("float32", "adamw", PREDS), ("bfloat16", "adamw", PREDS),
    ("float32", "adam", 0), ("bfloat16", "adam", PREDS)])
def test_both_packages_build_the_same_program(dtype, optimizer, preds):
    _, jmain, jstart, jfeeds, jfetch = _build(jbert, jax_names, dtype, True,
                                              optimizer, preds)
    _, pmain, pstart, pfeeds, pfetch = _build(pbert, pt_names, dtype, True,
                                              optimizer, preds)
    for j, p in ((jmain, pmain), (jstart, pstart)):
        jd, pd = _json(j), _json(p)
        assert [o["type"] for o in pd["blocks"][0]["ops"]] == \
            [o["type"] for o in jd["blocks"][0]["ops"]]
        assert pd["blocks"][0]["vars"] == jd["blocks"][0]["vars"]
        assert pd == jd
    assert {k: v.name for k, v in pfeeds.items()} == \
        {k: v.name for k, v in jfeeds.items()}
    assert {k: v.name for k, v in pfetch.items()} == \
        {k: v.name for k, v in jfetch.items()}
    types = {o.type for o in pmain.global_block().ops}
    assert {"__vjp_grad__", "sum", "flash_attention_grad",
            optimizer} <= types
    annotated = [v for v in pmain.global_block().vars.values()
                 if v.desc.attrs]
    assert len(annotated) > 50        # weights and their moments


def test_test_program_and_no_nsp_variant_match_too():
    for kw in (dict(is_test=True, with_optimizer=False),
               dict(with_nsp=False)):
        j = _build(jbert, jax_names, **kw)
        p = _build(pbert, pt_names, **kw)
        assert _json(p[1]) == _json(j[1]) and _json(p[2]) == _json(j[2])


def _jax_state(jstart):
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(jstart, scope=scope, use_compiled=False)
    return exe, scope, {n: np.asarray(v) for n, v in scope.items()}


def _mask_names(prog):
    return [o.outputs["Mask"][0] for o in prog.global_block().ops
            if o.type == "dropout"]


def _train_both(dtype, use_compiled, steps=5):
    cfg, jmain, jstart, _, jfetch = _build(jbert, jax_names, dtype)
    _, pmain, _, _, pfetch = _build(pbert, pt_names, dtype)
    jexe, jscope, state = _jax_state(jstart)
    pscope = pbert.scope_from_numpy(state, "cpu")
    batch = jbert.synthetic_pretraining_batch(cfg, BATCH, SEQ, seed=1,
                                              max_predictions_per_seq=PREDS)
    assert all(np.array_equal(v, pbert.synthetic_pretraining_batch(
        cfg, BATCH, SEQ, seed=1, max_predictions_per_seq=PREDS)[k])
        for k, v in batch.items())
    masks = _mask_names(pmain)
    fetch = [pfetch["loss"].name, pfetch["lm_loss"].name,
             pfetch["nsp_loss"].name] + masks
    pexe = Executor(device="cpu")
    rows = []
    for _ in range(steps):
        want = jexe.run(jmain, feed=batch, fetch_list=fetch, scope=jscope,
                        use_compiled=use_compiled)
        got = pexe.run(pmain, feed=batch, fetch_list=fetch, scope=pscope)
        rows.append((want, got))
    return rows, len(masks), jscope, pscope


@pytest.mark.parametrize("use_compiled", [False, True])
def test_fp32_training_matches_reference(use_compiled):
    rows, n_masks, jscope, pscope = _train_both("float32", use_compiled)
    assert n_masks == 5
    losses = []
    for want, got in rows:
        for w, g in zip(want[:3], got[:3]):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                       atol=1e-4)
        for w, g in zip(want[3:], got[3:]):
            assert g.dtype == np.uint8 and np.array_equal(g, np.asarray(w))
        losses.append(float(got[0].reshape(-1)[0]))
    assert losses[-1] < losses[0]
    assert int(pscope.find_var(STEP_COUNTER)) == \
        int(jscope.find_var(STEP_COUNTER)) == 6
    # the trained state agrees as well: parameters, moments, beta pows
    for name in ("word_embedding", "layer_1_ffn1_w", "mlm_out_bias",
                 "layer_0_attn_q_w_moment1_0", "nsp_w_beta2_pow_0"):
        np.testing.assert_allclose(pscope.find_var(name).numpy(),
                                   np.asarray(jscope.find_var(name)),
                                   rtol=1e-3, atol=2e-5, err_msg=name)


def test_masks_differ_from_step_to_step():
    rows, _, _, _ = _train_both("float32", False, steps=2)
    assert not np.array_equal(rows[0][1][3], rows[1][1][3])


def test_bf16_training_matches_reference():
    rows, _, jscope, pscope = _train_both("bfloat16", False)
    for want, got in rows:
        for w, g in zip(want[:3], got[:3]):
            np.testing.assert_allclose(
                g, np.asarray(w, np.float32), rtol=5e-2, atol=5e-2)
        for w, g in zip(want[3:], got[3:]):
            assert np.array_equal(g, np.asarray(w))
    w = pscope.find_var("layer_0_ffn1_w")
    assert w.dtype == torch.bfloat16
    assert pscope.find_var("layer_0_ffn1_w_moment1_0").dtype == torch.float32
    assert pscope.find_var("layer_0_ln1_scale").dtype == torch.float32


def test_scope_from_numpy_carries_bf16_bit_for_bit_and_copies():
    _, _, jstart, _, _ = _build(jbert, jax_names, "bfloat16")
    _, _, state = _jax_state(jstart)
    w = state["layer_0_ffn1_w"]
    assert w.dtype.name == "bfloat16"
    bits = w.view(np.uint16)
    a = pbert.scope_from_numpy(state, "cpu")
    b = pbert.scope_from_numpy(
        {"layer_0_ffn1_w": (bits, "bfloat16"),
         "lr": np.ones(1, np.float32), STEP_COUNTER: np.int32(7)}, "cpu")
    for sc in (a, b):
        t = sc.find_var("layer_0_ffn1_w")
        assert t.dtype == torch.bfloat16
        assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16),
                              bits)
    assert int(b.find_var(STEP_COUNTER)) == 7
    assert isinstance(a.find_var(STEP_COUNTER), np.int32)
    lr = np.ones(1, np.float32)
    sc = pbert.scope_from_numpy({"lr": lr}, "cpu")
    sc.find_var("lr").mul_(3.0)
    assert lr[0] == 1.0


def test_the_ports_own_startup_runs_and_trains():
    cfg, main, startup, _, fetches = _build(pbert, pt_names)
    ops = [o.type for o in startup.global_block().ops]
    assert set(ops) == {"fill_constant", "truncated_gaussian_random"}
    scope = Scope()
    exe = Executor(device="cpu")
    exe.run(startup, scope=scope)
    emb = scope.find_var("word_embedding")
    assert tuple(emb.shape) == (512, 128) and emb.dtype == torch.float32
    assert float(emb.abs().max()) <= 2 * cfg.initializer_range + 1e-7
    assert abs(float(emb.mean())) < 1e-3
    assert abs(float(emb.std()) / cfg.initializer_range - 0.8796) < 0.02
    assert not torch.equal(scope.find_var("layer_0_attn_q_w"),
                           scope.find_var("layer_0_attn_k_w"))
    assert torch.equal(scope.find_var("layer_0_ln1_scale"), torch.ones(128))
    assert float(scope.find_var("layer_0_ffn1_b").abs().max()) == 0.0
    assert float(scope.find_var("learning_rate_0")) == pytest.approx(1e-4)
    assert float(scope.find_var("nsp_w_beta1_pow_0")) == pytest.approx(0.9)
    batch = pbert.synthetic_pretraining_batch(cfg, BATCH, SEQ, seed=3,
                                              max_predictions_per_seq=PREDS)
    losses = [float(exe.run(main, feed=batch, fetch_list=[fetches["loss"]],
                            scope=scope)[0].reshape(-1)[0])
              for _ in range(6)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert abs(losses[0] - (np.log(512) + np.log(2))) < 0.5


def test_full_width_ernie_large_program_has_the_reference_op_counts():
    """ERNIE-large as the benchmark builds it: 1476 ops of 27 types, 398
    AdamW updates; shape inference on meta tensors allocates nothing."""
    from collections import Counter

    cfg = pbert.ernie_large()
    cfg.dtype, cfg.use_flash_attention = "bfloat16", True
    with pt_names.guard():
        main, startup, _, _ = pbert.build_pretraining_program(
            cfg, seq_len=512, optimizer_name="adamw",
            max_predictions_per_seq=80)
    counts = Counter(o.type for o in main.global_block().ops)
    assert sum(counts.values()) == 1476 and len(counts) == 27
    assert (counts["__vjp_grad__"], counts["flash_attention_grad"],
            counts["sum"], counts["adamw"]) == (485, 24, 50, 398)
    sc = Counter(o.type for o in startup.global_block().ops)
    assert sc == {"fill_constant": 1841, "truncated_gaussian_random": 150}
    blk = main.global_block()
    assert blk.var("layer_23_ffn1_w").shape == (1024, 4096)
    assert str(blk.var("layer_23_ffn1_w").dtype) == "bfloat16"
    flash = [o for o in blk.ops if o.type == "flash_attention"][0]
    assert blk.var(flash.output("Lse")[0]).shape == (-1, 16, 512)


@pytest.mark.parametrize("kw", [dict(sequence_parallel=2),
                                dict(pipeline_stages=2),
                                dict(data_parallel=2),
                                dict(optimizer_name="lamb")])
def test_variants_outside_the_port_raise(kw):
    cfg = pbert.BertConfig(**TINY)
    with pt_names.guard(), pytest.raises(NotImplementedError):
        pbert.build_pretraining_program(cfg, seq_len=SEQ, **kw)


def test_other_attention_branches_and_long_sequences_raise():
    for kw in (dict(use_ring_attention=True), dict(use_flash_attention=False)):
        cfg = pbert.BertConfig(**kw, **TINY)
        with pt_names.guard(), pytest.raises(NotImplementedError):
            pbert.build_pretraining_program(cfg, seq_len=SEQ)
    with pt_names.guard(), pytest.raises(ValueError):
        pbert.build_pretraining_program(pbert.BertConfig(**TINY),
                                        seq_len=128)
    for fn in (pbert.bert_base, pbert.bert_large, pbert.ernie_large):
        assert vars(fn()) == vars(getattr(jbert, fn.__name__)())
