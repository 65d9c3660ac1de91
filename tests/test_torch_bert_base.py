"""The BERT-base s128 row of the reference's ladder
(``tools/bench_models.py`` ``bench_bert_base``: b384, s128, 20 masked
predictions, bf16, flash attention, dropout 0.1, AdamW) in
paddle_tpu_torch, held against paddle_tpu on the CPU.

* At full width (hidden 768, 12 layers, 12 heads of 64, vocab 30522) both
  packages build the same bf16 pre-training program at s128, JSON for
  JSON.
* At a tiny width and depth from ``bert_base()`` (2 layers, hidden 128, 2
  heads of 64, FFN 512, vocab 512; seq 128, batch 2, 20 predictions, flash
  attention, dropout 0.1 on the probabilities and the hidden states,
  AdamW), from one state (the JAX startup's), 4 steps give the same
  dropout masks bit for bit and the same losses: fp32 within 1e-4 of the
  reference's compiled step, the port op by op and compiled (sums in
  different orders); bf16 within 5e-2 (the two frameworks round bf16 at
  different points inside gelu, layer norm and the log-softmax).
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core import unique_name as jax_names
from paddle_tpu.models import bert as jbert

from paddle_tpu_torch.core import unique_name as pt_names
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.models import bert as pbert

torch.set_num_threads(2)

SEQ, BATCH, PREDS, STEPS = 128, 2, 20, 4
TINY = dict(num_hidden_layers=2, hidden_size=128, num_attention_heads=2,
            intermediate_size=512, vocab_size=512)


def _cfg(mod, dtype, tiny):
    cfg = mod.bert_base()
    for k, v in (TINY if tiny else {}).items():
        setattr(cfg, k, v)
    cfg.dtype, cfg.use_flash_attention = dtype, True
    return cfg


def _build(mod, names, dtype, tiny=True):
    cfg = _cfg(mod, dtype, tiny)
    with names.guard():
        return (cfg,) + tuple(mod.build_pretraining_program(
            cfg, seq_len=SEQ, optimizer_name="adamw",
            max_predictions_per_seq=PREDS))


def _json(prog):
    return json.loads(json.dumps(prog.to_dict()))


def test_full_width_bert_base_builds_the_reference_program():
    _, jmain, jstart, _, _ = _build(jbert, jax_names, "bfloat16", False)
    _, pmain, pstart, _, _ = _build(pbert, pt_names, "bfloat16", False)
    assert _json(pmain) == _json(jmain) and _json(pstart) == _json(jstart)
    ops = [o.type for o in pmain.global_block().ops]
    assert ops.count("flash_attention") == 12
    assert ops.count("flash_attention_grad") == 12
    flash = next(o for o in pmain.global_block().ops
                 if o.type == "flash_attention")
    assert flash.attrs["dropout_prob"] == pytest.approx(0.1)
    q = pmain.global_block().var(flash.inputs["Q"][0])
    assert q.shape == (-1, SEQ, 768) and str(q.dtype) == "bfloat16"


def _train(dtype, use_compiled):
    cfg, jmain, jstart, _, jfetch = _build(jbert, jax_names, dtype)
    _, pmain, _, _, pfetch = _build(pbert, pt_names, dtype)
    assert _json(pmain) == _json(jmain)
    jscope, jexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    jexe.run(jstart, scope=jscope, use_compiled=False)
    state = {n: np.array(v) for n, v in jscope.items()}
    pscope = pbert.scope_from_numpy(state, "cpu")
    batch = jbert.synthetic_pretraining_batch(cfg, BATCH, SEQ, seed=4,
                                              max_predictions_per_seq=PREDS)
    masks = [o.outputs["Mask"][0] for o in pmain.global_block().ops
             if o.type == "dropout"]
    fetch = [pfetch["loss"].name] + masks
    pexe = Executor(device="cpu")
    rows = []
    for _ in range(STEPS):
        want = jexe.run(jmain, feed=batch, fetch_list=fetch, scope=jscope)
        got = pexe.run(pmain, feed=batch, fetch_list=fetch, scope=pscope,
                       use_compiled=use_compiled)
        rows.append((want, got))
    return rows, len(masks)


@pytest.mark.parametrize("use_compiled", [False, True])
def test_fp32_training_matches_reference(use_compiled):
    rows, n_masks = _train("float32", use_compiled)
    assert n_masks == 5          # embeddings, 2 per layer
    for want, got in rows:
        np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-4,
                                   atol=1e-4)
        for w, g in zip(want[1:], got[1:]):
            assert g.dtype == np.uint8 and np.array_equal(g, np.asarray(w))
    assert not np.array_equal(rows[0][1][1], rows[1][1][1])
    losses = [float(g[0].reshape(-1)[0]) for _, g in rows]
    assert losses[-1] < losses[0]


def test_bf16_training_matches_reference():
    rows, _ = _train("bfloat16", True)
    for want, got in rows:
        np.testing.assert_allclose(np.asarray(got[0], np.float32),
                                   np.asarray(want[0], np.float32),
                                   rtol=5e-2, atol=5e-2)
        for w, g in zip(want[1:], got[1:]):
            assert np.array_equal(g, np.asarray(w))
