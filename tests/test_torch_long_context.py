"""Long-context pre-training, the JAX package's long-context benchmark row
(``tools/bench_models.py`` ``bench_long_context``): ERNIE with the
position table widened to the sequence, held against paddle_tpu on the
CPU.

* ERNIE-tiny (2 layers, hidden 128, 2 heads of 64, FFN 512) at seq 1024
  with ``max_position_embeddings = 1024``, batch 2 and the benchmark's
  ``max(80, seq * 15 // 100)`` = 153 masked predictions: both packages
  build the same program (equal JSON), and from one state 3 steps give
  the same dropout masks bit for bit and the same losses within 1e-4
  (fp32; the reference transposes to [B,H,S,D] above S = 512 and runs
  plain attention on the CPU, the port runs its packed plain version on
  the projections in place).
* ERNIE-large at the benchmark's two long rows, s2048 and s4096, bf16:
  the same program JSON in both packages, 24 flash forward and backward
  ops and 398 AdamW updates, the position table [seq, 1024] and the saved
  Lse [B, 16, seq]. Shape inference runs on meta tensors: nothing of
  that size is allocated.
"""

import dataclasses
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

SEQ, BATCH = 1024, 2
PREDS = max(80, SEQ * 15 // 100)
TINY = dict(vocab_size=512, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=512,
            max_position_embeddings=SEQ, use_flash_attention=True)


def _json(prog):
    return json.loads(json.dumps(prog.to_dict()))


def _tiny(mod, names):
    cfg = mod.BertConfig(**TINY)
    with names.guard():
        return (cfg,) + tuple(mod.build_pretraining_program(
            cfg, seq_len=SEQ, optimizer_name="adamw",
            max_predictions_per_seq=PREDS))


def test_long_context_ernie_tiny_trains_as_the_reference():
    cfg, jmain, jstart, _, jfetch = _tiny(jbert, jax_names)
    _, pmain, pstart, _, pfetch = _tiny(pbert, pt_names)
    assert _json(pmain) == _json(jmain) and _json(pstart) == _json(jstart)

    jscope = pt.Scope()
    jexe = pt.Executor(pt.CPUPlace())
    jexe.run(jstart, scope=jscope, use_compiled=False)
    pscope = pbert.scope_from_numpy(
        {n: np.asarray(v) for n, v in jscope.items()}, "cpu")
    batch = jbert.synthetic_pretraining_batch(cfg, BATCH, SEQ, seed=4,
                                              max_predictions_per_seq=PREDS)
    masks = [o.outputs["Mask"][0] for o in pmain.global_block().ops
             if o.type == "dropout"]
    assert len(masks) == 5
    fetch = [pfetch["loss"].name, pfetch["lm_loss"].name,
             pfetch["nsp_loss"].name] + masks
    pexe = Executor(device="cpu")
    losses = []
    for _ in range(3):
        want = jexe.run(jmain, feed=batch, fetch_list=fetch, scope=jscope,
                        use_compiled=False)
        got = pexe.run(pmain, feed=batch, fetch_list=fetch, scope=pscope)
        for w, g in zip(want[:3], got[:3]):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                       atol=1e-4)
        for w, g in zip(want[3:], got[3:]):
            assert g.dtype == np.uint8 and np.array_equal(g, np.asarray(w))
        losses.append(float(got[0].reshape(-1)[0]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


@pytest.mark.parametrize("seq", [2048, 4096])
def test_long_context_ernie_large_program_matches_the_reference(seq):
    preds = max(80, seq * 15 // 100)
    progs = {}
    for mod, names in ((jbert, jax_names), (pbert, pt_names)):
        cfg = dataclasses.replace(mod.ernie_large(),
                                  max_position_embeddings=seq,
                                  dtype="bfloat16", use_flash_attention=True)
        with names.guard():
            progs[mod] = mod.build_pretraining_program(
                cfg, seq_len=seq, optimizer_name="adamw",
                max_predictions_per_seq=preds)[0]
    pmain = progs[pbert]
    assert _json(pmain) == _json(progs[jbert])
    ops = pmain.global_block().ops
    count = {t: sum(o.type == t for o in ops)
             for t in ("flash_attention", "flash_attention_grad", "adamw")}
    assert count == {"flash_attention": 24, "flash_attention_grad": 24,
                     "adamw": 398}
    blk = pmain.global_block()
    assert blk.var("pos_embedding").shape == (seq, 1024)
    flash = next(o for o in ops if o.type == "flash_attention")
    assert blk.var(flash.outputs["Lse"][0]).shape == (-1, 16, seq)
    with pt_names.guard(), pytest.raises(ValueError):
        pbert.build_pretraining_program(pbert.ernie_large(), seq_len=seq)
