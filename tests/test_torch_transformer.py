"""The Transformer-big row of the reference's ladder
(``tools/bench_models.py`` ``bench_transformer_big``: WMT14 En-De, b48,
s256, bf16 AMP, Adam under the noam schedule) in paddle_tpu_torch, held
against paddle_tpu on the CPU.

* At full width (``transformer_big()``: d_model 1024, 16 heads, d_inner
  4096, 6+6 layers, vocab 32000 shared) at s256, with AMP and without,
  and ``transformer_base()``, both packages build the same main and
  startup programs, JSON for JSON.
* At a tiny width (2+2 layers, d_model 128, 2 heads of 64, d_inner 256,
  vocab 96; s32, batch 2; dropout 0.1 everywhere, label smoothing 0.1,
  Adam under noam with a warm-up of WARMUP steps), from one state (the
  JAX startup's, carried by ``scope_from_numpy``), 4 steps: the 12
  dropout masks bit for bit, the learning rate bit for bit at every
  step, and the losses within 1e-4 in fp32 (the port op by op and
  compiled against the reference's compiled step; sums in other
  orders) and within 5e-2 with bf16 AMP (the frameworks round bf16 at
  other points inside the log-softmax and the layer norms). The
  warm-up is short so that the updates move the loss: at the published
  4000 steps the rate at d_model 128 stays below 3e-6 over 4 steps,
  Adam moves each weight by about that much, and a missing update
  would hide inside the tolerance. At 30 the rate climbs from 1.1e-3
  to 4.3e-3, and every step's loss must lie below the one before by
  more than the tolerance (with no update the new masks alone raise
  the loss from 4.96 to about 5.1).
* The forward-only program (``with_optimizer=False``, ``is_test=True``)
  gives the same loss within 1e-5.
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core import unique_name as jax_names
from paddle_tpu.models import transformer as jtr

from paddle_tpu_torch.core import unique_name as pt_names
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.scope import scope_from_numpy
from paddle_tpu_torch.models import transformer as ptr

torch.set_num_threads(2)

SEQ, BATCH, STEPS, WARMUP = 32, 2, 4, 30
TINY = dict(n_encoder_layers=2, n_decoder_layers=2, d_model=128, n_head=2,
            d_inner=256, src_vocab_size=96, tgt_vocab_size=96)


def _cfg(mod, tiny, base=False):
    cfg = mod.transformer_base() if base else mod.transformer_big()
    for k, v in (TINY if tiny else {}).items():
        setattr(cfg, k, v)
    return cfg


def _build(mod, names, tiny=True, base=False, **kw):
    cfg = _cfg(mod, tiny, base)
    with names.guard():
        return (cfg,) + tuple(mod.build_wmt_program(
            cfg, seq_len=SEQ if tiny else 256, **kw))


def _json(prog):
    return json.loads(json.dumps(prog.to_dict()))


@pytest.mark.parametrize("base,amp", [(False, True), (False, False),
                                      (True, False)])
def test_full_width_builds_the_reference_program(base, amp):
    _, jmain, jstart, _, _ = _build(jtr, jax_names, False, base, amp=amp)
    _, pmain, pstart, _, _ = _build(ptr, pt_names, False, base, amp=amp)
    assert _json(pmain) == _json(jmain) and _json(pstart) == _json(jstart)
    ops = [o.type for o in pmain.global_block().ops]
    assert ops.count("flash_attention") == 18
    assert ops.count("flash_attention_grad") == 18
    assert ops.count("adam") == len(pmain.all_parameters()) - 1  # pos table
    flash = [o for o in pmain.global_block().ops
             if o.type == "flash_attention"]
    assert sum(o.attrs["causal"] for o in flash) == 6
    assert sum(bool(o.inputs.get("Bias")) for o in flash) == 12
    assert all(o.attrs["dropout_prob"] == pytest.approx(0.1) for o in flash)
    starts = [o.type for o in pstart.global_block().ops]
    assert starts.count("assign_value") == 1       # one shared table


def test_unfused_attention_is_not_in_the_port():
    """The unfused branch builds the reference's program: no flash op,
    one shared causal table (its training is held in
    ``test_torch_transformer_unfused.py``)."""
    progs = []
    for mod, names in ((jtr, jax_names), (ptr, pt_names)):
        cfg = _cfg(mod, True)
        cfg.use_flash_attention = False
        with names.guard():
            progs.append(mod.build_wmt_program(cfg, seq_len=SEQ))
    (jmain, jstart, _, _), (pmain, pstart, _, _) = progs
    assert _json(pmain) == _json(jmain) and _json(pstart) == _json(jstart)
    ops = [o.type for o in pmain.global_block().ops]
    assert "flash_attention" not in ops and ops.count("softmax") == 6
    assert [p.name for p in pmain.all_parameters()
            if p.name.startswith("causal_mask")] == [f"causal_mask_{SEQ}"]


def _lr_name(main):
    return next(o for o in main.global_block().ops
                if o.type == "lr_schedule").outputs["Out"][0]


def _masks(main):
    return [o.outputs["Mask"][0] for o in main.global_block().ops
            if o.type == "dropout"]


_REFERENCE = {}


def _reference(amp):
    """The JAX startup's state, the batch, the fetch list and the
    reference's 4 compiled steps (fetches of each), once per dtype."""
    if amp not in _REFERENCE:
        cfg, jmain, jstart, _, jfetch = _build(jtr, jax_names, amp=amp,
                                               warmup_steps=WARMUP)
        jscope, jexe = pt.Scope(), pt.Executor(pt.CPUPlace())
        jexe.run(jstart, scope=jscope, use_compiled=False)
        state = {n: np.array(v) for n, v in jscope.items()}
        batch = jtr.synthetic_batch(cfg, BATCH, SEQ, seed=4)
        fetch = [jfetch["loss"].name, _lr_name(jmain)] + _masks(jmain)
        rows = [jexe.run(jmain, feed=batch, fetch_list=fetch, scope=jscope)
                for _ in range(STEPS)]
        _REFERENCE[amp] = (state, batch, fetch, rows)
    return _REFERENCE[amp]


def _train(amp, use_compiled):
    state, batch, fetch, want = _reference(amp)
    _, pmain, _, _, _ = _build(ptr, pt_names, amp=amp,
                               warmup_steps=WARMUP)
    assert fetch[1] == _lr_name(pmain) and fetch[2:] == _masks(pmain)
    pscope = scope_from_numpy(state, "cpu")
    pexe = Executor(device="cpu")
    got = [pexe.run(pmain, feed=batch, fetch_list=fetch, scope=pscope,
                    use_compiled=use_compiled) for _ in range(STEPS)]
    return want, got


def _noam(k, d_model=128, warmup=WARMUP, scale=2.0):
    s = np.float32(k + 1)
    return np.float32(scale * d_model ** -0.5) * min(
        s ** np.float32(-0.5), s * np.float32(warmup ** -1.5))


def _check_steps(want, got, tol):
    assert len(want[0]) - 2 == 12            # embeddings, 2 + 3 a layer
    for k, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(np.asarray(g[0], np.float32),
                                   np.asarray(w[0], np.float32),
                                   rtol=tol, atol=tol)
        assert np.array_equal(g[1], np.asarray(w[1]))
        np.testing.assert_allclose(g[1], [_noam(k)], rtol=1e-6)
        for wm, gm in zip(w[2:], g[2:]):
            assert gm.dtype == np.uint8 and np.array_equal(gm,
                                                           np.asarray(wm))
    assert not np.array_equal(got[0][2], got[1][2])   # fresh masks
    losses = [float(np.asarray(w[0], np.float32).reshape(())) for w in want]
    assert all(a - b > tol for a, b in zip(losses, losses[1:])), losses


@pytest.mark.parametrize("use_compiled", [False, True])
def test_fp32_training_matches_reference(use_compiled):
    want, got = _train(False, use_compiled)
    _check_steps(want, got, 1e-4)


def test_bf16_amp_training_matches_reference():
    want, got = _train(True, True)
    _check_steps(want, got, 5e-2)


def test_forward_only_program_gives_the_reference_loss():
    progs = [_build(mod, names, with_optimizer=False, is_test=True)
             for mod, names in ((jtr, jax_names), (ptr, pt_names))]
    (cfg, jmain, jstart, _, jfetch), (_, pmain, _, _, pfetch) = progs
    assert _json(pmain) == _json(jmain)
    ops = pmain.global_block().ops
    assert not any(o.type in ("lr_schedule", "adam") for o in ops)
    assert all(o.attrs["is_test"] for o in ops if o.type == "dropout")
    assert all("dropout_prob" not in o.attrs for o in ops
               if o.type == "flash_attention")
    jscope, jexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    jexe.run(jstart, scope=jscope, use_compiled=False)
    state = {n: np.array(v) for n, v in jscope.items()}
    batch = jtr.synthetic_batch(cfg, BATCH, SEQ, seed=5)
    fetch = [jfetch["loss"].name, jfetch["token_num"].name]
    want = jexe.run(jmain, feed=batch, fetch_list=fetch, scope=jscope)
    got = Executor(device="cpu").run(
        pmain, feed=batch, fetch_list=fetch,
        scope=scope_from_numpy(state, "cpu"))
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-5,
                               atol=1e-5)
    assert float(got[1]) == float(np.asarray(want[1])) == \
        batch["lbl_weight"].sum()
