"""Transformer-big's unfused attention branch (``use_flash_attention=
False``) in the port, held against the reference's unfused program on the
CPU, at 2+2 layers, d_model 128, 2 heads of 64, d_inner 256, vocab 96,
s32, batch 2, dropout 0.1, Adam under noam with a warm-up of 30 steps.

* Both packages build the same program (JSON), with one causal table
  ``causal_mask_32`` that every decoder self-attention adds and no flash
  op; the table carries across as a parameter (``scope_from_numpy``).
* 4 steps from the JAX startup's state: the losses within 1e-4 in fp32,
  op by op and compiled, every dropout mask bit for bit (the 12 of the
  fused program and the 6 on the attention probabilities), each step's
  loss below the last by more than the tolerance.
* The port's compiled step equals its op-by-op run bit for bit.
* At dropout 0 the unfused program and the fused one (flash op, plain
  version on the CPU) give the same losses within 1e-4 over 3 steps
  from one state.
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


def _cfg(mod, flash=False, dropout=0.1):
    cfg = mod.transformer_big()
    for k, v in TINY.items():
        setattr(cfg, k, v)
    cfg.use_flash_attention = flash
    cfg.dropout = dropout
    return cfg


def _build(mod, names, **kw):
    flash = kw.pop("flash", False)
    dropout = kw.pop("dropout", 0.1)
    cfg = _cfg(mod, flash, dropout)
    with names.guard():
        return (cfg,) + tuple(mod.build_wmt_program(
            cfg, seq_len=SEQ, warmup_steps=WARMUP, **kw))


def _json(prog):
    return json.loads(json.dumps(prog.to_dict()))


def _masks(main):
    return [o.outputs["Mask"][0] for o in main.global_block().ops
            if o.type == "dropout"]


_REF = {}


def _reference():
    if not _REF:
        cfg, jmain, jstart, _, jfetch = _build(jtr, jax_names)
        jscope, jexe = pt.Scope(), pt.Executor(pt.CPUPlace())
        jexe.run(jstart, scope=jscope, use_compiled=False)
        state = {n: np.array(v) for n, v in jscope.items()}
        batch = jtr.synthetic_batch(cfg, BATCH, SEQ, seed=4)
        fetch = [jfetch["loss"].name] + _masks(jmain)
        rows = [jexe.run(jmain, feed=batch, fetch_list=fetch, scope=jscope)
                for _ in range(STEPS)]
        _REF.update(state=state, batch=batch, fetch=fetch, rows=rows,
                    main=jmain, start=jstart)
    return _REF


def test_unfused_program_is_the_reference_program():
    ref = _reference()
    _, pmain, pstart, _, _ = _build(ptr, pt_names)
    assert _json(pmain) == _json(ref["main"])
    assert _json(pstart) == _json(ref["start"])
    ops = [o.type for o in pmain.global_block().ops]
    assert "flash_attention" not in ops and "flash_attention_grad" not in ops
    assert ops.count("softmax") == 6 and len(_masks(pmain)) == 18
    table = ref["state"][f"causal_mask_{SEQ}"]
    np.testing.assert_array_equal(
        table, np.triu(np.full((SEQ, SEQ), -1e9, np.float32), k=1))


def _port_run(use_compiled, state=None):
    ref = _reference()
    _, pmain, _, _, _ = _build(ptr, pt_names)
    pscope = scope_from_numpy(state or ref["state"], "cpu")
    pexe = Executor(device="cpu")
    return [pexe.run(pmain, feed=ref["batch"], fetch_list=ref["fetch"],
                     scope=pscope, use_compiled=use_compiled)
            for _ in range(STEPS)], pscope


@pytest.mark.parametrize("use_compiled", [False, True])
def test_unfused_training_matches_the_reference(use_compiled):
    ref = _reference()
    got, _ = _port_run(use_compiled)
    tol = 1e-4
    for k, (w, g) in enumerate(zip(ref["rows"], got)):
        np.testing.assert_allclose(g[0], np.asarray(w[0]), rtol=tol,
                                   atol=tol, err_msg=f"step {k}")
        for wm, gm in zip(w[1:], g[1:]):
            assert gm.dtype == np.uint8 and np.array_equal(gm,
                                                           np.asarray(wm))
    losses = [float(np.asarray(w[0]).reshape(())) for w in ref["rows"]]
    assert all(a - b > tol for a, b in zip(losses, losses[1:])), losses


def test_compiled_equals_op_by_op_bitwise():
    op_rows, op_scope = _port_run(False)
    cp_rows, cp_scope = _port_run(True)
    for a, b in zip(op_rows, cp_rows):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    for name, t in op_scope.items():
        if isinstance(t, torch.Tensor):
            assert torch.equal(cp_scope.find_var(name), t), name


def test_unfused_agrees_with_the_fused_branch_at_dropout_0():
    """The same weights through both branches: the fused program has no
    causal table, so the unfused one gets the table added to the
    fused program's state."""
    runs = {}
    state = None
    for flash in (False, True):
        cfg, main, start, _, fetch = _build(ptr, pt_names, flash=flash,
                                            dropout=0.0)
        if state is None:
            _, _, jstart, _, _ = _build(jtr, jax_names, dropout=0.0)
            jscope = pt.Scope()
            pt.Executor(pt.CPUPlace()).run(jstart, scope=jscope,
                                           use_compiled=False)
            state = {n: np.array(v) for n, v in jscope.items()}
        names = {p.name for p in main.all_parameters()} | {
            v.name for v in main.global_block().vars.values()
            if v.persistable}
        scope = scope_from_numpy({n: v for n, v in state.items()
                                  if n in names}, "cpu")
        exe = Executor(device="cpu")
        batch = ptr.synthetic_batch(cfg, BATCH, SEQ, seed=7)
        runs[flash] = [float(exe.run(main, feed=batch,
                                     fetch_list=[fetch["loss"].name],
                                     scope=scope)[0].reshape(()))
                       for _ in range(3)]
    np.testing.assert_allclose(runs[False], runs[True], rtol=1e-4, atol=1e-4)
