"""Sub-blocks, ``block_call`` and segment recompute in paddle_tpu_torch,
held against paddle_tpu and against the port's programs without
recompute, on the CPU.

* ``create_block``/``rollback`` as in the reference; a program holding
  ``block_call`` segments (the recompute rewrite) serialises to the
  reference's JSON (its Block-valued attrs written as
  ``{"__block__": idx}``, the form the port writes), loads back to the
  same JSON with each ``sub_block`` the loaded program's own block, and
  clones with its attrs pointing into the clone.
* The seed table: ``rng.seed_slots`` gives every random op of a sub-block
  one slot, keyed by the op itself, which the ``block_call`` and the
  ``__vjp_grad__`` that recomputes it share; ``unseeded_random_ops``
  finds an unseeded dropout inside a sub-block. A compiled step over
  segments holding dropout draws a new mask each step, bit for bit the
  op-by-op run's and the masks of the same program without recompute.
* Gradients and parameters of a recomputed MLP (dropout in the segments)
  and of ERNIE-tiny (flash attention with attention-probs dropout and
  hidden dropout in every segment) within 1e-6 of the program without
  recompute (autograd sums a var's gradient contributions in another
  order than the ``sum`` ops), and ERNIE-tiny with recompute trains 3
  steps to the reference's losses within 1e-4 (fp32).
* ``FlashAttentionFunction``: on the CPU its dq/dk/dv are bit for bit
  ``flash_bwd`` on the same saved Out/Lse (the plain version), with the
  seed as an int and as a 0-d tensor, within 1e-5 of autograd through the
  plain forward, and the op takes it exactly when autograd records.
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import layers as jl
from paddle_tpu.core import unique_name as jax_names
from paddle_tpu.core.ir import Block as JBlock
from paddle_tpu.distributed.fleet.meta_optimizers import \
    RecomputeOptimizer as JRecompute
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch as ptt
from paddle_tpu_torch import layers as pl
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.core import unique_name as pt_names
from paddle_tpu_torch.core.executor import ExecutionError, Executor
from paddle_tpu_torch.core.ir import Block, Program
from paddle_tpu_torch.core.scope import scope_from_numpy
from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
    RecomputeOptimizer
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models import bert as pbert

torch.set_num_threads(2)


def ref_json(prog):
    """The reference program's JSON with its Block-valued attrs in the
    port's form (the reference's ``to_dict`` leaves them Block objects)."""

    def norm(v):
        if isinstance(v, JBlock):
            return {"__block__": v.idx}
        if isinstance(v, dict):
            return {k: norm(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(norm(x) for x in v)
        return v

    return json.loads(json.dumps(norm(prog.to_dict())))


def _json(prog):
    return json.loads(json.dumps(prog.to_dict()))


def test_create_block_and_rollback_as_the_reference():
    for prog in (pt.Program(), ptt.Program()):
        a = prog.create_block()
        b = prog.create_block()
        assert (a.idx, a.parent_idx, b.idx, b.parent_idx) == (1, 0, 2, 1)
        assert prog.current_block() is b
        prog.rollback()
        assert prog.current_block() is a
        prog.rollback()
        assert prog.current_block_idx == 0
        c = prog.create_block(parent_idx=0)
        assert (c.idx, c.parent_idx) == (3, 0)


def _mlp(pkg, layers, opt_mod, recompute_cls, recompute=True, seed=True,
         mask_out=False):
    """fc -> relu -> dropout, twice, then the head; with ``recompute``
    each hidden layer is a segment (its dropout output the checkpoint,
    with ``mask_out`` its mask too, so the call returns it)."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = layers.data("x", [16])
        label = layers.data("label", [1], dtype="int64")
        ckpts, masks, h = [], [], x
        for i in range(2):
            h = layers.fc(h, 32, act="relu")
            h = layers.dropout(h, 0.3, seed=None if seed else 0,
                               dropout_implementation="upscale_in_train")
            if not seed:    # an op without a seed attr draws unseeded
                main.global_block().ops[-1].attrs.pop("seed")
            ckpts.append(h.name)
            masks.append(main.global_block().ops[-1].outputs["Mask"][0])
        logits = layers.fc(h, 5)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        opt = opt_mod.SGDOptimizer(0.1)
        if recompute:
            opt = recompute_cls(opt, ckpts + (masks if mask_out else []))
        opt.minimize(loss)
    return main, startup, loss, masks


def _feed(seed=2):
    r = np.random.RandomState(seed)
    return {"x": r.randn(8, 16).astype(np.float32),
            "label": r.randint(0, 5, (8, 1)).astype(np.int64)}


def test_block_call_program_json_round_trip_and_clone():
    with jax_names.guard():
        jm, js, _, _ = _mlp(pt, jl, pt.optimizer, JRecompute)
    with pt_names.guard():
        pm, ps, _, _ = _mlp(ptt, pl, popt, RecomputeOptimizer)
    calls = [o for o in pm.global_block().ops if o.type == "block_call"]
    assert len(calls) == 2 and len(pm.blocks) == 3
    assert _json(pm) == ref_json(jm) and _json(ps) == ref_json(js)
    text = json.dumps(pm.to_dict())
    assert '"sub_block": {"__block__": 1}' in text
    loaded = Program.from_dict(json.loads(text))
    assert json.dumps(loaded.to_dict()) == text
    for prog in (loaded, pm.clone()):
        assert json.dumps(prog.to_dict()) == text
        subs = [o.attrs["sub_block"] for o in prog.global_block().ops
                if o.type == "block_call"]
        assert subs == prog.blocks[1:] and all(
            isinstance(s, Block) and s.program is prog for s in subs)
        grads = [o for o in prog.global_block().ops
                 if o.type == "__vjp_grad__"
                 and o.attrs["fwd_type"] == "block_call"]
        assert [g.attrs["fwd_attrs"]["sub_block"] for g in grads] == \
            subs[::-1]
    test = pm.clone(for_test=True)
    assert [o.type for o in test.global_block().ops].count("block_call") == 2
    used = {n for blk in test.blocks for o in blk.ops for n in o.input_names()}
    assert used <= set(test.global_block().vars)


def test_seed_slots_cover_sub_block_random_ops():
    with pt_names.guard():
        main, _, _, _ = _mlp(ptt, pl, popt, RecomputeOptimizer)
    ops = main.global_block().ops
    dropouts = [o for blk in main.blocks[1:] for o in blk.ops
                if o.type == "dropout"]
    assert len(dropouts) == 2 and not any(o.type == "dropout" for o in ops)
    slots = rng.seed_slots(ops)
    # one slot a dropout, keyed by the sub-block's op: the call and the
    # __vjp_grad__ that recomputes it bind it alike
    assert [k for k, _ in slots] == dropouts
    assert [s for _, s in slots] == [o.attrs["seed"] for o in dropouts]
    assert rng.unseeded_random_ops(ops) == []
    runs_sub = [i for i, o in enumerate(ops) if rng.sub_blocks(o)]
    assert [ops[i].type for i in runs_sub] == ["block_call"] * 2 + \
        ["__vjp_grad__"] * 2
    with pt_names.guard():
        bad, startup, loss, _ = _mlp(ptt, pl, popt, RecomputeOptimizer,
                                     seed=False)
    assert rng.unseeded_random_ops(bad.global_block().ops) == runs_sub
    exe, scope = Executor(device="cpu"), ptt.Scope()
    exe.run(startup, scope=scope)
    exe.run(bad, feed=_feed(), fetch_list=[loss.name], scope=scope)
    with pytest.raises(ExecutionError, match="carries no seed attr"):
        exe.run(bad, feed=_feed(), fetch_list=[loss.name], scope=scope)


def _params(prog, scope):
    return {p.name: scope.find_var(p.name).clone()
            for p in prog.all_parameters()}


def test_compiled_segments_draw_new_masks_bit_for_bit_the_op_by_op_ones():
    with pt_names.guard():
        rc, startup, loss, masks = _mlp(ptt, pl, popt, RecomputeOptimizer,
                                        mask_out=True)
    with pt_names.guard():
        plain, _, ploss, pmasks = _mlp(ptt, pl, popt, RecomputeOptimizer,
                                       recompute=False)
    assert masks == pmasks
    assert any(masks[0] in o.output_names() for o in rc.global_block().ops
               if o.type == "block_call")
    scope = ptt.Scope()
    Executor(device="cpu").run(startup, scope=scope)
    state = {n: v.numpy().copy() if isinstance(v, torch.Tensor) else v
             for n, v in scope.items()}
    runs = {}
    for name, prog, fetch, compiled in (
            ("op", rc, [loss.name] + masks, False),
            ("compiled", rc, [loss.name] + masks, True),
            ("plain", plain, [ploss.name] + masks, True)):
        exe, sc = Executor(device="cpu"), scope_from_numpy(state, "cpu")
        runs[name] = [exe.run(prog, feed=_feed(), fetch_list=fetch, scope=sc,
                              use_compiled=compiled) for _ in range(4)]
        runs[name + "_params"] = _params(prog, sc)
        if compiled:
            assert exe.compiled_builds == 1
    for a, b in zip(runs["op"], runs["compiled"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for n, t in runs["op_params"].items():
        assert torch.equal(t, runs["compiled_params"][n]), n
    steps = runs["compiled"]
    assert all(not np.array_equal(steps[i][1], steps[i + 1][1])
               for i in range(3))            # a new mask each step
    for a, b in zip(runs["compiled"], runs["plain"]):
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_allclose(a[0], b[0], rtol=1e-6, atol=1e-6)
    for n, t in runs["plain_params"].items():
        np.testing.assert_allclose(runs["compiled_params"][n].numpy(),
                                   t.numpy(), rtol=1e-6, atol=1e-6)


def _grad_names(prog):
    return [prog.grad_var_map[p.name] for p in prog.all_parameters()]


def test_recomputed_mlp_gradients_equal_the_plain_programs():
    with pt_names.guard():
        rc, startup, loss, _ = _mlp(ptt, pl, popt, RecomputeOptimizer)
    with pt_names.guard():
        plain, _, ploss, _ = _mlp(ptt, pl, popt, RecomputeOptimizer,
                                  recompute=False)
    scope = ptt.Scope()
    Executor(device="cpu").run(startup, scope=scope)
    state = {n: v.numpy().copy() if isinstance(v, torch.Tensor) else v
             for n, v in scope.items()}
    got = Executor(device="cpu").run(
        rc, feed=_feed(), fetch_list=[loss.name] + _grad_names(rc),
        scope=scope_from_numpy(state, "cpu"))
    want = Executor(device="cpu").run(
        plain, feed=_feed(), fetch_list=[ploss.name] + _grad_names(plain),
        scope=scope_from_numpy(state, "cpu"))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


TINY = dict(vocab_size=512, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=512,
            max_position_embeddings=64)
SEQ, BATCH, PREDS = 64, 4, 8


def _ernie(bert, names, pkg, opt_mod, recompute_cls, recompute=True):
    cfg = bert.BertConfig(dtype="float32", use_flash_attention=True, **TINY)
    with names.guard():
        main, startup, _, fetches = bert.build_pretraining_program(
            cfg, seq_len=SEQ, with_optimizer=False,
            max_predictions_per_seq=PREDS)
        with pkg.program_guard(main, startup):
            opt = opt_mod.AdamWOptimizer(1e-3, weight_decay=0.01)
            if recompute:
                opt = recompute_cls(opt, pbert.encoder_checkpoints(main))
            opt.minimize(fetches["loss"])
    return cfg, main, startup, fetches


def test_recomputed_ernie_gradients_equal_the_plain_programs():
    """Flash attention with attention-probs dropout and the hidden
    dropouts inside the segments: through ``FlashAttentionFunction`` in
    the recompute, through ``flash_attention_grad`` without."""
    cfg, rc, startup, fetch = _ernie(pbert, pt_names, ptt, popt,
                                     RecomputeOptimizer)
    _, plain, _, pfetch = _ernie(pbert, pt_names, ptt, popt,
                                 RecomputeOptimizer, recompute=False)
    types = [o.type for o in rc.global_block().ops]
    assert types.count("block_call") == 2
    assert "flash_attention_grad" not in types
    assert "flash_attention_grad" in [o.type for o in
                                      plain.global_block().ops]
    scope = ptt.Scope()
    Executor(device="cpu").run(startup, scope=scope)
    state = {n: v.numpy().copy() if isinstance(v, torch.Tensor) else v
             for n, v in scope.items()}
    batch = pbert.synthetic_pretraining_batch(cfg, BATCH, SEQ, seed=1,
                                              max_predictions_per_seq=PREDS)
    out = {}
    for name, prog, f in (("rc", rc, fetch), ("plain", plain, pfetch)):
        sc = scope_from_numpy(state, "cpu")
        out[name] = Executor(device="cpu").run(
            prog, feed=batch, fetch_list=[f["loss"].name] + _grad_names(prog),
            scope=sc)
        out[name + "_params"] = _params(prog, sc)
    assert len(out["rc"]) == len(rc.all_parameters()) + 1
    for g, w in zip(out["rc"], out["plain"]):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    for n, t in out["plain_params"].items():
        np.testing.assert_allclose(out["rc_params"][n].numpy(), t.numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=n)


def test_recomputed_ernie_trains_as_the_reference():
    cfg, jm, js, jf = _ernie(jbert, jax_names, pt, pt.optimizer, JRecompute)
    _, pm, ps, pf = _ernie(pbert, pt_names, ptt, popt, RecomputeOptimizer)
    assert _json(pm) == ref_json(jm) and _json(ps) == ref_json(js)
    jexe, jsc = pt.Executor(pt.CPUPlace()), pt.Scope()
    jexe.run(js, scope=jsc, use_compiled=False)
    psc = scope_from_numpy({n: np.array(v) for n, v in jsc.items()}, "cpu")
    batch = jbert.synthetic_pretraining_batch(cfg, BATCH, SEQ, seed=1,
                                              max_predictions_per_seq=PREDS)
    pexe = Executor(device="cpu")
    for step in range(3):
        jv, = jexe.run(jm, feed=batch, fetch_list=[jf["loss"]], scope=jsc,
                       use_compiled=False)
        pv, = pexe.run(pm, feed=batch, fetch_list=[pf["loss"].name],
                       scope=psc)
        np.testing.assert_allclose(pv, np.asarray(jv), rtol=1e-4, atol=1e-4,
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("layout,causal,bias,rate", [
    ("packed", False, True, 0.1), ("packed", True, False, 0.0),
    ("bnsd", False, False, 0.2)])
@pytest.mark.parametrize("tensor_seed", [False, True])
def test_flash_autograd_function_is_the_direct_backward(layout, causal, bias,
                                                        rate, tensor_seed):
    g = torch.Generator().manual_seed(4)
    b, s, n, hd = 2, 24, 2, 32
    shape = (b, n, s, hd) if layout == "bnsd" else (b, s, n * hd)
    q, k, v, do = (torch.randn(shape, generator=g) for _ in range(4))
    kb = torch.where(torch.rand(b, s, generator=g) < 0.2, -1e4, 0.0) \
        if bias else None
    seed = torch.tensor(12345) if tensor_seed else 12345
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out, lse = fa.flash_attention(*leaves, n, 0.3, causal, kb, rate, seed,
                                  layout)
    assert not lse.requires_grad
    out.backward(do)
    want = fa.flash_bwd(q, k, v, out.detach(), lse, do, n, 0.3, causal, kb,
                        rate, seed, layout)
    for leaf, w in zip(leaves, want[:3]):
        assert torch.equal(leaf.grad, w)
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fa.plain_flash_fwd(*ref, n, 0.3, causal, kb, rate, seed,
                       layout)[0].backward(do)
    for leaf, r in zip(leaves, ref):
        torch.testing.assert_close(leaf.grad, r.grad, rtol=1e-5, atol=1e-5)


def test_flash_op_takes_the_function_only_under_autograd(monkeypatch):
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.ops import attention_ops

    calls = []
    monkeypatch.setattr(attention_ops, "flash_attention",
                        lambda *a: calls.append("fn") or fa.flash_fwd(*a))
    r = torch.Generator().manual_seed(0)
    ins = {s: [torch.randn(2, 16, 64, generator=r)] for s in "QKV"}
    attrs = {"num_heads": 2, "head_dim": 32, "causal": False}
    op = registry.get("flash_attention").forward
    op(ins, attrs)
    with torch.no_grad():
        op({s: [t.requires_grad_(True)] for s, [t] in ins.items()}, attrs)
    assert calls == []
    op(ins, attrs)
    assert calls == ["fn"]
