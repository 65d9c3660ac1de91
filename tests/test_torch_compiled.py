"""The compiled step of paddle_tpu_torch (``Executor.run(use_compiled=
True)``, the default, and the decode engine's per-(phase, bucket)
graphs) on the CPU, where it runs the captured step's callable directly:
static feed buffers, a seed table on the device side, write-back of the
state a lowering writes out of place.

* Against the op-by-op path from one state, bit for bit over 4 steps:
  every fetch (losses, dropout masks), every persistable, the step
  counter; for tiny ERNIE with dropout and flash attention, a tiny
  ResNet-50 (batch norm's running statistics are written out of place and
  copied back into the scope's own tensors) and LeNet (a new batch each
  step).
* The seed table: one slot per random op (dropout, flash_attention, their
  grad ops), each slot ``rng.op_seed`` of its op at steps 0..4, and what
  the table holds after a run.
* ``dropout_keep`` and ``attn_keep`` with the seed as a 0-d int64 (and
  int32 bit pattern) tensor draw the masks of the int seed.
* A program with an op that cannot be replayed raises, with the op's name,
  when a compiled step would be built; op by op it runs.
* Replacing a scope tensor rebuilds the step, which then reads the new
  tensor.
* The decode engine's graph path gives the op-by-op logits bit for bit.
"""

from collections import Counter

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch import layers as players
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.core import unique_name as pt_names
from paddle_tpu_torch.core.executor import (STEP_COUNTER, ExecutionError,
                                            Executor, _CompiledStep)
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.models import bert as pbert
from paddle_tpu_torch.models import decoder_lm as pt_lm
from paddle_tpu_torch.models import lenet as plenet
from paddle_tpu_torch.models import resnet as presnet
from paddle_tpu_torch.serving import decode as pt_decode

torch.set_num_threads(2)

STEPS = 4
ERNIE = dict(vocab_size=512, hidden_size=128, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=512,
             max_position_embeddings=64)


def _ernie():
    cfg = pbert.BertConfig(use_flash_attention=True, **ERNIE)
    with pt_names.guard():
        main, startup, _, fetches = pbert.build_pretraining_program(
            cfg, seq_len=64, optimizer_name="adamw",
            max_predictions_per_seq=8)
    batch = pbert.synthetic_pretraining_batch(cfg, 2, 64, seed=1,
                                              max_predictions_per_seq=8)
    masks = [o.outputs["Mask"][0] for o in main.global_block().ops
             if o.type == "dropout"]
    return main, startup, lambda i: batch, [fetches["loss"].name] + masks


def _resnet():
    cfg = presnet.ResNetConfig(50, 10, (3, 32, 32), stages=[1, 1, 1, 1])
    with pt_names.guard():
        main, startup, _, fetches = presnet.build_classifier_program(
            cfg, batch_size=4, amp=False, lr=0.01)
    batch = presnet.synthetic_batch(cfg, 4, seed=2)
    return main, startup, lambda i: batch, [fetches[k].name for k in
                                            ("loss", "acc1", "acc5")]


def _lenet():
    with pt_names.guard():
        main, startup, _, fetches = plenet.build_lenet_program(4, lr=1e-3)
    r = np.random.RandomState(3)
    batches = [{"img": r.randn(4, 1, 28, 28).astype(np.float32),
                "label": r.randint(0, 10, (4, 1)).astype(np.int64)}
               for _ in range(STEPS)]
    return main, startup, lambda i: batches[i], [fetches["loss"].name,
                                                 fetches["acc"].name]


def _state(startup):
    scope = Scope()
    Executor(device="cpu").run(startup, scope=scope)
    return dict(scope.items())


def _scope(state):
    scope = Scope()
    for n, v in state.items():
        scope.set(n, v.clone() if isinstance(v, torch.Tensor) else v)
    return scope


def _steps(exe, main, scope, feed, fetch, use_compiled):
    return [[np.array(v, copy=True) for v in exe.run(
        main, feed=feed(i), fetch_list=fetch, scope=scope,
        use_compiled=use_compiled)] for i in range(STEPS)]


def _compiled_steps(exe, main):
    return [s for per in exe._compiled[main].values() for s in per.values()
            if isinstance(s, _CompiledStep)]


@pytest.mark.parametrize("model", [_ernie, _resnet, _lenet],
                         ids=["ernie_dropout", "resnet_bn", "lenet"])
def test_compiled_step_equals_op_by_op_bit_for_bit(model):
    main, startup, feed, fetch = model()
    state = _state(startup)
    eager_scope, comp_scope = _scope(state), _scope(state)
    eager = _steps(Executor(device="cpu"), main, eager_scope, feed, fetch,
                   False)
    exe = Executor(device="cpu")
    comp = _steps(exe, main, comp_scope, feed, fetch, True)
    for e, c in zip(eager, comp):
        for x, y in zip(e, c):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    assert len(_compiled_steps(exe, main)) == 1
    names = [n for n, v in eager_scope.items()
             if isinstance(v, torch.Tensor)]
    assert set(names) == {n for n, v in comp_scope.items()
                          if isinstance(v, torch.Tensor)}
    for n in names:
        assert torch.equal(comp_scope.find_var(n), eager_scope.find_var(n)), n
    assert int(comp_scope.find_var(STEP_COUNTER)) == \
        int(eager_scope.find_var(STEP_COUNTER)) == STEPS + 1   # + startup
    # the scope still holds the tensors the step was built on
    (step,) = _compiled_steps(exe, main)
    assert step.holds(comp_scope)


def test_batch_norm_state_is_written_back_into_the_scopes_tensors():
    main, startup, feed, fetch = _resnet()
    scope = _scope(_state(startup))
    exe = Executor(device="cpu")
    exe.run(main, feed=feed(0), fetch_list=fetch, scope=scope)
    stats = {o.outputs["MeanOut"][0] for o in main.global_block().ops
             if o.type in ("batch_norm", "fused_bn_add_act")}
    assert stats
    held = {n: scope.find_var(n) for n in stats}
    before = {n: t.clone() for n, t in held.items()}
    for i in range(1, 3):
        exe.run(main, feed=feed(i), fetch_list=fetch, scope=scope)
    (step,) = _compiled_steps(exe, main)
    assert set(step.written) >= stats
    for n, t in held.items():
        assert scope.find_var(n) is t and not torch.equal(t, before[n]), n


def test_seed_table_holds_op_seed_of_every_random_op():
    main, startup, feed, fetch = _ernie()
    ops = main.global_block().ops
    slots = rng.seed_slots(ops)
    kinds = Counter(ops[i].type for i, _ in slots)
    n_drop = sum(o.type == "dropout" for o in ops)
    assert kinds == {"dropout": n_drop, "flash_attention": 2,
                     "flash_attention_grad": 2, "__vjp_grad__": n_drop}
    seeds = [s for _, s in slots]
    for step in range(STEPS + 1):
        values = rng.seed_values(seeds, step)
        for (i, s), v in zip(slots, values):
            attrs = ops[i].attrs.get("fwd_attrs", ops[i].attrs)
            assert v == rng.op_seed(dict(attrs, __step__=step))
            assert 0 <= v <= rng.M32
    assert len(set(rng.seed_values(seeds, 0))) == len(set(seeds))
    scope = _scope(_state(startup))
    exe = Executor(device="cpu")
    for _ in range(3):
        exe.run(main, feed=feed(0), fetch_list=fetch, scope=scope)
    (step,) = _compiled_steps(exe, main)
    assert step.seeds.dtype == torch.int64
    last = int(scope.find_var(STEP_COUNTER)) - 1   # the last run's step
    assert step.seeds.tolist() == rng.seed_values(seeds, last)


SEEDS = [0, 1, 7, 2 ** 31 - 1, 2 ** 31 + 5, 3735928559, rng.M32]


@pytest.mark.parametrize("seed", SEEDS)
def test_keep_masks_from_a_tensor_seed_equal_the_int_seeds(seed):
    as64 = torch.tensor(seed, dtype=torch.int64)
    as32 = torch.tensor(np.uint32(seed).view(np.int32))   # the same bits
    want = rng.dropout_keep((3, 50, 7), seed, 0.3, "cpu")
    for t in (as64, as32):
        assert torch.equal(rng.dropout_keep((3, 50, 7), t, 0.3, "cpu"), want)
    want = rng.attn_keep(seed, 0.1, 2, 3, 17, 33, "cpu")
    for t in (as64, as32):
        assert torch.equal(rng.attn_keep(t, 0.1, 2, 3, 17, 33, "cpu"), want)
    assert rng.op_seed({"seed": 5, "__step__": 2, "__seed__": as64}) is as64


def test_an_op_that_cannot_be_replayed_raises_with_its_name():
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = players.static_data("x", [2, 4])
        blk = main.global_block()
        noise = blk.create_var(name="noise", shape=[2, 4], dtype="float32")
        blk.append_op("uniform_random", {}, {"Out": [noise]},
                      {"shape": [2, 4], "min": -1.0, "max": 1.0, "seed": 3,
                       "dtype": "float32"})
        y = players.elementwise_add(x, noise)
    feed = {"x": np.ones((2, 4), np.float32)}
    exe, scope = Executor(device="cpu"), Scope()
    exe.run(main, feed=feed, fetch_list=[y], scope=scope)   # op by op
    with pytest.raises(ExecutionError, match="uniform_random"):
        exe.run(main, feed=feed, fetch_list=[y], scope=scope)
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[y], scope=scope,
                use_compiled=False)


def test_a_random_op_without_a_seed_attr_raises_with_its_name():
    """A dropout with no seed attr gets no slot in the seed table: op by
    op it folds the step into seed 0 each step, and a compiled step
    raises when it is built instead of replaying one fixed mask."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = players.static_data("x", [4, 8])
        y = players.dropout(x, 0.5)
    (op,) = [o for o in main.global_block().ops if o.type == "dropout"]
    del op.attrs["seed"]
    assert rng.unseeded_random_ops(main.global_block().ops) == [0]
    feed = {"x": np.ones((4, 8), np.float32)}
    exe, scope = Executor(device="cpu"), Scope()
    first = exe.run(main, feed=feed, fetch_list=[y], scope=scope)[0]
    with pytest.raises(ExecutionError, match="'dropout'.*no seed attr"):
        exe.run(main, feed=feed, fetch_list=[y], scope=scope)
    again = exe.run(main, feed=feed, fetch_list=[y], scope=scope,
                    use_compiled=False)[0]
    assert not np.array_equal(first, again)


def test_a_replaced_scope_tensor_rebuilds_the_step():
    main, startup, feed, fetch = _lenet()
    state = _state(startup)
    scopes = [_scope(state), _scope(state)]
    exes = [Executor(device="cpu"), Executor(device="cpu")]
    for i in range(3):
        for exe, sc, comp in zip(exes, scopes, (False, True)):
            exe.run(main, feed=feed(i), fetch_list=fetch, scope=sc,
                    use_compiled=comp)
    (old,) = _compiled_steps(exes[1], main)
    w = torch.full_like(scopes[0].find_var("fc_0.w_0"), 0.01)
    for sc in scopes:
        sc.set("fc_0.w_0", w.clone())
    got = [[np.array(v, copy=True) for v in exe.run(
        main, feed=feed(3), fetch_list=fetch, scope=sc, use_compiled=comp)]
        for exe, sc, comp in zip(exes, scopes, (False, True))]
    assert all(np.array_equal(a, b) for a, b in zip(*got))
    assert not old.holds(scopes[1])
    got = [exe.run(main, feed=feed(0), fetch_list=fetch, scope=sc,
                   use_compiled=comp)
           for exe, sc, comp in zip(exes, scopes, (False, True))]
    assert all(np.array_equal(a, b) for a, b in zip(*got))
    (new,) = _compiled_steps(exes[1], main)
    assert new is not old and new.holds(scopes[1])


SMALL = dict(vocab_size=256, d_model=128, n_head=2, n_layers=2,
             d_inner=256, max_seq_len=64)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_decode_graph_path_gives_the_op_by_op_logits(quant):
    """Engine A is warmed up (every (phase, bucket) run once on zero feeds
    and captured), so each run below replays; engine B runs each
    (phase, bucket) op by op the first time. Same feeds, same logits."""
    cfg = pt_lm.DecoderLMConfig(**SMALL)
    params = pt_lm.decoder_lm_params(cfg, seed=4)

    def engine():
        return pt_decode.DecodeEngine(cfg, params, pt_decode.DecodeConfig(
            max_slots=2, page_size=8, kv_pages=24, weight_quant=quant,
            prefill_buckets=[32]), device="cpu")

    warm, cold = engine(), engine()
    assert warm.warmup() == 2
    assert set(warm._graphs) == {("step", 2), ("prefill", 32)}
    r = np.random.RandomState(6)
    table = np.zeros((1, warm._mp), np.int32)
    table[0, :3] = [1, 2, 3]
    tokens = np.zeros((1, 32), np.int32)
    tokens[0, :20] = r.randint(3, 256, 20)
    oh = np.zeros((1, 32), np.float32)
    oh[0, 19] = 1.0
    feeds = [("prefill", 32, {"tokens": tokens, "lengths":
                              np.array([20], np.int32), "last_onehot": oh,
                              "page_table": table})]
    for pos in (20, 21, 22):
        step_table = np.zeros((2, warm._mp), np.int32)
        step_table[0] = table[0]
        feeds.append(("step", 2, {
            "tokens": np.array([r.randint(3, 256), 0], np.int32),
            "positions": np.array([pos, 0], np.int32),
            "page_table": step_table}))
    for phase, bucket, feed in feeds:
        a = warm._run(phase, bucket, feed)
        b = cold._run(phase, bucket, feed)
        assert a.dtype == np.float32 and np.array_equal(a, b)
    assert set(cold._graphs) == {("step", 2), ("prefill", 32)}
