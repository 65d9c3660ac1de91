"""The fleet front end of paddle_tpu_torch held against paddle_tpu on the
CPU: ``DistributedStrategy``, ``fleet.init``, ``distributed_optimizer``
and its meta-optimizer chain (the LAMB/LARS swap, recompute, AMP with
dynamic loss scaling), ``contrib.mixed_precision.decorate`` and
``optimizer_name="lamb"``.

* The reference's own cases (``tests/test_fleet.py``
  ``test_fleet_amp_bf16``, ``_amp_dynamic_loss_scaling``,
  ``_recompute_same_numerics``, ``_lamb_swap`` and
  ``test_strategy_serialization``), imported and run as they are with
  the names they use pointed at the port's.
* ERNIE at 2 layers and a tiny width (hidden 128, 2 heads, FFN 512, seq
  64, batch 4) built with ``with_optimizer=False`` and trained through the
  full chain: ``LambOptimizer`` with ``ClipGradByGlobalNorm(1.0)``, AMP
  (bf16) with dynamic loss scaling from 32768, one recompute checkpoint
  per encoder layer. Both packages give the same JSON, sub-blocks
  included. From the reference's startup state, 3 steps, then 2 with the
  scale set to inf (an overflow whatever the gradients: at the largest
  finite scale whether a step overflows depends on the last bits of the
  cotangents, and the packages disagreed at one step in a CPU run), then
  2 from the scale set back: the losses within 1e-3 (bf16 products
  rounded at different points), every fp32 state tensor within 3e-3 (an
  update of LAMB at lr 1e-3 moves a parameter by up to lr / step; where a
  gradient element is near 0 the bf16 rounding can flip its sign and the
  two packages move it in opposite directions; the worst seen was 1.2e-3
  after 4 steps) and the loss-scaling state (scale, good and bad steps)
  bit for bit after every step. The port's compiled step gives its
  op-by-op run's losses and state bit for bit.
* The refusals: DGC, LocalSGD and sharding, a fleet of two workers, a
  launcher's world of two trainers and the gradient allreduce over two
  ranks raise NotImplementedError. (Gradient merge is in the port:
  ``tests/test_torch_gradient_merge.py``.)
"""

import json
import types

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import clip as jclip
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.core import unique_name as jax_names
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch as ptt
from paddle_tpu_torch import clip as pclip
from paddle_tpu_torch import layers as pl
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.contrib import mixed_precision as pmp
from paddle_tpu_torch.core import unique_name as pt_names
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.scope import scope_from_numpy
from paddle_tpu_torch.distributed import fleet as pfleet
from paddle_tpu_torch.distributed import init_parallel_env
from paddle_tpu_torch.distributed.fleet import meta_optimizers as pmeta
from paddle_tpu_torch.models import bert as pbert

import tests.test_fleet as ref_fleet
from tests.test_torch_recompute import ref_json

torch.set_num_threads(2)


class _PortExecutor:
    """The port's CPU executor under the reference's call signature
    (``Executor(place)``, ``run(..., mesh=None)``): the port has no
    mesh."""

    def __init__(self, place=None):
        self._exe = Executor(device="cpu")

    def run(self, program, feed=None, fetch_list=None, scope=None,
            mesh=None, **kw):
        if mesh is not None:
            raise NotImplementedError("a device mesh is not in the port")
        return self._exe.run(program, feed=feed, fetch_list=fetch_list,
                             scope=scope, **kw)


PORT_PT = types.SimpleNamespace(
    Program=ptt.Program, program_guard=ptt.program_guard,
    Executor=_PortExecutor, CPUPlace=lambda: "cpu", Scope=ptt.Scope,
    optimizer=popt)


@pytest.fixture
def port_in_reference(monkeypatch):
    monkeypatch.setattr(ref_fleet, "pt", PORT_PT)
    monkeypatch.setattr(ref_fleet, "layers", pl)
    monkeypatch.setattr(ref_fleet, "fleet", pfleet)


@pytest.mark.parametrize("case", [
    "test_fleet_amp_bf16", "test_fleet_amp_dynamic_loss_scaling",
    "test_fleet_recompute_same_numerics", "test_fleet_lamb_swap",
    "test_strategy_serialization"])
def test_reference_fleet_case_on_the_port(case, port_in_reference, tmp_path):
    fn = getattr(ref_fleet, case)
    fn(tmp_path) if case == "test_strategy_serialization" else fn()


def test_strategy_files_load_in_either_package(tmp_path):
    for src, dst in ((pfleet, jfleet), (jfleet, pfleet)):
        s = src.DistributedStrategy()
        s.amp, s.recompute, s.lamb = True, True, True
        s.amp_configs = dict(s.amp_configs, use_dynamic_loss_scaling=True)
        s.recompute_configs = {"checkpoints": ["a", "b"]}
        path = tmp_path / "strategy.json"
        s.save_to_file(str(path))
        loaded = dst.DistributedStrategy.load_from_file(str(path))
        assert loaded.to_dict() == s.to_dict()
    assert pfleet.DistributedStrategy().to_dict() == \
        jfleet.DistributedStrategy().to_dict()


def _json(prog):
    return json.loads(json.dumps(prog.to_dict()))


def _mlp(pkg, layers, build_opt):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = layers.data("x", [16])
        label = layers.data("label", [1], dtype="int64")
        logits = layers.fc(layers.fc(x, 32, act="relu"), 5)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        build_opt().minimize(loss)
    return main, startup


@pytest.mark.parametrize("variant", ["decorate", "decorate_static",
                                     "lars", "lamb"])
def test_optimizer_front_ends_build_the_reference_program(variant):
    def build(pkg, mp, fleet):
        def opt():
            if variant.startswith("decorate"):
                return mp.decorate(
                    pkg.optimizer.MomentumOptimizer(0.1),
                    init_loss_scaling=128.0, incr_every_n_steps=10,
                    use_dynamic_loss_scaling=variant == "decorate")
            s = fleet.DistributedStrategy()
            setattr(s, variant, True)
            inner = pkg.optimizer.MomentumOptimizer(0.1) \
                if variant == "lars" else pkg.optimizer.AdamOptimizer(0.01)
            return fleet.distributed_optimizer(inner, s)
        return opt

    with jax_names.guard():
        jm, js = _mlp(pt, pt.layers, build(pt, jmp, jfleet))
    with pt_names.guard():
        pm, ps = _mlp(ptt, pl, build(types.SimpleNamespace(optimizer=popt),
                                     pmp, pfleet))
    assert _json(pm) == _json(jm) and _json(ps) == _json(js)
    want = {"decorate": "update_loss_scaling", "decorate_static": "cast",
            "lars": "lars_momentum", "lamb": "lamb"}[variant]
    assert want in {o.type for o in pm.global_block().ops}


def test_bert_pretraining_program_takes_the_lamb_optimizer():
    kw = dict(vocab_size=512, hidden_size=128, num_hidden_layers=2,
              num_attention_heads=2, intermediate_size=512,
              max_position_embeddings=64, use_flash_attention=True)
    with jax_names.guard():
        j = jbert.build_pretraining_program(jbert.BertConfig(**kw),
                                            seq_len=64,
                                            optimizer_name="lamb")[0]
    with pt_names.guard():
        p = pbert.build_pretraining_program(pbert.BertConfig(**kw),
                                            seq_len=64,
                                            optimizer_name="lamb")[0]
    assert _json(p) == _json(j)
    n_lamb = sum(o.type == "lamb" for o in p.global_block().ops)
    assert n_lamb == len(p.all_parameters()) > 30


# ---------------------------------------------------------------------------
# ERNIE through the whole chain
# ---------------------------------------------------------------------------

TINY = dict(vocab_size=512, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=512,
            max_position_embeddings=64)
SEQ, BATCH, PREDS = 64, 4, 8
LR = 1e-3


def ernie_fleet(bert, names, fleet, clip, opt_mod, pkg, cfg_kw=TINY,
                seq=SEQ, preds=PREDS, recompute=True):
    """ERNIE built without its optimizer, then LAMB with global-norm
    clipping through ``fleet.distributed_optimizer``: AMP (bf16, dynamic
    loss scaling from 32768), recompute at each encoder layer's output,
    the LAMB strategy."""
    cfg = bert.BertConfig(dtype="float32", use_flash_attention=True,
                          **cfg_kw)
    with names.guard():
        main, startup, _, fetches = bert.build_pretraining_program(
            cfg, seq_len=seq, with_optimizer=False,
            max_predictions_per_seq=preds)
        with pkg.program_guard(main, startup):
            s = fleet.DistributedStrategy()
            s.amp = True
            s.amp_configs = dict(s.amp_configs, init_loss_scaling=32768.0,
                                 use_dynamic_loss_scaling=True)
            s.recompute = recompute
            s.recompute_configs = {
                "checkpoints": pbert.encoder_checkpoints(main)}
            s.lamb = True
            opt = opt_mod.LambOptimizer(
                LR, lamb_weight_decay=0.01,
                grad_clip=clip.ClipGradByGlobalNorm(1.0))
            fleet.distributed_optimizer(opt, s).minimize(fetches["loss"])
    return cfg, main, startup, fetches


SCALING = ("loss_scaling_0", "good_steps_0", "bad_steps_0")


def _ls_state(scope):
    return [np.array(scope.find_var(n)) if not isinstance(
        scope.find_var(n), torch.Tensor) else scope.find_var(n).numpy()
        for n in SCALING]


def _set_scale(scopes, value):
    jsc, *pscs = scopes
    jsc.set(SCALING[0], np.full((1,), value, np.float32))
    for sc in pscs:
        sc.find_var(SCALING[0]).fill_(value)   # in place: a compiled step
        # reads the tensor it was built on


def test_ernie_fleet_chain_builds_and_trains_as_the_reference():
    jfleet.init(is_collective=True)
    cfg, jm, js, jf = ernie_fleet(jbert, jax_names, jfleet, jclip,
                                  pt.optimizer, pt)
    _, pm, ps, pf = ernie_fleet(pbert, pt_names, pfleet, pclip, popt, ptt)
    assert len(pm.blocks) == 1 + TINY["num_hidden_layers"]
    assert _json(pm) == ref_json(jm) and _json(ps) == ref_json(js)
    ops = [o.type for o in pm.global_block().ops]
    assert ops.count("block_call") == TINY["num_hidden_layers"]
    assert ops.count("lamb") == len(pm.all_parameters())
    assert {"check_finite_and_unscale", "update_loss_scaling", "cast",
            "elementwise_max", "sqrt", "square"} <= set(ops)
    assert "adamw" not in ops and "flash_attention_grad" not in ops

    jexe, jsc = pt.Executor(pt.CPUPlace()), pt.Scope()
    jexe.run(js, scope=jsc, use_compiled=False)
    state = {n: np.array(v) for n, v in jsc.items()}
    assert set(SCALING) <= set(state)
    op_sc, comp_sc = (scope_from_numpy(state, "cpu") for _ in range(2))
    op_exe, comp_exe = Executor(device="cpu"), Executor(device="cpu")
    batch = jbert.synthetic_pretraining_batch(cfg, BATCH, SEQ, seed=1,
                                              max_predictions_per_seq=PREDS)
    loss = pf["loss"].name
    plan = [None] * 3 + [np.inf, None] + [32768.0, None]
    seen = []
    for step, scale in enumerate(plan):
        if scale is not None:
            _set_scale((jsc, op_sc, comp_sc), scale)
        jv, = jexe.run(jm, feed=batch, fetch_list=[jf["loss"]], scope=jsc,
                       use_compiled=False)
        ov, = op_exe.run(pm, feed=batch, fetch_list=[loss], scope=op_sc,
                         use_compiled=False)
        cv, = comp_exe.run(pm, feed=batch, fetch_list=[loss], scope=comp_sc)
        np.testing.assert_array_equal(cv, ov)
        np.testing.assert_allclose(ov, np.asarray(jv), rtol=1e-3, atol=1e-3,
                                   err_msg=f"step {step}")
        want = _ls_state(jsc)
        for sc in (op_sc, comp_sc):
            for w, g in zip(want, _ls_state(sc)):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w, err_msg=f"step {step}")
        seen.append(tuple(float(a[0]) for a in want))
    assert comp_exe.compiled_builds == 1
    # 3 good steps; two overflows: the scale halves (inf stays inf) and
    # the counters restart; then good steps again from 32768
    assert seen == [(32768.0, 1, 0), (32768.0, 2, 0), (32768.0, 3, 0),
                    (np.inf, 0, 1), (np.inf, 0, 0), (32768.0, 1, 0),
                    (32768.0, 2, 0)]
    for n, v in jsc.items():
        a = np.asarray(v)
        if a.dtype != np.float32 or n in SCALING:
            continue
        g = op_sc.find_var(n).numpy()
        assert np.isfinite(g).all(), n
        np.testing.assert_allclose(g, a, rtol=0, atol=3e-3, err_msg=n)
        assert torch.equal(comp_sc.find_var(n), op_sc.find_var(n)), n


# ---------------------------------------------------------------------------
# what the port refuses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flag", ["dgc", "localsgd", "sharding"])
def test_strategies_outside_the_port_raise(flag):
    s = pfleet.DistributedStrategy()
    setattr(s, flag, True)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        pfleet.distributed_optimizer(popt.SGDOptimizer(0.1), s)


def test_more_than_one_worker_raises(monkeypatch):
    f = pfleet.Fleet().init(pfleet.UserDefinedRoleMaker(0, worker_num=2))
    with pytest.raises(NotImplementedError, match="A8"):
        f.distributed_optimizer(popt.SGDOptimizer(0.1))
    with pytest.raises(NotImplementedError, match="A8"):
        pmeta.insert_grad_allreduce(ptt.Program(), [], 2)
    pmeta.insert_grad_allreduce(ptt.Program(), [], 1)
    assert init_parallel_env() is False
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    with pytest.raises(NotImplementedError, match="A8"):
        init_parallel_env()
    with pytest.raises(NotImplementedError):
        pfleet.Fleet().init()
    monkeypatch.delenv("PADDLE_TRAINERS_NUM")
    f = pfleet.Fleet().init()
    assert (f.worker_num(), f.worker_index(), f.is_first_worker()) == \
        (1, 0, True)
