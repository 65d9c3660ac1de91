"""The training tails of the fleet chain, held against paddle_tpu on the
CPU: the elementwise ops the clips and regularizers emit, the loss-scaling
ops, LAMB and LARS, the regularizers, the clips and the optimizer's
``grad_clip`` / ``regularization`` / ``weight_decay`` arguments.

* Each op runs through its JAX lowering and its torch lowering on the
  same numpy inputs: ``clip``, ``sign``, ``square``, ``sqrt``,
  ``elementwise_max`` and ``isfinite`` forward (bit for bit: one IEEE
  operation an element in both) and, for the differentiable ones, their
  generic ``__vjp_grad__`` (atol 1e-6); ``check_finite_and_unscale`` and
  ``update_loss_scaling`` on both sides of ``FoundInfinite`` and at the
  increment and decrement boundaries, bit for bit (the scale only moves
  by powers of two); ``lamb`` and ``lars_momentum`` for three steps of
  updated state, and at a zero parameter norm, within rtol 1e-5 / atol
  1e-7 (the norms sum in different orders).
* Programs with L2Decay, L1Decay, ``weight_decay=``, a per-parameter
  regularizer and each clip serialise to the reference's JSON and train
  4 steps from the reference's startup state to its losses within 1e-5
  and its parameters within 1e-5 (fp32 throughout).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu import clip as jclip
from paddle_tpu import layers as jl
from paddle_tpu import regularizer as jreg
from paddle_tpu.core import registry as jax_registry
from paddle_tpu.core import unique_name as jax_names
from paddle_tpu.core.ir import OpDesc as JOpDesc

import paddle_tpu_torch as ptt
from paddle_tpu_torch import clip as pclip
from paddle_tpu_torch import layers as pl
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch import regularizer as preg
from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.core import unique_name as pt_names
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.ir import OpDesc as POpDesc
from paddle_tpu_torch.core.scope import scope_from_numpy
from paddle_tpu_torch.core.selected_rows import SelectedRows

torch.set_num_threads(2)


def _jax_op(op_type, ins, attrs):
    return jax_registry.normalize_outputs(jax_registry.get(op_type).forward(
        {k: [jnp.asarray(a) for a in v] for k, v in ins.items()},
        dict(attrs)))


def _pt_op(op_type, ins, attrs):
    return pt_registry.normalize_outputs(pt_registry.get(op_type).forward(
        {k: [torch.from_numpy(np.array(a)) for a in v]
         for k, v in ins.items()}, dict(attrs)))


def _f(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the elementwise ops of the clips and the regularizers
# ---------------------------------------------------------------------------

def _ew_case(name, rng):
    x = _f(rng, 4, 7)
    x[0, :3] = 0.0                     # sign(0), sqrt(0)
    if name == "clip":
        return {"X": [x]}, {"min": -0.5, "max": 0.75}
    if name == "sqrt":
        return {"X": [np.abs(x)]}, {}
    if name == "elementwise_max":
        return {"X": [x], "Y": [_f(rng, 7)]}, {"axis": -1}
    if name == "elementwise_max[scalar]":
        return {"X": [np.abs(_f(rng, 1))], "Y": [np.full((1,), 1.0,
                                                        np.float32)]}, \
            {"axis": -1}
    if name.startswith("isfinite"):
        if name.endswith("[inf]"):
            x[2, 3] = np.inf
        if name.endswith("[nan]"):
            x[1, 1] = np.nan
        return {"X": [x]}, {}
    return {"X": [x]}, {}


EW_CASES = ["clip", "sign", "square", "sqrt", "elementwise_max",
            "elementwise_max[scalar]", "isfinite", "isfinite[inf]",
            "isfinite[nan]"]


@pytest.mark.parametrize("case", EW_CASES)
def test_elementwise_op_matches_reference(case):
    rng = np.random.RandomState(sum(map(ord, case)))
    op_type = case.split("[")[0]
    ins, attrs = _ew_case(case, rng)
    want, got = _jax_op(op_type, ins, attrs), _pt_op(op_type, ins, attrs)
    assert set(got) == set(want)
    for slot, vals in want.items():
        w, g = np.asarray(vals[0]), got[slot][0].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, slot
        np.testing.assert_array_equal(g, w, err_msg=slot)


@pytest.mark.parametrize("case", ["clip", "sign", "square", "sqrt",
                                  "elementwise_max"])
def test_elementwise_op_vjp_grad_matches_reference(case):
    """Both packages make the same generic grad op, and its lowering
    gives the same input gradients (atol 1e-6)."""
    rng = np.random.RandomState(3)
    ins, attrs = _ew_case(case, rng)
    if case == "sqrt":
        ins = {"X": [ins["X"][0] + 0.1]}     # d sqrt at 0 is inf in both
    outs = _jax_op(case, ins, attrs)
    in_names = {s: [f"{s}_{i}" for i in range(len(v))] for s, v in ins.items()}
    out_names = {s: [f"{s}_{i}" for i in range(len(v))]
                 for s, v in outs.items()}
    out_grads = {s: [f"{n}@GRAD" for n in names]
                 for s, names in out_names.items()}
    in_grads = {s: [f"{n}@GRAD" for n in names]
                for s, names in in_names.items()}
    (jg,) = jax_registry.default_grad_maker(
        JOpDesc(case, in_names, out_names, attrs), out_grads, in_grads)
    (pg,) = pt_registry.default_grad_maker(
        POpDesc(case, in_names, out_names, attrs), out_grads, in_grads)
    assert json.dumps(pg.to_dict(), sort_keys=True) == \
        json.dumps(jg.to_dict(), sort_keys=True)
    env = {n: a for s, names in in_names.items()
           for n, a in zip(names, ins[s])}
    env.update({f"{n}@GRAD": _f(rng, *np.shape(o)) for s, names in
                out_names.items() for n, o in zip(names, outs[s])})
    g_ins = {slot: [env[n] for n in names]
             for slot, names in jg.inputs.items()}
    want = _jax_op("__vjp_grad__", g_ins, jg.attrs)
    got = _pt_op("__vjp_grad__", g_ins, jg.attrs)
    for slot, vals in want.items():
        for w, g in zip(vals, got[slot]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-6, err_msg=slot)


# ---------------------------------------------------------------------------
# dynamic loss scaling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("poison", [None, np.inf, -np.inf, np.nan])
def test_check_finite_and_unscale_matches_reference(poison):
    rng = np.random.RandomState(11)
    xs = [_f(rng, 5, 3) * 1024, _f(rng, 8) * 1024, _f(rng, 2, 2, 2) * 1024]
    if poison is not None:
        xs[1][4] = poison
    ins = {"X": xs, "Scale": [np.full((1,), 1024.0, np.float32)]}
    want, got = _jax_op("check_finite_and_unscale", ins, {}), \
        _pt_op("check_finite_and_unscale", ins, {})
    assert got["FoundInfinite"][0].dtype == torch.bool
    np.testing.assert_array_equal(got["FoundInfinite"][0].numpy(),
                                  np.asarray(want["FoundInfinite"][0]))
    assert bool(got["FoundInfinite"][0][0]) == (poison is not None)
    for w, g in zip(want["Out"], got["Out"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("found,good,bad,attrs", [
    (False, 0, 0, {}),                                  # a good step
    (False, 999, 1, {}),                                # incr: 1000 good
    (False, 2, 0, {"incr_every_n_steps": 3, "incr_ratio": 4.0}),
    (True, 7, 0, {}),                                   # a first bad step
    (True, 0, 1, {}),                                   # decr: 2 bad
    (True, 0, 2, {"decr_every_n_nan_or_inf": 3, "decr_ratio": 0.25}),
])
@pytest.mark.parametrize("scale", [32768.0, 1.5])       # 1.5 * 0.5 -> 1
def test_update_loss_scaling_matches_reference(found, good, bad, attrs,
                                               scale):
    rng = np.random.RandomState(5)
    xs = [_f(rng, 4, 3), _f(rng, 6)]
    xs[0][1, 1] = np.nan if found else xs[0][1, 1]
    ins = {"X": xs, "FoundInfinite": [np.array([found])],
           "PrevLossScaling": [np.full((1,), scale, np.float32)],
           "InGoodSteps": [np.array([good], np.int32)],
           "InBadSteps": [np.array([bad], np.int32)]}
    want = _jax_op("update_loss_scaling", ins, attrs)
    got = _pt_op("update_loss_scaling", ins, attrs)
    assert set(got) == set(want)
    for slot, vals in want.items():
        for w, g in zip(vals, got[slot]):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype, slot
            np.testing.assert_array_equal(g.numpy(), w, err_msg=slot)
    if found:
        assert all(not g.any() for g in got["Out"])


# ---------------------------------------------------------------------------
# LAMB and LARS
# ---------------------------------------------------------------------------

def _opt_state(rng, kind, zero_param):
    p = np.zeros((6, 5), np.float32) if zero_param else _f(rng, 6, 5)
    state = {"Param": p, "LearningRate": np.full((1,), 0.01, np.float32)}
    if kind == "lamb":
        state.update(Moment1=np.zeros((6, 5), np.float32),
                     Moment2=np.zeros((6, 5), np.float32),
                     Beta1Pow=np.full((1,), 0.9, np.float32),
                     Beta2Pow=np.full((1,), 0.999, np.float32))
    else:
        state["Velocity"] = np.zeros((6, 5), np.float32)
    return state


OUT_OF = {"Param": "ParamOut", "Moment1": "Moment1Out",
          "Moment2": "Moment2Out", "Beta1Pow": "Beta1PowOut",
          "Beta2Pow": "Beta2PowOut", "Velocity": "VelocityOut"}


@pytest.mark.parametrize("kind,attrs", [
    ("lamb", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
              "weight_decay": 0.01}),
    ("lamb", {"beta1": 0.8, "beta2": 0.99, "epsilon": 1e-4,
              "weight_decay": 0.0}),
    ("lars_momentum", {"mu": 0.9, "lars_coeff": 0.001,
                       "lars_weight_decay": 0.0005}),
    ("lars_momentum", {"mu": 0.5, "lars_coeff": 0.02,
                       "lars_weight_decay": 0.0})])
@pytest.mark.parametrize("zero_param", [False, True])
def test_large_batch_update_matches_reference(kind, attrs, zero_param):
    """Three steps of the op on its own outputs: the port updates its
    tensors in place, the reference returns new ones. A zero parameter
    (zero norm) takes the trust ratio 1 (LAMB) or local lr 0 (LARS)."""
    rng = np.random.RandomState(17)
    jstate = _opt_state(rng, kind, zero_param)
    pstate = {k: torch.from_numpy(v.copy()) for k, v in jstate.items()}
    for step in range(3):
        g = _f(rng, 6, 5)
        want = _jax_op(kind, {k: [v] for k, v in
                              dict(jstate, Grad=g).items()}, attrs)
        got = pt_registry.normalize_outputs(pt_registry.get(kind).forward(
            {k: [v] for k, v in dict(pstate, Grad=torch.from_numpy(
                g.copy())).items()}, dict(attrs)))
        for slot, out in OUT_OF.items():
            if slot not in jstate:
                continue
            assert got[out][0] is pstate[slot]            # in place
            np.testing.assert_allclose(
                pstate[slot].numpy(), np.asarray(want[out][0]), rtol=1e-5,
                atol=1e-7, err_msg=f"{kind} step {step} {out}")
            jstate[slot] = np.asarray(want[out][0])
        assert np.isfinite(pstate["Param"].numpy()).all()
    if zero_param and kind == "lars_momentum":
        assert not pstate["Param"].numpy().any()          # local lr 0


def test_sparse_gradients_stay_refused():
    """LAMB has no SelectedRows branch in either package: a sparse
    gradient is densified (the reference's ``_dense_grad``), so it
    updates as its dense form does."""
    rng = np.random.RandomState(0)
    state = dict(_opt_state(rng, "lamb", False), Grad=_f(rng, 6, 5))
    outs = []
    for sparse in (False, True):
        ins = {k: [torch.from_numpy(v.copy())] for k, v in state.items()}
        g = ins["Grad"][0]
        if sparse:      # every row, twice, in halves
            rows = torch.arange(g.shape[0]).repeat(2)
            ins["Grad"] = [SelectedRows(rows, torch.cat([g / 2, g / 2]),
                                        g.shape[0])]
        outs.append(pt_registry.get("lamb").forward(ins, {}))
    for slot in outs[0]:
        np.testing.assert_allclose(outs[1][slot].numpy(),
                                   outs[0][slot].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=slot)


# ---------------------------------------------------------------------------
# regularizers, clips and the optimizer arguments, as programs
# ---------------------------------------------------------------------------

def _json(prog):
    return json.loads(json.dumps(prog.to_dict()))


def _mlp(pkg, layers, opt_mod, reg_mod, clip_mod, variant):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = layers.data("x", [16])
        label = layers.data("label", [1], dtype="int64")
        h = layers.fc(x, 32, act="relu")
        logits = layers.fc(h, 5)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        kw = {}
        if variant == "l2":
            kw["regularization"] = reg_mod.L2Decay(0.01)
        elif variant == "l1":
            kw["regularization"] = reg_mod.L1Decay(0.02)
        elif variant == "weight_decay":
            kw["weight_decay"] = 0.05
        elif variant == "param_l1":
            w = main.global_block().all_parameters()[0]
            w.regularizer = reg_mod.L1Decay(0.1)
            kw["regularization"] = reg_mod.L2Decay(0.01)
        elif variant == "value":
            kw["grad_clip"] = clip_mod.ClipGradByValue(0.05)
        elif variant == "norm":
            kw["grad_clip"] = clip_mod.ClipGradByNorm(0.1)
        elif variant == "global_norm":
            kw["grad_clip"] = clip_mod.ClipGradByGlobalNorm(0.1)
        elif variant == "lars":
            opt = opt_mod.LarsMomentumOptimizer(0.1, momentum=0.9, **kw)
        if variant == "lamb":
            opt = opt_mod.LambOptimizer(0.01, grad_clip=clip_mod.
                                        ClipGradByGlobalNorm(0.5))
        elif variant != "lars":
            opt = opt_mod.MomentumOptimizer(0.1, momentum=0.9, **kw)
        opt.minimize(loss)
    return main, startup, loss


VARIANTS = ["l2", "l1", "weight_decay", "param_l1", "value", "norm",
            "global_norm", "lars", "lamb"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_regularized_and_clipped_program_trains_as_the_reference(variant):
    with jax_names.guard():
        jm, js, jloss = _mlp(pt, jl, pt.optimizer, jreg, jclip, variant)
    with pt_names.guard():
        pm, ps, ploss = _mlp(ptt, pl, popt, preg, pclip, variant)
    assert _json(pm) == _json(jm) and _json(ps) == _json(js)
    types = {o.type for o in pm.global_block().ops}
    emitted = {"l2": {"scale", "sum"}, "l1": {"sign", "scale", "sum"},
               "weight_decay": {"scale", "sum"},
               "param_l1": {"sign", "scale", "sum"}, "value": {"clip"},
               "norm": {"square", "sqrt", "elementwise_max"},
               "global_norm": {"square", "sqrt", "elementwise_max"},
               "lars": {"lars_momentum"},
               "lamb": {"lamb", "square", "sqrt"}}[variant]
    assert emitted <= types
    jexe, jsc = pt.Executor(pt.CPUPlace()), pt.Scope()
    jexe.run(js, scope=jsc, use_compiled=False)
    psc = scope_from_numpy({n: np.array(v) for n, v in jsc.items()}, "cpu")
    pexe = Executor(device="cpu")
    rng = np.random.RandomState(2)
    feed = {"x": _f(rng, 12, 16),
            "label": rng.randint(0, 5, (12, 1)).astype(np.int64)}
    for step in range(4):
        jv, = jexe.run(jm, feed=feed, fetch_list=[jloss], scope=jsc,
                       use_compiled=False)
        pv, = pexe.run(pm, feed=feed, fetch_list=[ploss.name], scope=psc)
        np.testing.assert_allclose(pv, np.asarray(jv), rtol=1e-5, atol=1e-5,
                                   err_msg=f"{variant} step {step}")
    for p in pm.all_parameters():
        np.testing.assert_allclose(psc.find_var(p.name).numpy(),
                                   np.asarray(jsc.find_var(p.name)),
                                   rtol=1e-5, atol=1e-5, err_msg=p.name)
