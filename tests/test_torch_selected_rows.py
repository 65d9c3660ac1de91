"""SelectedRows gradients in the port, held against paddle_tpu on the CPU.

* The value type: ``lookup_table_sparse_grad`` emits a SelectedRows of
  the looked-up ids (padding rows zeroed, an out-of-range id given the
  sentinel row), ``to_dense`` and ``merge_duplicates`` against the
  reference's on the same rows and values (rows exact, values within
  1e-6: float32 sums in another order), ``concat``.
* Per op, the same numpy state and SelectedRows through both lowerings:
  ``sgd``, ``momentum`` (plain, nesterov, l2_decay), lazy ``adam`` and
  ``adamw``, with duplicate rows, within rtol 1e-6 / atol 1e-6; rows no
  id touched are bit for bit unchanged in the parameter and every slot;
  ``lamb``, ``lars_momentum`` and non-lazy ``adam`` densify, so a
  SelectedRows updates as its dense form does.
* Per program: the reference's own cases (``tests/test_selected_rows.py``
  ``_build``, imported) built in both packages serialise to the same
  JSON and train 4 steps from the reference's startup state to its
  losses and its table within 1e-5, op by op and compiled; the port's
  compiled step equals its op-by-op run bit for bit; the sparse program
  equals the dense one within 1e-6.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu.core import registry as jax_registry
from paddle_tpu.core import selected_rows as jsr
from paddle_tpu.core import unique_name as jax_names

import paddle_tpu_torch as ptt
from paddle_tpu_torch import initializer as pinit
from paddle_tpu_torch import layers as pl
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.core import selected_rows as psr
from paddle_tpu_torch.core import unique_name as pt_names
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.scope import scope_from_numpy
from paddle_tpu_torch.param_attr import ParamAttr

import tests.test_selected_rows as ref_cases

torch.set_num_threads(2)

V, D = 12, 5
ROWS = np.array([3, 7, 3, 0, 11, 7, 3], np.int64)   # duplicates


def _vals(seed, n=len(ROWS)):
    return np.random.RandomState(seed).randn(n, D).astype(np.float32)


def _jsr(rows, vals):
    return jsr.SelectedRows(jnp.asarray(rows, jnp.int32), jnp.asarray(vals),
                            V)


def _psr(rows, vals):
    return psr.SelectedRows(torch.from_numpy(np.array(rows)),
                            torch.from_numpy(np.array(vals)), V)


# ---------------------------------------------------------------------------
# the value type
# ---------------------------------------------------------------------------

def test_sparse_grad_object():
    """The reference's ``test_sparse_grad_object`` on the port: the grad
    is a SelectedRows (not a densified tensor); a duplicate row sums."""
    fwd = pt_registry.get("lookup_table_sparse_grad").forward
    out = fwd({"Ids": [torch.tensor([[1, 2, 2]], dtype=torch.int32)],
               "W": [torch.zeros(10, 4)], "OutGrad": [torch.ones(1, 3, 4)]},
              {"padding_idx": -1})["WGrad"]
    assert isinstance(out, psr.SelectedRows)
    assert out.height == 10 and tuple(out.values.shape) == (3, 4)
    assert out.shape == (10, 4) and out.dtype == torch.float32
    assert out.to_dense()[2].sum().item() == 8.0


@pytest.mark.parametrize("ids,pad", [([[1, 4, 4, 0]], -1), ([[1, 4, 4, 0]], 4),
                                     ([[-1, 9, 2, -11]], -1)])
def test_lookup_sparse_grad_densifies_as_the_reference(ids, pad):
    """Padding rows get zero values; a negative id wraps; an id out of
    range adds nothing (the reference's scatter drops it)."""
    ids = np.asarray(ids, np.int32)
    w = np.zeros((10, 3), np.float32)
    og = np.random.RandomState(1).randn(1, 4, 3).astype(np.float32)
    attrs = {"padding_idx": pad}
    want = jax_registry.get("lookup_table_sparse_grad").forward(
        {"Ids": [jnp.asarray(ids)], "W": [jnp.asarray(w)],
         "OutGrad": [jnp.asarray(og)]}, attrs)["WGrad"]
    got = pt_registry.get("lookup_table_sparse_grad").forward(
        {"Ids": [torch.from_numpy(ids)], "W": [torch.from_numpy(w)],
         "OutGrad": [torch.from_numpy(og)]}, attrs)["WGrad"]
    np.testing.assert_array_equal(got.to_dense().numpy(),
                                  np.asarray(want.to_dense()))


def test_merge_duplicates_and_concat_match_the_reference():
    vals = _vals(0)
    jr, jv = jsr.merge_duplicates(_jsr(ROWS, vals))
    pr, pv = psr.merge_duplicates(_psr(ROWS, vals))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-6)
    both = psr.concat([_psr(ROWS, vals), _psr(ROWS[:3], vals[:3])])
    jboth = jsr.concat([_jsr(ROWS, vals), _jsr(ROWS[:3], vals[:3])])
    np.testing.assert_allclose(both.to_dense().numpy(),
                               np.asarray(jboth.to_dense()), rtol=1e-6,
                               atol=1e-6)
    rows_w, _, live = psr.write_slots(_psr(ROWS, vals))
    assert live.all() and set(rows_w.tolist()) == {0, 3, 7, 11}


# ---------------------------------------------------------------------------
# the optimizer ops, per op
# ---------------------------------------------------------------------------

SPARSE_OPS = {
    "sgd": {},
    "momentum": {"mu": 0.9},
    "momentum[nesterov]": {"mu": 0.8, "use_nesterov": True},
    "momentum[l2_decay]": {"mu": 0.9, "regularization_method": "l2_decay",
                           "regularization_coeff": 0.01},
    "adam[lazy]": {"lazy_mode": True, "beta1": 0.9, "beta2": 0.999,
                   "epsilon": 1e-8},
    "adamw[lazy]": {"lazy_mode": True, "beta1": 0.8, "beta2": 0.99,
                    "epsilon": 1e-6, "coeff": 0.05, "with_decay": True},
    "lamb": {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
             "weight_decay": 0.01},
    "lars_momentum": {"mu": 0.9, "lars_coeff": 0.001,
                      "lars_weight_decay": 0.0005},
    "adam[dense]": {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
}
STATE_OUT = {"Param": "ParamOut", "Velocity": "VelocityOut",
             "Moment1": "Moment1Out", "Moment2": "Moment2Out",
             "Beta1Pow": "Beta1PowOut", "Beta2Pow": "Beta2PowOut"}


def _state(op_type, rng):
    s = {"Param": rng.randn(V, D).astype(np.float32),
         "LearningRate": np.full((1,), 0.05, np.float32)}
    if op_type in ("momentum", "lars_momentum"):
        s["Velocity"] = rng.randn(V, D).astype(np.float32) * 0.1
    if op_type in ("adam", "adamw", "lamb"):
        s.update(Moment1=rng.randn(V, D).astype(np.float32) * 0.01,
                 Moment2=rng.rand(V, D).astype(np.float32) * 1e-3,
                 Beta1Pow=np.full((1,), 0.9 ** 3, np.float32),
                 Beta2Pow=np.full((1,), 0.999 ** 3, np.float32))
    return s


@pytest.mark.parametrize("case", sorted(SPARSE_OPS))
def test_optimizer_op_with_a_selected_rows_grad_matches_the_reference(case):
    op_type = case.split("[")[0]
    attrs = SPARSE_OPS[case]
    rng = np.random.RandomState(4)
    state = _state(op_type, rng)
    jstate = {k: np.array(v) for k, v in state.items()}
    pstate = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    for step in range(3):
        vals = _vals(10 + step)
        want = jax_registry.normalize_outputs(
            jax_registry.get(op_type).forward(
                dict({k: [jnp.asarray(v)] for k, v in jstate.items()},
                     Grad=[_jsr(ROWS, vals)]), dict(attrs)))
        got = pt_registry.normalize_outputs(pt_registry.get(op_type).forward(
            dict({k: [v] for k, v in pstate.items()},
                 Grad=[_psr(ROWS, vals)]), dict(attrs)))
        for slot, out in STATE_OUT.items():
            if slot not in jstate:
                continue
            assert got[out][0] is pstate[slot]             # in place
            np.testing.assert_allclose(
                pstate[slot].numpy(), np.asarray(want[out][0]), rtol=1e-6,
                atol=1e-6, err_msg=f"{case} step {step} {out}")
            jstate[slot] = np.asarray(want[out][0])
    if op_type in ("sgd", "momentum", "adam", "adamw") and \
            "dense" not in case:
        untouched = np.setdiff1d(np.arange(V), ROWS)
        for slot in ("Param", "Velocity", "Moment1", "Moment2"):
            if slot in state:
                np.testing.assert_array_equal(
                    pstate[slot].numpy()[untouched],
                    state[slot][untouched], err_msg=slot)


def test_sparse_update_with_every_id_out_of_range_changes_nothing():
    rng = np.random.RandomState(2)
    state = _state("adam", rng)
    pstate = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    g = psr.SelectedRows(torch.full((4,), V), torch.ones(4, D), V)
    pt_registry.get("adam").forward(
        dict({k: [v] for k, v in pstate.items()}, Grad=[g]),
        dict(SPARSE_OPS["adam[lazy]"]))
    for slot in ("Param", "Moment1", "Moment2"):
        np.testing.assert_array_equal(pstate[slot].numpy(), state[slot])


# ---------------------------------------------------------------------------
# programs: the reference's cases
# ---------------------------------------------------------------------------

def _port_build(is_sparse, optimizer="sgd", two_lookups=False):
    """``tests/test_selected_rows.py`` ``_build`` with the port's API, plus
    lazy AdamW."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        ids = pl.data("ids", [6], dtype="int64", stop_gradient=True)
        emb = pl.embedding(
            ids, [50, 8], is_sparse=is_sparse,
            param_attr=ParamAttr(name="emb_w",
                                 initializer=pinit.Xavier(seed=5)))
        if two_lookups:
            ids2 = pl.data("ids2", [6], dtype="int64", stop_gradient=True)
            emb = emb + pl.embedding(ids2, [50, 8], is_sparse=is_sparse,
                                     param_attr=ParamAttr(name="emb_w"))
        h = pl.reduce_mean(emb, dim=1)
        loss = pl.mean(pl.reduce_sum(h * h, dim=1, keep_dim=True))
        if optimizer == "sgd":
            popt.SGDOptimizer(0.5).minimize(loss)
        elif optimizer == "adam_lazy":
            popt.AdamOptimizer(0.01, lazy_mode=True).minimize(loss)
        elif optimizer == "adamw_lazy":
            popt.AdamWOptimizer(0.01, weight_decay=0.02,
                                lazy_mode=True).minimize(loss)
        elif optimizer == "momentum":
            popt.MomentumOptimizer(0.1, momentum=0.9).minimize(loss)
        else:
            popt.AdamOptimizer(0.01).minimize(loss)
    return main, startup, loss


def _ref_build(is_sparse, optimizer, two_lookups):
    if optimizer != "adamw_lazy":
        return ref_cases._build(is_sparse, optimizer, two_lookups)
    from paddle_tpu import layers as jl
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        ids = jl.data("ids", [6], dtype="int64", stop_gradient=True)
        emb = jl.embedding(
            ids, [50, 8], is_sparse=is_sparse,
            param_attr=pt.ParamAttr(
                name="emb_w", initializer=pt.initializer.Xavier(seed=5)))
        if two_lookups:
            ids2 = jl.data("ids2", [6], dtype="int64", stop_gradient=True)
            emb = emb + jl.embedding(ids2, [50, 8], is_sparse=is_sparse,
                                     param_attr=pt.ParamAttr(name="emb_w"))
        h = jl.reduce_mean(emb, dim=1)
        loss = jl.mean(jl.reduce_sum(h * h, dim=1, keep_dim=True))
        pt.optimizer.AdamWOptimizer(0.01, weight_decay=0.02,
                                    lazy_mode=True).minimize(loss)
    return main, startup, loss


def _feed(two_lookups, dup_ids, step):
    rng = np.random.RandomState(step)
    feed = {"ids": np.array([[1, 7, 7, 3, 49, 7]] * 2, np.int64)
            if dup_ids else rng.randint(0, 50, (2, 6)).astype(np.int64)}
    if two_lookups:
        feed["ids2"] = rng.randint(0, 50, (2, 6)).astype(np.int64)
    return feed


def _json(prog):
    return json.loads(json.dumps(prog.to_dict()))


def _run_both(is_sparse, optimizer, two_lookups, dup_ids, use_compiled,
              steps=4):
    with jax_names.guard():
        jm, js, jloss = _ref_build(is_sparse, optimizer, two_lookups)
    with pt_names.guard():
        pm, ps, ploss = _port_build(is_sparse, optimizer, two_lookups)
    assert _json(pm) == _json(jm) and _json(ps) == _json(js)
    jexe, jsc = pt.Executor(pt.CPUPlace()), pt.Scope()
    jexe.run(js, scope=jsc, use_compiled=False)
    state = {n: np.array(v) for n, v in jsc.items()}
    psc = scope_from_numpy(state, "cpu")
    pexe = Executor(device="cpu")
    jl_, pl_ = [], []
    for step in range(steps):
        feed = _feed(two_lookups, dup_ids, step)
        jv, = jexe.run(jm, feed=feed, fetch_list=[jloss], scope=jsc,
                       use_compiled=False)
        pv, = pexe.run(pm, feed=feed, fetch_list=[ploss.name], scope=psc,
                       use_compiled=use_compiled)
        jl_.append(float(np.asarray(jv).reshape(-1)[0]))
        pl_.append(float(pv.reshape(-1)[0]))
    return (jl_, np.asarray(jsc.find_var("emb_w")), pl_,
            psc.find_var("emb_w").numpy(), pm, state)


CASES = [("sgd", False, False), ("sgd", True, False), ("sgd", False, True),
         ("momentum", False, False), ("momentum", True, False),
         ("adam_lazy", False, False), ("adam_lazy", True, False),
         ("adam_lazy", False, True), ("adamw_lazy", True, False),
         ("adam", False, False)]


@pytest.mark.parametrize("use_compiled", [False, True])
@pytest.mark.parametrize("optimizer,dup_ids,two_lookups", CASES)
def test_sparse_program_trains_as_the_reference(optimizer, dup_ids,
                                                two_lookups, use_compiled):
    jl_, jw, pl_, pw, pm, _ = _run_both(True, optimizer, two_lookups,
                                        dup_ids, use_compiled)
    types = [o.type for o in pm.global_block().ops]
    assert "lookup_table_sparse_grad" in types
    if two_lookups:
        assert "sum" in types
    np.testing.assert_allclose(pl_, jl_, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pw, jw, rtol=1e-5, atol=1e-6)


def _port_train(is_sparse, optimizer, two_lookups, dup_ids, state,
                use_compiled, steps=4):
    with pt_names.guard():
        pm, _, ploss = _port_build(is_sparse, optimizer, two_lookups)
    psc = scope_from_numpy(state, "cpu")
    pexe = Executor(device="cpu")
    losses = []
    for step in range(steps):
        pv, = pexe.run(pm, feed=_feed(two_lookups, dup_ids, step),
                       fetch_list=[ploss.name], scope=psc,
                       use_compiled=use_compiled)
        losses.append(pv)
    return np.stack(losses), psc


@pytest.mark.parametrize("optimizer,dup_ids,two_lookups,dense", [
    ("sgd", True, True, "sgd"), ("sgd", False, True, "sgd"),
    ("momentum", True, False, "momentum"), ("adam_lazy", True, False, "adam"),
    ("adam_lazy", False, True, None), ("adamw_lazy", False, False, None)])
def test_compiled_equals_op_by_op_and_sparse_equals_dense(optimizer, dup_ids,
                                                          two_lookups, dense):
    """Compiled = op by op bit for bit. Where the dense program must give
    the same update (SGD always; momentum and lazy Adam over a fixed id
    set, whose untouched rows have zero state), sparse = dense within
    1e-6: the sums of duplicate rows run in another order."""
    with jax_names.guard():
        _, js, _ = _ref_build(True, optimizer, two_lookups)
    jsc = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(js, scope=jsc, use_compiled=False)
    state = {n: np.array(v) for n, v in jsc.items()}
    l_op, s_op = _port_train(True, optimizer, two_lookups, dup_ids, state,
                             False)
    l_cp, s_cp = _port_train(True, optimizer, two_lookups, dup_ids, state,
                             True)
    np.testing.assert_array_equal(l_cp, l_op)
    for name, t in s_op.items():
        if isinstance(t, torch.Tensor):
            assert torch.equal(s_cp.find_var(name), t), name
    if dense is None:
        return
    l_dn, s_dn = _port_train(False, dense, two_lookups, dup_ids, state,
                             True)
    np.testing.assert_allclose(l_op, l_dn, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(s_op.find_var("emb_w").numpy(),
                               s_dn.find_var("emb_w").numpy(), rtol=1e-6,
                               atol=1e-6)


def test_sparse_gradient_fetch_is_a_selected_rows_of_copies():
    with pt_names.guard():
        pm, ps, ploss = _port_build(True, "sgd", True)
    exe, scope = Executor(device="cpu"), ptt.Scope()
    exe.run(ps, scope=scope)
    for use_compiled in (False, True, True):
        g, = exe.run(pm, feed=_feed(True, False, 0), fetch_list=["emb_w@GRAD"],
                     scope=scope, use_compiled=use_compiled)
        assert isinstance(g, psr.SelectedRows)
        assert g.rows.shape == (24,) and g.values.shape == (24, 8)
        assert isinstance(g.values, np.ndarray) and g.height == 50
