"""Fleet's gradient merge in paddle_tpu_torch against paddle_tpu on the
CPU (``strategy.gradient_merge`` with ``gradient_merge_configs``).

* The reference's own case (``tests/test_fleet.py``
  ``test_fleet_gradient_merge_fires_every_k``), imported and run as it is
  with the names it uses pointed at the port's.
* The merge program's JSON (main and startup, the ``conditional_block``'s
  sub-block included) equals the reference's, for k 4 with and without
  ``avg`` and for k 1 (no merge).
* The k-step equivalence, op by op and compiled: the three micro-batch
  steps of a window that do not fire leave every parameter, moment and
  beta power bit for bit as they were; the fourth gives one Adam step on
  the whole batch (the four micro-batches together) within 1e-5.
* From one state, eight steps of the port give the reference's losses
  and state within 1e-5, and its compiled steps give its op-by-op
  results bit for bit (the step runs uncaptured: ``conditional_block``
  decides on the host).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core import unique_name as jax_names
from paddle_tpu.distributed import fleet as jfleet

import paddle_tpu_torch as ptt
from paddle_tpu_torch import layers as pl
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.core import unique_name as pt_names
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.scope import Scope, scope_from_numpy
from paddle_tpu_torch.distributed import fleet as pfleet

import tests.test_fleet as ref_fleet
from tests.test_torch_control_flow import ref_json
from tests.test_torch_fleet import PORT_PT, port_in_reference  # noqa: F401

torch.set_num_threads(2)

K, MICRO, TOL = 4, 8, 1e-5


def test_reference_gradient_merge_case_on_the_port(port_in_reference):  # noqa: F811
    ref_fleet.test_fleet_gradient_merge_fires_every_k()


def _json(prog):
    return json.loads(json.dumps(prog.to_dict()))


def _mlp(pkg, layers, fleet, opt_mod, k=K, avg=True, merge=True, lr=0.05):
    """A two-layer classifier with Adam, through fleet with gradient
    merge (or, with ``merge`` False, Adam alone on the same names)."""
    names = pt_names if pkg is ptt else jax_names
    main, startup = pkg.Program(), pkg.Program()
    with names.guard(), pkg.program_guard(main, startup):
        x = layers.data("x", [16])
        label = layers.data("label", [1], dtype="int64")
        logits = layers.fc(layers.fc(x, 32, act="tanh"), 5)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        opt = opt_mod.AdamOptimizer(lr)
        if merge:
            s = fleet.DistributedStrategy()
            s.gradient_merge = True
            s.gradient_merge_configs = {"k_steps": k, "avg": avg}
            opt = fleet.distributed_optimizer(opt, s)
        opt.minimize(loss)
    return main, startup, loss


def _jax(**kw):
    return _mlp(pt, pt.layers, jfleet, pt.optimizer, **kw)


def _port(**kw):
    return _mlp(ptt, pl, pfleet, popt, **kw)


@pytest.mark.parametrize("k,avg", [(4, True), (4, False), (1, True)])
def test_merge_program_json_equals_the_reference(k, avg):
    jm, js, _ = _jax(k=k, avg=avg)
    pm, ps, _ = _port(k=k, avg=avg)
    assert _json(pm) == ref_json(jm) and _json(ps) == ref_json(js)
    types = [op.type for op in pm.global_block().ops]
    assert ("conditional_block" in types) == (k > 1)


def _batches(n, seed=0):
    r = np.random.RandomState(seed)
    return [{"x": r.randn(MICRO, 16).astype(np.float32),
             "label": r.randint(0, 5, (MICRO, 1)).astype(np.int64)}
            for _ in range(n)]


def _state(startup):
    sc = Scope()
    Executor(device="cpu").run(startup, scope=sc)
    return {n: v.numpy().copy() for n, v in sc.items()
            if isinstance(v, torch.Tensor)}


def _host(scope):
    return {n: v.numpy().copy() for n, v in scope.items()
            if isinstance(v, torch.Tensor)}


@pytest.mark.parametrize("use_compiled", [False, True])
def test_k_steps_equal_one_whole_batch_step(use_compiled):
    pm, ps, loss = _port()
    plain, _, ploss = _port(merge=False)
    state = _state(ps)
    micro = _batches(K)
    whole = {k: np.concatenate([b[k] for b in micro]) for k in micro[0]}
    exe, sc = Executor(device="cpu"), scope_from_numpy(state, "cpu")
    trained = {n for n in state if "@GradAcc" not in n
               and not n.startswith(("gm_step", "learning_rate"))}
    for i, feed in enumerate(micro):
        before = _host(sc)
        exe.run(pm, feed=feed, fetch_list=[loss], scope=sc,
                use_compiled=use_compiled)
        after = _host(sc)
        if i < K - 1:
            for n in trained:
                np.testing.assert_array_equal(after[n], before[n],
                                              err_msg=f"step {i}: {n}")
    ref_sc = scope_from_numpy(state, "cpu")
    Executor(device="cpu").run(plain, feed=whole, fetch_list=[ploss],
                               scope=ref_sc, use_compiled=False)
    want = _host(ref_sc)
    for n in trained:
        np.testing.assert_allclose(after[n], want[n], rtol=TOL, atol=TOL,
                                   err_msg=n)
    for n in after:
        if n.endswith("@GradAcc"):
            assert not after[n].any(), n


def test_eight_steps_equal_the_reference_and_compiled_bitwise():
    jm, js, jloss = _jax()
    pm, ps, ploss = _port()
    state = _state(ps)
    batches = _batches(2 * K, seed=1)
    jexe, jsc = pt.Executor(pt.CPUPlace()), pt.Scope()
    for n, v in state.items():
        jsc.set(n, jnp.asarray(v))
    legs = {}
    for mode in (False, True):
        exe, sc = Executor(device="cpu"), scope_from_numpy(state, "cpu")
        legs[mode] = ([float(exe.run(pm, feed=b, fetch_list=[ploss],
                                     scope=sc, use_compiled=mode)[0])
                       for b in batches], _host(sc))
    want = [float(np.asarray(jexe.run(jm, feed=b, fetch_list=[jloss],
                                      scope=jsc)[0])) for b in batches]
    np.testing.assert_allclose(legs[False][0], want, rtol=TOL, atol=TOL)
    assert legs[True][0] == legs[False][0]
    for n, v in legs[False][1].items():
        np.testing.assert_array_equal(legs[True][1][n], v, err_msg=n)
        np.testing.assert_allclose(v, np.asarray(jsc.find_var(n)),
                                   rtol=TOL, atol=TOL, err_msg=n)


def test_gradient_merge_is_no_longer_refused():
    s = pfleet.DistributedStrategy()
    s.gradient_merge = True
    opt = pfleet.distributed_optimizer(popt.SGDOptimizer(0.1), s)
    assert type(opt.inner).__name__ == "GradientMergeOptimizer"
