"""word2vec (the reference's book model) in the port against paddle_tpu
on the CPU: the same program JSON (main and startup, with and without
its SGD), the shared table's gradient a SelectedRows of 4 * batch rows,
and 5 training steps from the reference's startup state to its losses
within 1e-5 and its parameters within 1e-5 (1e-4 under Adam, whose
update of a nearly cancelling gradient entry is ill-conditioned), op by
op and compiled, under the
model's own SGD and under momentum and lazy Adam appended to the
``with_optimizer=False`` program."""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core import unique_name as jax_names
from paddle_tpu.models import word2vec as jw2v

from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.core import unique_name as pt_names
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.ir import program_guard as pguard
from paddle_tpu_torch.core.scope import scope_from_numpy
from paddle_tpu_torch.core.selected_rows import SelectedRows
from paddle_tpu_torch.models import word2vec as pw2v

torch.set_num_threads(2)

V, B = 300, 24


def _json(prog):
    return json.loads(json.dumps(prog.to_dict()))


def _optimize(pkg_opt, guard, main, startup, loss, kind):
    with guard(main, startup):
        if kind == "momentum":
            pkg_opt.MomentumOptimizer(0.1, momentum=0.9).minimize(loss)
        else:
            pkg_opt.AdamOptimizer(0.01, lazy_mode=True).minimize(loss)


def _build(kind):
    with_opt = kind == "sgd"
    with jax_names.guard():
        jm, js, _, jf = jw2v.build_word2vec_program(V, B, lr=0.5,
                                                    with_optimizer=with_opt)
        if not with_opt:
            _optimize(pt.optimizer, pt.program_guard, jm, js, jf["loss"],
                      kind)
    with pt_names.guard():
        pm, ps, _, pf = pw2v.build_word2vec_program(V, B, lr=0.5,
                                                    with_optimizer=with_opt)
        if not with_opt:
            _optimize(popt, pguard, pm, ps, pf["loss"], kind)
    return (jm, js, jf["loss"]), (pm, ps, pf["loss"])


@pytest.mark.parametrize("with_optimizer", [True, False])
def test_program_json_equals_the_reference(with_optimizer):
    with jax_names.guard():
        jm, js, jfeeds, _ = jw2v.build_word2vec_program(
            100000, 1024, with_optimizer=with_optimizer)
    with pt_names.guard():
        pm, ps, pfeeds, _ = pw2v.build_word2vec_program(
            100000, 1024, with_optimizer=with_optimizer)
    assert _json(pm) == _json(jm) and _json(ps) == _json(js)
    assert list(pfeeds) == list(jfeeds)
    b = pw2v.synthetic_batch(100, 8, seed=3)
    want = jw2v.synthetic_batch(100, 8, seed=3)
    assert list(b) == list(want)
    for n in b:
        np.testing.assert_array_equal(b[n], want[n])


@pytest.mark.parametrize("use_compiled", [False, True])
@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam_lazy"])
def test_training_matches_the_reference(kind, use_compiled):
    (jm, js, jloss), (pm, ps, ploss) = _build(kind)
    assert _json(pm) == _json(jm)
    jexe, jsc = pt.Executor(pt.CPUPlace()), pt.Scope()
    jexe.run(js, scope=jsc, use_compiled=False)
    psc = scope_from_numpy({n: np.array(v) for n, v in jsc.items()}, "cpu")
    pexe = Executor(device="cpu")
    losses = []
    for step in range(5):
        feed = jw2v.synthetic_batch(V, B, seed=step)
        jv, = jexe.run(jm, feed=feed, fetch_list=[jloss], scope=jsc,
                       use_compiled=False)
        pv, = pexe.run(pm, feed=feed, fetch_list=[ploss.name], scope=psc,
                       use_compiled=use_compiled)
        np.testing.assert_allclose(pv, np.asarray(jv), rtol=1e-5, atol=1e-5,
                                   err_msg=f"{kind} step {step}")
        losses.append(float(pv.reshape(-1)[0]))
    # Adam divides each moment by the root of the second: a gradient
    # entry that nearly cancels (rounding-level in both packages) moves
    # its weight by up to lr either way, so Adam's parameters are held at
    # 1e-4; SGD and momentum move a weight in proportion to its gradient
    ptol = 1e-4 if kind == "adam_lazy" else 1e-5
    for p in pm.all_parameters():
        np.testing.assert_allclose(psc.find_var(p.name).numpy(),
                                   np.asarray(jsc.find_var(p.name)),
                                   rtol=ptol, atol=ptol, err_msg=p.name)
    g, = pexe.run(pm, feed=jw2v.synthetic_batch(V, B, seed=9),
                  fetch_list=["shared_w@GRAD"], scope=psc,
                  use_compiled=use_compiled)
    assert isinstance(g, SelectedRows) and g.height == V
    assert g.rows.shape == (4 * B,) and g.values.shape == (4 * B, 32)
