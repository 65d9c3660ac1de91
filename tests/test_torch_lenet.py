"""The LeNet/MNIST row of the reference's ladder (``tools/bench_models.py``
``bench_mnist``) in paddle_tpu_torch, held against paddle_tpu on the CPU:

* ``layers.data`` declares the reference's var (batch dim prepended
  unless the shape starts with -1 or ``append_batch_size`` is off; dtype,
  lod_level and stop_gradient carried);
* the ``cross_entropy`` op and its generic ``__vjp_grad__`` against the
  reference's lowering: hard labels [N, 1] and [N], soft labels (fp32,
  within 1e-6: the same few fp32 operations);
* ``build_lenet_program`` builds the reference's program, JSON for JSON;
* from one state (the JAX startup's), 4 Adam steps at batch 8 and lr
  1e-3 give the reference's losses and accuracies within 1e-4 (the
  reference compiled, the port op by op and compiled; convs and matmuls
  sum in different orders). At build_lenet_program's default lr 0.01
  random normal images saturate the softmax and the loss rises in both
  packages.
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu import layers as jlayers
from paddle_tpu.core import registry as jax_registry
from paddle_tpu.core import unique_name as jax_names
from paddle_tpu.core.ir import OpDesc as JOpDesc
from paddle_tpu.models import lenet as jlenet

import paddle_tpu_torch as ptt
from paddle_tpu_torch import layers as players
from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.core import unique_name as pt_names
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.ir import OpDesc as POpDesc
from paddle_tpu_torch.core.scope import scope_from_numpy
from paddle_tpu_torch.models import lenet as plenet

torch.set_num_threads(2)

BATCH, STEPS, LR = 8, 4, 1e-3


@pytest.mark.parametrize("shape,kw", [
    ([1, 28, 28], {}),
    ([1], dict(dtype="int64")),
    ([-1, 5], {}),
    ([3, 4], dict(append_batch_size=False, lod_level=1,
                  stop_gradient=False)),
    ([], dict(dtype="int32"))])
def test_data_declares_the_reference_var(shape, kw):
    jmain, pmain = pt.Program(), ptt.Program()
    with pt.program_guard(jmain, pt.Program()):
        jv = jlayers.data("x", shape, **kw)
    with ptt.program_guard(pmain, ptt.Program()):
        pv = players.data("x", shape, **kw)
    assert pv.shape == jv.shape
    assert json.dumps(pv.desc.to_dict(), sort_keys=True) == \
        json.dumps(jv.desc.to_dict(), sort_keys=True)


def _ce_case(kind, rng):
    p = rng.rand(6, 10).astype(np.float32) + 0.05
    p /= p.sum(-1, keepdims=True)
    if kind == "soft":
        lbl = rng.rand(6, 10).astype(np.float32)
        lbl /= lbl.sum(-1, keepdims=True)
    else:
        lbl = rng.randint(0, 10, (6, 1) if kind == "hard_n1" else (6,))
        lbl = lbl.astype(np.int32)
    return {"X": [p], "Label": [lbl]}, {"soft_label": kind == "soft",
                                         "ignore_index": -100}


CE_KINDS = ["hard_n1", "hard_n", "soft"]


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


@pytest.mark.parametrize("kind", CE_KINDS)
def test_cross_entropy_matches_reference_lowering(kind):
    ins, attrs = _ce_case(kind, np.random.RandomState(len(kind)))
    want = np.asarray(jax_registry.get("cross_entropy").forward(
        ins, dict(attrs))["Y"])
    got = pt_registry.get("cross_entropy").forward(
        {k: [_t(v) for v in vs] for k, vs in ins.items()}, dict(attrs))["Y"]
    assert got.shape == want.shape == (6, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", CE_KINDS)
def test_cross_entropy_gradient_matches_reference(kind):
    """Both packages' default grad makers build the same ``__vjp_grad__``
    op (Label not differentiated), and its lowerings agree on dX."""
    rng = np.random.RandomState(10 + len(kind))
    ins, attrs = _ce_case(kind, rng)
    names = {"X": ["p"], "Label": ["lbl"]}
    outs = {"Y": ["y"]}
    out_grads, in_grads = {"Y": ["y@GRAD"]}, {"X": ["p@GRAD"],
                                               "Label": [None]}
    (jg,) = jax_registry.default_grad_maker(
        JOpDesc("cross_entropy", names, outs, attrs), out_grads, in_grads)
    (pg,) = pt_registry.default_grad_maker(
        POpDesc("cross_entropy", names, outs, attrs), out_grads, in_grads)
    assert json.dumps(pg.to_dict(), sort_keys=True) == \
        json.dumps(jg.to_dict(), sort_keys=True)
    assert pt_registry.get("cross_entropy").non_diff_inputs == ("Label",)
    env = {"p": ins["X"][0], "lbl": ins["Label"][0],
           "y@GRAD": rng.randn(6, 1).astype(np.float32)}
    gins = {s: [env[n] for n in ns] for s, ns in jg.inputs.items()}
    want = np.asarray(jax_registry.get("__vjp_grad__").forward(
        gins, dict(jg.attrs))["IG__X"][0])
    got = pt_registry.get("__vjp_grad__").forward(
        {s: [_t(v) for v in vs] for s, vs in gins.items()},
        dict(pg.attrs))["IG__X"][0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _build(mod, names):
    with names.guard():
        return mod.build_lenet_program(batch_size=BATCH, lr=LR)


def test_lenet_builds_the_reference_program():
    jmain, jstart, jfeeds, jfetch = _build(jlenet, jax_names)
    pmain, pstart, pfeeds, pfetch = _build(plenet, pt_names)
    for j, p in ((jmain, pmain), (jstart, pstart)):
        assert json.loads(json.dumps(p.to_dict())) == \
            json.loads(json.dumps(j.to_dict()))
    assert {k: v.name for k, v in pfeeds.items()} == \
        {k: v.name for k, v in jfeeds.items()}
    assert {k: v.name for k, v in pfetch.items()} == \
        {k: v.name for k, v in jfetch.items()}
    assert pfeeds["img"].shape == (-1, 1, 28, 28)
    types = [o.type for o in pmain.global_block().ops]
    assert types.count("adam") == 6 and "cross_entropy" in types


@pytest.mark.parametrize("use_compiled", [False, True])
def test_lenet_trains_to_the_reference_losses(use_compiled):
    jmain, jstart, _, jfetch = _build(jlenet, jax_names)
    pmain, _, _, pfetch = _build(plenet, pt_names)
    jscope, jexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    jexe.run(jstart, scope=jscope, use_compiled=False)
    state = {n: np.array(v) for n, v in jscope.items()}
    pscope = scope_from_numpy(state, "cpu")
    rng = np.random.RandomState(0)
    feed = {"img": rng.randn(BATCH, 1, 28, 28).astype(np.float32),
            "label": rng.randint(0, 10, (BATCH, 1)).astype(np.int64)}
    fetch = [jfetch["loss"].name, jfetch["acc"].name]
    pexe = Executor(device="cpu")
    losses = []
    for _ in range(STEPS):
        want = jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope,
                        use_compiled=True)
        got = pexe.run(pmain, feed=feed, fetch_list=fetch, scope=pscope,
                       use_compiled=use_compiled)
        for w, g in zip(want, got):
            np.testing.assert_allclose(np.asarray(g).reshape(-1),
                                       np.asarray(w).reshape(-1),
                                       rtol=1e-4, atol=1e-4)
        losses.append(float(np.asarray(got[0]).reshape(-1)[0]))
    assert losses[-1] < losses[0]
    # the trained parameters agree as well
    for p in pmain.all_parameters():
        np.testing.assert_allclose(
            pscope.find_var(p.name).numpy(),
            np.asarray(jscope.find_var(p.name)), rtol=1e-3, atol=1e-4,
            err_msg=p.name)
