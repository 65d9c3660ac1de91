"""The ResNet slice as a whole: ResNet-50 classifier training in
paddle_tpu_torch held against paddle_tpu, on the CPU, at a tiny size
(``ResNetConfig(50, 10, (3, 32, 32), stages=[1, 1, 1, 1])``: the
bottleneck blocks of every stage, one block a stage; batch 4; Momentum at
lr 0.01, fuse_bn_act_pass on).

* Both packages build the same main and startup programs (fp32 and the
  bf16 AMP rewrite), JSON for JSON.
* From one state (the JAX startup's, carried over by
  ``scope_from_numpy``), 3 steps in each package: losses, acc1 and acc5
  within 1e-4 (fp32) and 1e-2 (bf16 AMP) of the reference.
* Every parameter, velocity and running statistic after each step, with
  both packages starting that step from the reference's state: batch
  norm over 4 images amplifies the order of fp32 sums, so two runs that
  start 1e-6 apart drift apart over steps however right each step is
  (measured: gradients agree to 4.4e-4 of their largest magnitude from
  one state, velocities free-running differ by 3 % by step 3). Each
  tensor is held to tol * max(1, max|reference|): fp32 1e-4 throughout;
  bf16 1e-2 for parameters and running statistics, and 5e-2 for the
  velocities, which after a step carry that step's gradient through
  some 50 bf16 ops whose rounding points differ between XLA and PyTorch
  (each layer's cotangent differs by a few bf16 ulps; measured up to 4.3
  % of a gradient's largest magnitude).

The fp32 reference runs compiled, the AMP one op by op (the interpreting
executor rounds bf16 after each op, as the port does).
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core import unique_name as jax_names
from paddle_tpu.models import resnet as jresnet

import paddle_tpu_torch  # noqa: F401
from paddle_tpu_torch.core import unique_name as pt_names
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.scope import scope_from_numpy
from paddle_tpu_torch.models import resnet as presnet

torch.set_num_threads(2)

TINY = dict(depth=50, num_classes=10, image_shape=(3, 32, 32),
            stages=[1, 1, 1, 1])
BATCH, STEPS, LR = 4, 3, 0.01
TOL = {False: dict(loss=1e-4, state=1e-4, velocity=1e-4),
       True: dict(loss=1e-2, state=1e-2, velocity=5e-2)}


def _build(mod, names, amp):
    with names.guard():
        return mod.build_classifier_program(mod.ResNetConfig(**TINY),
                                            batch_size=BATCH, amp=amp, lr=LR)


def _json(prog):
    return json.loads(json.dumps(prog.to_dict()))


@pytest.mark.parametrize("amp", [False, True])
def test_both_packages_build_the_same_tiny_program(amp):
    jmain, jstart, jfeeds, jfetch = _build(jresnet, jax_names, amp)
    pmain, pstart, pfeeds, pfetch = _build(presnet, pt_names, amp)
    for j, p in ((jmain, pmain), (jstart, pstart)):
        assert _json(p) == _json(j)
    assert {k: v.name for k, v in pfetch.items()} == \
        {k: v.name for k, v in jfetch.items()}
    assert {k: v.name for k, v in pfeeds.items()} == \
        {k: v.name for k, v in jfeeds.items()}
    types = [o.type for o in pmain.global_block().ops]
    assert types.count("fused_bn_add_act") == 13
    assert types.count("momentum") == 53
    assert ("cast" in types) == amp


@pytest.fixture(scope="module")
def start_state():
    """The reference's startup state (the same startup program builds
    with and without AMP), as numpy."""
    _, jstart, _, _ = _build(jresnet, jax_names, False)
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(jstart, scope=scope, use_compiled=False)
    return {n: np.array(v) for n, v in scope.items()}


def _jax_scope(state):
    import jax.numpy as jnp

    scope = pt.Scope()
    for n, v in state.items():
        scope.set(n, v if n.startswith("@") else jnp.asarray(v))
    return scope


def _numpy_state(scope):
    return {n: np.array(v) for n, v in scope.items()}


def _scalar(v):
    return float(np.asarray(v, np.float32).reshape(-1)[0])


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp_bf16"])
def test_training_matches_reference(amp, start_state):
    jmain, _, _, jfetch = _build(jresnet, jax_names, amp)
    pmain, _, _, pfetch = _build(presnet, pt_names, amp)
    tol = TOL[amp]
    batch = jresnet.synthetic_batch(jresnet.ResNetConfig(**TINY), BATCH,
                                    seed=1)
    fetch = [pfetch[k].name for k in ("loss", "acc1", "acc5")]
    jexe, pexe = pt.Executor(pt.CPUPlace()), Executor(device="cpu")
    jscope = _jax_scope(start_state)
    free = scope_from_numpy(start_state, "cpu")
    persist = [v.name for v in pmain.global_block().vars.values()
               if v.persistable]
    losses = []
    for step in range(STEPS):
        before = _numpy_state(jscope)
        want = jexe.run(jmain, feed=batch, fetch_list=fetch, scope=jscope,
                        use_compiled=not amp)
        got = pexe.run(pmain, feed=batch, fetch_list=fetch, scope=free)
        for name, w, g in zip(("loss", "acc1", "acc5"), want, got):
            np.testing.assert_allclose(
                _scalar(g), _scalar(w), rtol=tol["loss"], atol=tol["loss"],
                err_msg=f"step {step} {name}")
        losses.append(_scalar(got[0]))
        # the same step from the reference's state: every persistable var
        synced = scope_from_numpy(before, "cpu")
        pexe.run(pmain, feed=batch, fetch_list=fetch, scope=synced)
        for name in persist:
            ref = np.asarray(jscope.find_var(name), np.float32)
            mine = synced.find_var(name).float().numpy()
            t = tol["velocity" if name.endswith("_velocity_0") else "state"]
            bound = t * max(1.0, float(np.abs(ref).max()))
            err = float(np.abs(mine - ref).max())
            assert err <= bound, f"step {step} {name}: {err} > {bound}"
    assert losses[-1] < losses[0]
    assert len([n for n in persist if n.endswith("_velocity_0")]) == 53
    assert len([n for n in persist if n.endswith("_bn_var")]) == 17
