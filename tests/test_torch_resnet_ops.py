"""The ResNet slice's op lowerings, grads, passes, AMP rewrite, optimizer
ops and initializer in paddle_tpu_torch, held against paddle_tpu on the
same numpy inputs (made from a seed).

* Forward lowerings: conv2d, pool2d, batch_norm, fused_bn_add_act,
  softmax, accuracy, cast. Gradients: each op's ``__vjp_grad__``, built by
  both packages' ``default_grad_maker`` from one OpDesc, on the same
  inputs and cotangents (cotangents only on the outputs a loss reaches:
  Y / Out / Output, never the running or saved statistics).
  Tolerances: fp32 rtol = atol = 1e-5 (the two frameworks sum in
  different orders); bf16 outputs rtol = 2^-7 (one bf16 ulp) and atol =
  1e-2 (values up to ~4 in these cases); integer outputs exactly. One
  exception: batch_norm's Scale and Bias gradients from a bf16 X are held
  to 2^-5 of their largest magnitude (four bf16 ulps), because the
  reference sums the bf16 cotangent over a channel's positions with bf16
  partial sums (JAX's transpose of the broadcast: measured 0.27 from the
  exact sum of 100 values near 10, where rounding an fp32 sum once, as
  PyTorch does, is 0.05 off).
* momentum (plain, Nesterov, l2_decay) and sgd: rtol = atol = 1e-6, and
  the port updates Param and Velocity in place.
* fuse_bn_act_pass and rewrite_program_bf16 give the reference's JSON on
  the tiny and the full-width ResNet-50 programs, and the full program
  has the reference's op counts (616 main ops of 17 types at batch 256
  with AMP; 429 startup ops).
* MSRA by distribution: mean, std and bounds.
"""

import json
from collections import Counter

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu.core import registry as jax_registry
from paddle_tpu.core import unique_name as jax_names
from paddle_tpu.core.ir import OpDesc as JOpDesc
from paddle_tpu.models import resnet as jresnet

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.core.selected_rows import SelectedRows
from paddle_tpu_torch.core import unique_name as pt_names
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.ir import OpDesc as POpDesc
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.initializer import MSRA
from paddle_tpu_torch.models import resnet as presnet

torch.set_num_threads(2)

RTOL = ATOL = 1e-5
BF16_RTOL, BF16_ATOL = 2 ** -7, 1e-2


class BF16(np.ndarray):
    """A float32 array that both packages receive as bfloat16."""


def _bf16(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16) \
        .astype(np.float32).view(BF16)


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _to_jax(x):
    import jax.numpy as jnp

    if isinstance(x, BF16):
        return jnp.asarray(np.asarray(x, np.float32), jnp.bfloat16)
    return jnp.asarray(x)


def _to_torch(x):
    t = torch.from_numpy(np.array(np.asarray(x), copy=True))
    return t.to(torch.bfloat16) if isinstance(x, BF16) else t


def _conv(r, n, c, h, co, k, stride, pad, groups=1, dil=1, algo=None):
    attrs = {"strides": [stride, stride], "paddings": [pad, pad],
             "dilations": [dil, dil], "groups": groups,
             "data_format": "NCHW"}
    if algo:
        attrs["padding_algorithm"] = algo
    return ({"Input": _rand(r, n, c, h, h),
             "Filter": _rand(r, co, c // groups, k, k) * 0.2}, attrs)


def _pool(r, ptype, k, stride, pad, **kw):
    attrs = {"ksize": [k, k], "pooling_type": ptype,
             "strides": [stride, stride], "paddings": [pad, pad],
             "global_pooling": False, "ceil_mode": False, "exclusive": True}
    attrs.update(kw)
    return {"X": _rand(r, 2, 3, 9, 9)}, attrs


def _bn(r, layout="NCHW", is_test=False, c=6, z=False, bf16=False,
        fused=False):
    shape = (4, c, 5, 5) if layout == "NCHW" else (4, 5, 5, c)
    x = _rand(r, *shape) * 2 + 0.5
    ins = {"X": _bf16(x) if bf16 else x,
           "Scale": r.rand(c).astype(np.float32) + 0.5,
           "Bias": _rand(r, c) * 0.3,
           "Mean": _rand(r, c) * 0.1,
           "Variance": r.rand(c).astype(np.float32) + 0.5}
    if z:
        zz = _rand(r, *shape)
        ins["Z"] = _bf16(zz) if bf16 else zz
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": is_test,
             "data_layout": layout, "use_global_stats": False}
    if fused:
        attrs["act"] = "relu"
    return ins, attrs


def _accuracy(r, k):
    x = _rand(r, 8, 10)
    idx = np.argsort(-x, axis=-1, kind="stable")[:, :k].astype(np.int32)
    label = r.randint(0, 10, (8, 1)).astype(np.int32)
    label[:3, 0] = idx[:3, 0]
    return {"Out": np.take_along_axis(x, idx, -1), "Indices": idx,
            "Label": label}, {}


# case -> (inputs, attrs)
OP_CASES = {
    "conv2d[7x7_s2_p3]": lambda r: _conv(r, 2, 3, 12, 8, 7, 2, 3),
    "conv2d[3x3_s1_p1]": lambda r: _conv(r, 2, 8, 6, 8, 3, 1, 1),
    "conv2d[3x3_s2_p1]": lambda r: _conv(r, 2, 8, 7, 4, 3, 2, 1),
    "conv2d[1x1_s1_p0]": lambda r: _conv(r, 2, 8, 5, 16, 1, 1, 0),
    "conv2d[1x1_s2_p0]": lambda r: _conv(r, 2, 8, 6, 16, 1, 2, 0),
    "conv2d[3x3_groups2]": lambda r: _conv(r, 2, 8, 6, 6, 3, 1, 1, groups=2),
    "conv2d[3x3_dilation2]": lambda r: _conv(r, 2, 4, 9, 4, 3, 1, 2, dil=2),
    "conv2d[same_s2]": lambda r: _conv(r, 2, 4, 7, 4, 3, 2, 0, algo="SAME"),
    "pool2d[max_3x3_s2_p1]": lambda r: _pool(r, "max", 3, 2, 1),
    "pool2d[avg_exclusive]": lambda r: _pool(r, "avg", 3, 2, 1),
    "pool2d[avg_inclusive]": lambda r: _pool(r, "avg", 3, 2, 1,
                                             exclusive=False),
    "pool2d[max_2x2]": lambda r: _pool(r, "max", 2, 2, 0),
    "pool2d[global_avg]": lambda r: _pool(r, "avg", 7, 1, 0,
                                          global_pooling=True),
    "pool2d[global_max]": lambda r: _pool(r, "max", 7, 1, 0,
                                          global_pooling=True),
    "pool2d[adaptive_avg]": lambda r: ({"X": _rand(r, 2, 3, 9, 7)},
                                       {"ksize": [4, 3], "adaptive": True,
                                        "pooling_type": "avg"}),
    "pool2d[adaptive_max]": lambda r: ({"X": _rand(r, 2, 3, 8, 8)},
                                       {"ksize": [2, 2], "adaptive": True,
                                        "pooling_type": "max"}),
    "batch_norm[train_nchw]": lambda r: _bn(r),
    "batch_norm[train_nhwc]": lambda r: _bn(r, "NHWC"),
    "batch_norm[test]": lambda r: _bn(r, is_test=True),
    "batch_norm[train_bf16]": lambda r: _bn(r, bf16=True),
    "fused_bn_add_act[nchw]": lambda r: _bn(r, fused=True),
    "fused_bn_add_act[nchw_z]": lambda r: _bn(r, z=True, fused=True),
    "fused_bn_add_act[nhwc_z]": lambda r: _bn(r, "NHWC", z=True, fused=True),
    "fused_bn_add_act[nhwc]": lambda r: _bn(r, "NHWC", fused=True),
    "fused_bn_add_act[bf16]": lambda r: _bn(r, bf16=True, fused=True),
    "fused_bn_add_act[bf16_z]": lambda r: _bn(r, z=True, bf16=True,
                                              fused=True),
    "fused_bn_add_act[bf16_nhwc_z]": lambda r: _bn(r, "NHWC", z=True,
                                                   bf16=True, fused=True),
    "fused_bn_add_act[test_z]": lambda r: _bn(r, z=True, is_test=True,
                                              fused=True),
    "softmax": lambda r: ({"X": _rand(r, 4, 10) * 3}, {"axis": -1}),
    "softmax[axis1]": lambda r: ({"X": _rand(r, 3, 5, 4)}, {"axis": 1}),
    "accuracy[k1]": lambda r: _accuracy(r, 1),
    "accuracy[k5]": lambda r: _accuracy(r, 5),
    "cast[to_bf16]": lambda r: ({"X": _rand(r, 4, 6)},
                                {"out_dtype": "bfloat16"}),
    "cast[from_bf16]": lambda r: ({"X": _bf16(_rand(r, 4, 6))},
                                  {"out_dtype": "float32"}),
    "cast[to_int32]": lambda r: ({"X": _rand(r, 4, 6) * 5},
                                 {"out_dtype": "int32"}),
    "cast[int64]": lambda r: ({"X": r.randint(-9, 9, (4, 6))
                               .astype(np.int32)}, {"out_dtype": "int64"}),
}


def _as_lists(ins_np, conv):
    return {k: [conv(x) for x in (v if isinstance(v, list) else [v])]
            for k, v in ins_np.items()}


def _compare(tag, got, want, bf16_reduction=False):
    want = np.asarray(want)
    got = got.detach()
    if bf16_reduction:
        w = want.astype(np.float32)
        err = float(np.abs(got.float().numpy() - w).max())
        assert err <= 2 ** -5 * float(np.abs(w).max()), (tag, err)
        return
    if want.dtype == ml_dtypes.bfloat16:
        assert got.dtype == torch.bfloat16, tag
        np.testing.assert_allclose(got.float().numpy(),
                                   want.astype(np.float32), rtol=BF16_RTOL,
                                   atol=BF16_ATOL, err_msg=tag)
        return
    got = got.numpy()
    assert got.shape == want.shape, tag
    assert got.dtype == want.dtype, tag
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=tag)
    else:
        assert np.array_equal(got, want), tag


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_forward_lowering_matches_reference(case):
    op_type = case.split("[")[0]
    rng = np.random.RandomState(sum(map(ord, case)))
    ins_np, attrs = OP_CASES[case](rng)
    want = jax_registry.normalize_outputs(jax_registry.get(op_type).forward(
        _as_lists(ins_np, _to_jax), dict(attrs)))
    got = pt_registry.normalize_outputs(pt_registry.get(op_type).forward(
        _as_lists(ins_np, _to_torch), dict(attrs)))
    assert set(got) == set(want)
    for slot, vals in want.items():
        for i, w in enumerate(vals):
            _compare(f"{case}:{slot}[{i}]", got[slot][i], w)


# the outputs a loss reaches; statistics never carry a cotangent
LOSS_SLOTS = {"Y", "Out", "Output"}
GRAD_CASES = sorted(c for c in OP_CASES
                    if not c.startswith(("accuracy", "cast[to_int32]",
                                         "cast[int64]")))


@pytest.mark.parametrize("case", GRAD_CASES)
def test_vjp_grad_matches_reference(case):
    """Both packages build the grad op of the same forward OpDesc with
    their default grad maker; the descs are equal, and so are the
    gradients their ``__vjp_grad__`` lowerings return."""
    op_type = case.split("[")[0]
    rng = np.random.RandomState(sum(map(ord, case)) + 1)
    ins_np, attrs = OP_CASES[case](rng)
    outs = jax_registry.normalize_outputs(jax_registry.get(op_type).forward(
        _as_lists(ins_np, _to_jax), dict(attrs)))
    ins_l = _as_lists(ins_np, lambda x: x)
    in_names = {s: [f"{s}_{i}" for i in range(len(v))]
                for s, v in ins_l.items()}
    out_names = {s: [f"{s}_{i}" for i in range(len(v))]
                 for s, v in outs.items()}
    out_grads = {s: [f"{n}@GRAD" if s in LOSS_SLOTS else None
                     for n in names] for s, names in out_names.items()}
    nd = jax_registry.get(op_type).non_diff_inputs
    in_grads = {s: [f"{n}@GRAD" if s not in nd and np.issubdtype(
        np.asarray(ins_l[s][i]).dtype, np.floating) else None
        for i, n in enumerate(names)] for s, names in in_names.items()}
    jop = JOpDesc(op_type, in_names, out_names, attrs)
    pop = POpDesc(op_type, in_names, out_names, attrs)
    (jg,) = jax_registry.default_grad_maker(jop, out_grads, in_grads)
    (pg,) = pt_registry.default_grad_maker(pop, out_grads, in_grads)
    assert json.dumps(pg.to_dict(), sort_keys=True) == \
        json.dumps(jg.to_dict(), sort_keys=True)
    assert pt_registry.get(op_type).non_diff_inputs == \
        jax_registry.get(op_type).non_diff_inputs

    env = {}
    for s, names in in_names.items():
        env.update(zip(names, ins_l[s]))
    for s, names in out_names.items():
        for i, n in enumerate(names):
            if out_grads[s][i] is not None:
                ct = rng.randn(*np.shape(outs[s][i])).astype(np.float32)
                bf = np.asarray(outs[s][i]).dtype == ml_dtypes.bfloat16
                env[n + "@GRAD"] = _bf16(ct) if bf else ct

    def gather(conv):
        return {slot: [None if n == "@EMPTY@" else conv(env[n])
                       for n in names] for slot, names in jg.inputs.items()}

    want = jax_registry.normalize_outputs(
        jax_registry.get("__vjp_grad__").forward(gather(_to_jax),
                                                 dict(jg.attrs)))
    got = pt_registry.normalize_outputs(
        pt_registry.get("__vjp_grad__").forward(gather(_to_torch),
                                                dict(pg.attrs)))
    checked = 0
    for slot, names in jg.outputs.items():
        for i, n in enumerate(names):
            if n != "@EMPTY@":
                _compare(f"{case}:{slot}[{i}]", got[slot][i], want[slot][i],
                         case == "batch_norm[train_bf16]"
                         and slot in ("IG__Scale", "IG__Bias"))
                checked += 1
    assert checked


# ---------------------------------------------------------------------------
# optimizer ops
# ---------------------------------------------------------------------------

MOMENTUM_CASES = {
    "momentum": {"mu": 0.9, "use_nesterov": False},
    "momentum[nesterov]": {"mu": 0.9, "use_nesterov": True},
    "momentum[l2_decay]": {"mu": 0.85, "use_nesterov": False,
                           "regularization_method": "l2_decay",
                           "regularization_coeff": 1e-3},
    "sgd": {},
}


@pytest.mark.parametrize("case", sorted(MOMENTUM_CASES))
def test_optimizer_op_matches_reference_and_updates_in_place(case):
    op_type = case.split("[")[0]
    rng = np.random.RandomState(7)
    ins = {"Param": _rand(rng, 16, 3, 3, 3), "Grad": _rand(rng, 16, 3, 3, 3),
           "LearningRate": np.array([0.1], np.float32)}
    if op_type == "momentum":
        ins["Velocity"] = _rand(rng, 16, 3, 3, 3) * 0.1
    attrs = dict(MOMENTUM_CASES[case])
    want = jax_registry.get(op_type).forward(_as_lists(ins, lambda x: x),
                                             dict(attrs))
    tins = _as_lists(ins, _to_torch)
    got = pt_registry.get(op_type).forward(tins, dict(attrs))
    assert set(got) == set(want)
    for slot, w in want.items():
        np.testing.assert_allclose(got[slot].numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-6, err_msg=slot)
        assert got[slot] is tins[slot[:-len("Out")]][0]
    # the same gradient as a SelectedRows of every row, in reverse order:
    # the row update gives the dense result
    sparse = _as_lists(ins, _to_torch)
    rows = torch.arange(15, -1, -1)
    sparse["Grad"] = [SelectedRows(rows, sparse["Grad"][0][rows], 16)]
    got = pt_registry.get(op_type).forward(sparse, dict(attrs))
    for slot, w in want.items():
        np.testing.assert_allclose(got[slot].numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-6, err_msg=slot)


# ---------------------------------------------------------------------------
# programs: the pass, the AMP rewrite, the builder
# ---------------------------------------------------------------------------

TINY = dict(depth=50, num_classes=10, image_shape=(3, 32, 32),
            stages=[1, 1, 1, 1])


def _json(prog):
    return json.loads(json.dumps(prog.to_dict()))


def _forward(mod, names, cfg, batch):
    with names.guard():
        return mod.build_classifier_program(cfg, batch_size=batch,
                                            with_optimizer=False,
                                            fuse_bn_act=False)


@pytest.mark.parametrize("size", ["tiny", "full"])
def test_fuse_pass_and_amp_rewrite_match_reference(size):
    from paddle_tpu.core.passes import apply_passes as j_apply
    from paddle_tpu.distributed.fleet.meta_optimizers import \
        rewrite_program_bf16 as j_rewrite

    from paddle_tpu_torch.core.passes import apply_passes as p_apply
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        rewrite_program_bf16 as p_rewrite

    cfgs = {"tiny": (TINY, 4), "full": (dict(depth=50), 256)}
    kw, batch = cfgs[size]
    jmain = _forward(jresnet, jax_names, jresnet.ResNetConfig(**kw), batch)[0]
    pmain = _forward(presnet, pt_names, presnet.ResNetConfig(**kw), batch)[0]
    assert _json(pmain) == _json(jmain)
    n_bn = sum(o.type == "batch_norm" for o in pmain.global_block().ops)
    j_apply(jmain, ["fuse_bn_act_pass"])
    p_apply(pmain, ["fuse_bn_act_pass"])
    assert _json(pmain) == _json(jmain)
    types = Counter(o.type for o in pmain.global_block().ops)
    n_blocks = sum(TINY["stages"]) if size == "tiny" else 16
    # every bn but the stages' shortcut bns, whose add takes the other
    # branch's bn as its fused op
    assert types["fused_bn_add_act"] == n_bn - 4 == 1 + 3 * n_blocks
    assert types["relu"] == 0 and types["elementwise_add"] == 1
    j_rewrite(jmain)
    p_rewrite(pmain)
    assert _json(pmain) == _json(jmain)
    casts = [o for o in pmain.global_block().ops if o.type == "cast"]
    assert all(o.outputs["Out"][0].endswith(".cast_bf16") for o in casts)
    # the first conv's image, every conv filter, and the fc's two inputs
    assert len({o.inputs["X"][0] for o in casts}) == len(casts)


def test_full_width_resnet50_program_matches_reference():
    """build_classifier_program(resnet50(), batch_size=256, amp=True), the
    reference's benchmark row: equal JSON and op counts."""
    with jax_names.guard():
        j = jresnet.build_classifier_program(jresnet.resnet50(),
                                             batch_size=256, amp=True)
    with pt_names.guard():
        p = presnet.build_classifier_program(presnet.resnet50(),
                                             batch_size=256, amp=True)
    assert _json(p[0]) == _json(j[0]) and _json(p[1]) == _json(j[1])
    main = Counter(o.type for o in p[0].global_block().ops)
    assert sum(main.values()) == 616 and len(main) == 17
    assert main == {"conv2d": 53, "fused_bn_add_act": 49, "batch_norm": 4,
                    "cast": 104, "pool2d": 2, "momentum": 161,
                    "__vjp_grad__": 216, "sum": 16, "accuracy": 2,
                    "top_k": 2, "softmax": 1, "softmax_with_cross_entropy": 1,
                    "mean": 1, "mul": 1, "elementwise_add": 1,
                    "reshape2": 1, "fill_constant": 1}
    start = Counter(o.type for o in p[1].global_block().ops)
    assert start == {"fill_constant": 375, "gaussian_random": 53,
                     "uniform_random": 1}


@pytest.mark.parametrize("optimizer", ["momentum", "sgd", "adam"])
def test_every_optimizer_builds_the_reference_program(optimizer):
    with jax_names.guard():
        j = jresnet.build_classifier_program(jresnet.ResNetConfig(**TINY),
                                             batch_size=4,
                                             optimizer_name=optimizer)
    with pt_names.guard():
        p = presnet.build_classifier_program(presnet.ResNetConfig(**TINY),
                                             batch_size=4,
                                             optimizer_name=optimizer)
    assert _json(p[0]) == _json(j[0]) and _json(p[1]) == _json(j[1])
    assert any(o.type == optimizer for o in p[0].global_block().ops)


# ---------------------------------------------------------------------------
# MSRA
# ---------------------------------------------------------------------------

def _init_once(init, shape):
    prog = ptt.Program()
    blk = prog.global_block()
    init(blk.create_parameter("w", shape, "float32"), blk)
    scope = Scope()
    Executor(device="cpu").run(prog, scope=scope)
    return prog, scope.find_var("w")


@pytest.mark.parametrize("uniform", [False, True])
def test_msra_initializer_distribution_and_startup_op(uniform):
    from paddle_tpu import initializer as jinit

    shape = [128, 64, 3, 3]
    fan_in = 64 * 9
    prog, w = _init_once(MSRA(uniform=uniform), shape)
    assert tuple(w.shape) == tuple(shape) and w.dtype == torch.float32
    # 73 728 draws: the mean within 3 standard errors, the std within 1 %
    std = (2.0 / fan_in) ** 0.5
    assert abs(float(w.mean())) < 3 * std / len(w.reshape(-1)) ** 0.5
    assert abs(float(w.std()) / std - 1.0) < 0.01
    if uniform:
        assert float(w.abs().max()) <= (6.0 / fan_in) ** 0.5
    jprog = pt.Program()
    blk = jprog.global_block()
    jinit.MSRA(uniform=uniform)(blk.create_parameter("w", shape, "float32"),
                                blk)
    assert json.dumps(prog.to_dict(), sort_keys=True) == \
        json.dumps(jprog.to_dict(), sort_keys=True)
