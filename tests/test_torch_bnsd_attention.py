"""Flash attention over the [B,H,S,D] ("bnsd") layout: the port's plain
versions held against the six bnsd TPU kernels they replace, run in Pallas
interpret mode, and the 4-D branch of the ``flash_attention`` op, its grad
op and ``layers.flash_attention`` held against the JAX package.

* Forward, ``plain_flash_fwd(layout="bnsd")`` against ``_fwd_pallas`` at
  S >= 1024 (the 2-pass ``_fwd_kernel``), ``_fwd_pallas_fused``
  (``_fused_fwd_kernel``) at S = 256 and 512 and at Sq != Sk, and
  ``_fwd_pallas_fused_g`` (``_fused_fwd_kernel_g``) at S = 128.
* Backward, ``plain_flash_bwd(layout="bnsd")`` from the kernel's own
  (out, lse) against ``_bwd_pallas`` at S >= 1024 (``_dkv_kernel`` and
  ``_dq_kernel``), ``_bwd_pallas_fused`` (``_fused_bwd_kernel``) and
  ``_bwd_pallas_fused_g`` (``_fused_bwd_kernel_g``).
  Every case is B = 1-2, H = 2, hd = 64 with a key bias, dropout 0.1 and
  a causal leg. fp32 within 1e-5 (sums in another order); dbias, a sum
  over H * Sq terms, within 1e-4. A single differing dropout bit would
  move an output by p / (1 - rate), far outside these tolerances, so the
  masks agree bit for bit.
* The op lowerings against the JAX ops on their CPU route
  (``reference_attention`` and its vjp): Out and the gradients within
  1e-5; not Lse, which that route returns as zeros
  (``flash_attention.py:1661``). BiasGrad keeps the reference's shape
  rule. A bias outside the key-bias form raises.
* A program with a 4-D ``layers.flash_attention`` serialises to the same
  JSON in both packages, backward included, and runs to the same loss and
  gradients.
"""

import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu import initializer as jinit
from paddle_tpu import layers as jlayers
from paddle_tpu.core import registry as jax_registry
from paddle_tpu.core import unique_name as jax_names
from paddle_tpu.core.backward import append_backward as jax_backward

import paddle_tpu_torch as ptt
from paddle_tpu_torch import initializer as pinit
from paddle_tpu_torch import layers as players
from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.core import unique_name as pt_names
from paddle_tpu_torch.core.backward import append_backward as pt_backward
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models.bert import scope_from_numpy

# the module: the package re-exports a function of the same name
jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

torch.set_num_threads(2)

H, HD = 2, 64
SCALE = HD ** -0.5
SEED = 0x2545F491
RATE = 0.1
TOL = 1e-5


def _inputs(b, sq, sk, seed):
    rng = np.random.RandomState(seed)
    q, do = (rng.randn(b, H, sq, HD).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, H, sk, HD).astype(np.float32) for _ in range(2))
    kb = np.where(rng.rand(b, sk) < 0.25, -1e4, 0.0).astype(np.float32)
    return q, k, v, do, kb


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


# (TPU kernel, its launcher, B, Sq, Sk, causal); every case has a key bias
# and dropout
FWD_CASES = [
    ("_fwd_kernel", "_fwd_pallas", 1, 1024, 1024, False),
    ("_fwd_kernel", "_fwd_pallas", 1, 1024, 1024, True),
    ("_fwd_kernel", "_fwd_pallas", 1, 512, 1024, True),
    ("_fused_fwd_kernel", "_fwd_pallas_fused", 2, 256, 256, False),
    ("_fused_fwd_kernel", "_fwd_pallas_fused", 1, 512, 512, True),
    ("_fused_fwd_kernel", "_fwd_pallas_fused", 2, 256, 128, False),
    ("_fused_fwd_kernel", "_fwd_pallas_fused", 1, 128, 256, True),
    ("_fused_fwd_kernel_g", "_fwd_pallas_fused_g", 2, 128, 128, False),
    ("_fused_fwd_kernel_g", "_fwd_pallas_fused_g", 1, 128, 128, True),
]
BWD_CASES = [
    ("_dkv_kernel+_dq_kernel", "_bwd_pallas", 1, 1024, 1024, False),
    ("_dkv_kernel+_dq_kernel", "_bwd_pallas", 1, 1024, 1024, True),
    ("_dkv_kernel+_dq_kernel", "_bwd_pallas", 1, 512, 1024, True),
    ("_fused_bwd_kernel", "_bwd_pallas_fused", 2, 256, 256, False),
    ("_fused_bwd_kernel", "_bwd_pallas_fused", 1, 512, 512, True),
    ("_fused_bwd_kernel", "_bwd_pallas_fused", 2, 256, 128, False),
    ("_fused_bwd_kernel", "_bwd_pallas_fused", 1, 128, 256, True),
    ("_fused_bwd_kernel_g", "_bwd_pallas_fused_g", 2, 128, 128, False),
    ("_fused_bwd_kernel_g", "_bwd_pallas_fused_g", 1, 128, 128, True),
]


def _jax_fwd(launcher, q, k, v, kb, causal):
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kb),
            causal, SCALE, True)
    if launcher == "_fwd_pallas":
        sq, sk = q.shape[2], k.shape[2]
        # the 2-pass route: no single block covers the row
        assert not jfa._fused_g(sq, sk, H) and \
            not jfa._fused_bwd_applies(sq, sk)
        return jfa._fwd_pallas(*args, jnp.uint32(SEED), RATE)
    if launcher == "_fwd_pallas_fused_g":
        return jfa._fwd_pallas_fused_g(*args, 2, jnp.uint32(SEED), RATE)
    return jfa._fwd_pallas_fused(*args, jnp.uint32(SEED), RATE)


@pytest.mark.parametrize("kernel,launcher,b,sq,sk,causal", FWD_CASES)
def test_plain_bnsd_forward_matches_the_tpu_kernel(kernel, launcher, b, sq,
                                                   sk, causal):
    q, k, v, _, kb = _inputs(b, sq, sk, sq + sk + causal)
    want_o, want_lse = _jax_fwd(launcher, q, k, v, kb, causal)
    out, lse = fa.flash_fwd(_t(q), _t(k), _t(v), None, SCALE, causal, _t(kb),
                            RATE, SEED, layout="bnsd")
    assert out.shape == q.shape and lse.shape == (b, H, sq)
    _close(out, want_o, what=f"{kernel} out")
    _close(lse, want_lse, what=f"{kernel} lse")


@pytest.mark.parametrize("kernel,launcher,b,sq,sk,causal", BWD_CASES)
def test_plain_bnsd_backward_matches_the_tpu_kernel(kernel, launcher, b, sq,
                                                    sk, causal):
    q, k, v, do, kb = _inputs(b, sq, sk, 3 * sq + sk + causal)
    fwd = launcher.replace("_bwd_", "_fwd_")
    o, lse = _jax_fwd(fwd, q, k, v, kb, causal)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kb),
            causal, SCALE, True)
    if launcher == "_bwd_pallas_fused_g":
        want = jfa._bwd_pallas_fused_g(*args, 2, o, lse, jnp.asarray(do),
                                       jnp.uint32(SEED), RATE)
    else:
        want = getattr(jfa, launcher)(*args, o, lse, jnp.asarray(do),
                                      jnp.uint32(SEED), RATE)
    got = fa.flash_bwd(_t(q), _t(k), _t(v), _t(o), _t(lse), _t(do), None,
                       SCALE, causal, _t(kb), RATE, SEED, layout="bnsd")
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        _close(g, w, TOL * (10 if name == "dbias" else 1),
               f"{kernel} {name}")


def test_plain_bnsd_is_plain_packed_over_a_view():
    q, k, v, do, kb = (_t(x) for x in _inputs(2, 96, 160, 5))

    def packed(t):
        return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], H * HD)

    o4, l4 = fa.flash_fwd(q, k, v, None, SCALE, True, kb, RATE, 3,
                          layout="bnsd")
    o3, l3 = fa.packed_flash_fwd(packed(q), packed(k), packed(v), H, SCALE,
                                 True, kb, RATE, 3)
    assert torch.equal(packed(o4), o3) and torch.equal(l4, l3)
    g4 = fa.flash_bwd(q, k, v, o4, l4, do, H, SCALE, True, kb, RATE, 3,
                      layout="bnsd")
    g3 = fa.packed_flash_bwd(packed(q), packed(k), packed(v), o3, l3,
                             packed(do), H, SCALE, True, kb, RATE, 3)
    for a, c in zip(g4[:3], g3[:3]):
        assert torch.equal(packed(a), c)
    assert torch.equal(g4[3], g3[3])
    with pytest.raises(ValueError):
        fa.flash_fwd(q, k, v, 3, SCALE, True, layout="bnsd")
    with pytest.raises(ValueError):
        fa.flash_fwd(q, k, v, None, SCALE, True, layout="bshd")


# ---------------------------------------------------------------------------
# the 4-D op lowerings
# ---------------------------------------------------------------------------

def _op_inputs(bias_shape, seed):
    q, k, v, do, kb = _inputs(2, 96, 128, seed)
    ins = {"Q": q, "K": k, "V": v}
    if bias_shape is not None:
        ins["Bias"] = np.broadcast_to(
            kb[:, None, None, :] if len(bias_shape) == 4 else kb,
            (2, 128) if len(bias_shape) == 2 else (2, 1, 1, 128)
        )[tuple(slice(0, n) for n in bias_shape)].copy()
    return ins, do


ATTRS = {"causal": True, "scale": 0.2, "dropout_prob": RATE, "seed": 13,
         "is_test": False, "__step__": np.int32(4)}


def _jax_op(op_type, ins, attrs):
    return jax_registry.normalize_outputs(jax_registry.get(op_type).forward(
        {k: [jnp.asarray(v)] for k, v in ins.items()}, dict(attrs)))


def _pt_op(op_type, ins, attrs):
    return pt_registry.normalize_outputs(pt_registry.get(op_type).forward(
        {k: [v if isinstance(v, torch.Tensor) else _t(v)]
         for k, v in ins.items()}, dict(attrs)))


@pytest.mark.parametrize("bias_shape,causal", [
    (None, True), ((2, 1, 1, 128), True), ((2, 128), False),
    ((1, 1, 1, 128), False)])
def test_4d_flash_ops_match_the_reference(bias_shape, causal):
    ins, do = _op_inputs(bias_shape, len(bias_shape or ()) + causal)
    attrs = dict(ATTRS, causal=causal)
    jf = _jax_op("flash_attention", ins, attrs)
    pf = _pt_op("flash_attention", ins, attrs)
    assert pf["Out"][0].shape == ins["Q"].shape
    assert pf["Lse"][0].shape == (2, H, 96)
    _close(pf["Out"][0], jf["Out"][0], what="Out")
    # each grad op gets its own package's saved forward: the reference's
    # CPU route recomputes and ignores its zero Lse
    g_ins = dict(ins, OutGrad=do)
    jg = _jax_op("flash_attention_grad",
                 dict(g_ins, Out=np.asarray(jf["Out"][0]),
                      Lse=np.asarray(jf["Lse"][0])), attrs)
    pg = _pt_op("flash_attention_grad",
                dict(g_ins, Out=pf["Out"][0], Lse=pf["Lse"][0]), attrs)
    assert set(pg) == set(jg)
    for slot in jg:
        assert tuple(pg[slot][0].shape) == tuple(jg[slot][0].shape), slot
        _close(pg[slot][0], jg[slot][0], TOL * (10 if slot == "BiasGrad"
                                                 else 1), slot)


def test_4d_flash_op_refuses_a_full_bias():
    ins, _ = _op_inputs(None, 0)
    ins["Bias"] = np.zeros((2, H, 96, 128), np.float32)
    with pytest.raises(NotImplementedError, match="reference_general"):
        _pt_op("flash_attention", ins, ATTRS)


# ---------------------------------------------------------------------------
# a 4-D layers.flash_attention program in both packages
# ---------------------------------------------------------------------------

B, S = 2, 128


def _program(mod, layers, names, init, append_backward, dtype="float32"):
    main, startup = mod.Program(), mod.Program()
    with names.guard(), mod.program_guard(main, startup):
        x = layers.static_data("x", [B, H, S, HD], dtype)
        mask = layers.static_data("mask", [B, S], "float32")
        w = [layers.create_parameter(
            [HD, HD], dtype, name=f"w_{c}",
            default_initializer=init.Normal(0.0, 0.2))
            for c in "qkv"]
        q, k, v = (layers.matmul(x, wi) for wi in w)
        bias = layers.unsqueeze(
            layers.scale(mask, scale=10000.0, bias=-1.0,
                         bias_after_scale=False), [1, 2])
        bias.stop_gradient = True
        out = layers.flash_attention(q, k, v, bias=bias, causal=True,
                                     dropout_rate=RATE)
        loss = layers.mean(layers.elementwise_mul(out, out))
        append_backward(loss)
    return main, startup, loss


def _same_json(dtype):
    jprogs = _program(pt, jlayers, jax_names, jinit, jax_backward, dtype)
    pprogs = _program(ptt, players, pt_names, pinit, pt_backward, dtype)
    for j, p in zip(jprogs[:2], pprogs[:2]):
        assert json.loads(json.dumps(p.to_dict())) == \
            json.loads(json.dumps(j.to_dict()))
    return jprogs, pprogs


def test_4d_flash_program_in_bf16_matches_the_reference():
    """A bf16 loss too: its gradient seed is a bf16 fill_constant."""
    _, (pmain, _, ploss) = _same_json("bfloat16")
    seed = next(o for o in pmain.global_block().ops
                if o.type == "fill_constant"
                and o.outputs["Out"] == [ploss.name + "@GRAD"])
    assert seed.attrs["dtype"] == "bfloat16"


def test_4d_flash_program_matches_the_reference():
    (jmain, jstart, jloss), (pmain, _, _) = _same_json("float32")
    ops = {o.type: o for o in pmain.global_block().ops}
    assert {"flash_attention", "flash_attention_grad"} <= set(ops)
    assert "num_heads" not in ops["flash_attention"].attrs
    assert pmain.global_block().var(
        ops["flash_attention"].outputs["Lse"][0]).shape == (B, H, S)

    rng = np.random.RandomState(3)
    feed = {"x": rng.randn(B, H, S, HD).astype(np.float32),
            "mask": (rng.rand(B, S) < 0.8).astype(np.float32)}
    jscope = pt.Scope()
    jexe = pt.Executor(pt.CPUPlace())
    jexe.run(jstart, scope=jscope, use_compiled=False)
    pscope = scope_from_numpy({n: np.asarray(v) for n, v in jscope.items()},
                              "cpu")
    fetch = [jloss.name, "w_q@GRAD", "w_k@GRAD", "w_v@GRAD"]
    pexe = Executor(device="cpu")
    for _ in range(2):
        want = jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope,
                        use_compiled=False)
        got = pexe.run(pmain, feed=feed, fetch_list=fetch, scope=pscope)
        for name, w, g in zip(fetch, want, got):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                       atol=1e-6, err_msg=name)
