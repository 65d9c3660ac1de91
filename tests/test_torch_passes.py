"""The inference passes, the verifier and the ops they emit, held against
the reference on the CPU.

* The registry equals the reference's: eight passes.
* BERT-tiny (2 layers, hidden 32, 2 heads, S 32, vocab 64) built as the
  reference's inference program, pruned to the NSP logits: each of the
  seven ``DEFAULT_PASSES`` alone, and all of them in order, gives the
  reference's program JSON after every pass; the port's fetch after the
  passes is within 1e-5 of the unpassed program's and of the reference's,
  on the reference's startup weights.
* ``conv_bn_fuse_pass`` on a small ResNet block (conv -> batch_norm at
  is_test -> relu, twice) folds to the reference's weights within 1e-6.
* The reference's own cases, imported and run as they are, with the
  port beside them: ``tests/test_inference.py``'s pass cases (every
  ``apply_passes`` call also runs the port's passes on the same program
  and scope and holds the JSON, and any folded weights, to the
  reference's) and ``tests/test_verify.py``'s corrupted programs (every
  ``verify_program`` call also verifies the same program in the port:
  the same outcome, the same checks, the same first error).
* The lowerings the passes emit (``fc``, ``transpose2`` and its
  ``__vjp_grad__``, ``fused_embedding_eltwise_layernorm``,
  ``fused_elemwise_activation``, ``fusion_group``) against the
  reference's, within 1e-6.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
import paddle_tpu.core.passes as jax_passes
import paddle_tpu.core.verify as jax_verify
from paddle_tpu import io as jio
from paddle_tpu.core import registry as jax_registry
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu.core.ir import OpDesc as JOpDesc
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch as ptt
from paddle_tpu_torch import io as pio
from paddle_tpu_torch.core import passes as pt_passes
from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.core import unique_name as p_unique
from paddle_tpu_torch.core import verify as pt_verify
from paddle_tpu_torch.core.ir import OpDesc as POpDesc
from paddle_tpu_torch.core.scope import scope_from_numpy
from paddle_tpu_torch.inference import DEFAULT_PASSES
from paddle_tpu_torch.models import bert as pbert

import tests.test_inference as ref_inference
import tests.test_verify as ref_verify

torch.set_num_threads(2)

TINY = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=32)
SEQ = 32
FEEDS = ["src_ids", "sent_ids", "pos_ids", "input_mask"]
NSP = "fc_0.tmp_1"


def _json(program):
    return json.dumps(program.to_dict(), sort_keys=True)


def _port(program):
    return ptt.Program.from_dict(json.loads(json.dumps(program.to_dict())))


def _scope_arrays(scope):
    return {n: np.array(v) for n, v in scope.items()}


def bert_tiny_inference():
    """(reference pruned program, port pruned program, reference scope):
    both packages build BERT-tiny's inference program with fresh name
    generators; the reference's startup gives the weights."""
    j_unique.switch()
    p_unique.switch()
    jmain, jstart, _, _ = jbert.build_pretraining_program(
        jbert.BertConfig(**TINY), seq_len=SEQ, with_optimizer=False,
        is_test=True)
    pmain, _, _, _ = pbert.build_pretraining_program(
        pbert.BertConfig(**TINY), seq_len=SEQ, with_optimizer=False,
        is_test=True)
    scope = pt.Scope()
    pt.Executor().run(jstart, scope=scope, use_compiled=False)
    return (jio.prune_program(jmain, FEEDS, [NSP]),
            pio.prune_program(pmain, FEEDS, [NSP]), scope)


def bert_batch(b=3, seed=0):
    rng = np.random.RandomState(seed)
    lens = np.array([SEQ, 20, 5, 11][:b])[:, None]
    mask = np.arange(SEQ)[None, :] < lens
    return {"src_ids": (rng.randint(1, 64, (b, SEQ)) * mask).astype(np.int64),
            "sent_ids": (rng.randint(0, 2, (b, SEQ)) * mask).astype(np.int64),
            "pos_ids": np.tile(np.arange(SEQ), (b, 1)).astype(np.int64),
            "input_mask": mask.astype(np.float32)}


def _run_port(program, arrays, batch):
    scope = scope_from_numpy(arrays, "cpu")
    out, = ptt.Executor(device="cpu").run(program, feed=batch,
                                          fetch_list=[NSP], scope=scope,
                                          use_compiled=False)
    return out


def test_pass_registry_equals_the_reference():
    assert pt_passes.registered_passes() == jax_passes.registered_passes()
    assert len(pt_passes.registered_passes()) == 8
    assert "fuse_bn_act_pass" in pt_passes.registered_passes()
    for t in ("transpose2", "fc", "fused_embedding_eltwise_layernorm",
              "fused_elemwise_activation", "fusion_group"):
        assert pt_registry.lookup(t) is not None, t


@pytest.mark.parametrize("passes", [[p] for p in DEFAULT_PASSES]
                         + [list(DEFAULT_PASSES)],
                         ids=list(DEFAULT_PASSES) + ["DEFAULT_PASSES"])
def test_bert_tiny_passes_json_and_fetch(passes):
    jprog, pprog, jscope = bert_tiny_inference()
    assert _json(pprog) == _json(jprog)
    arrays = _scope_arrays(jscope)
    batch = bert_batch()
    before = _run_port(pprog, arrays, batch)
    pscope = scope_from_numpy(arrays, "cpu")
    for name in passes:
        jax_passes.apply_passes(jprog, [name], scope=jscope,
                                feed_names=FEEDS, fetch_names=[NSP])
        pt_passes.apply_passes(pprog, [name], scope=pscope,
                               feed_names=FEEDS, fetch_names=[NSP])
        assert _json(pprog) == _json(jprog), f"JSON differs after {name}"
    after = _run_port(pprog, arrays, batch)
    want, = pt.Executor().run(jprog, feed=batch, fetch_list=[NSP],
                              scope=jscope, use_compiled=False)
    np.testing.assert_allclose(after, before, rtol=0, atol=1e-5)
    np.testing.assert_allclose(after, np.asarray(want), rtol=0, atol=1e-5)
    if passes == list(DEFAULT_PASSES):
        types = [o.type for o in pprog.global_block().ops]
        assert types.count("flash_attention") == TINY["num_hidden_layers"]
        assert "dropout" not in types and "softmax" not in types


def _resnet_block(pkg, layers):
    """conv -> batch_norm(is_test) -> relu, twice, on [N,3,8,8]."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = layers.data("x", [3, 8, 8])
        h = layers.conv2d(x, 6, 3, padding=1, bias_attr=False)
        h = layers.batch_norm(h, act="relu", is_test=True)
        h = layers.conv2d(h, 6, 3, padding=1, bias_attr=False)
        y = layers.batch_norm(h, act="relu", is_test=True)
    return main, startup, y


def test_conv_bn_fuse_folds_the_reference_weights():
    from paddle_tpu import layers as jl
    from paddle_tpu_torch import layers as pl

    j_unique.switch()
    p_unique.switch()
    jmain, jstart, jy = _resnet_block(pt, jl)
    pmain, _, py = _resnet_block(ptt, pl)
    assert _json(pmain) == _json(jmain)
    jscope = pt.Scope()
    pt.Executor().run(jstart, scope=jscope, use_compiled=False)
    rng = np.random.RandomState(0)
    for name, v in list(jscope.items()):
        a = np.asarray(v)
        if "mean" in name:   # running statistics that make the fold work
            jscope.set(name, rng.uniform(-0.5, 0.5, a.shape).astype(a.dtype))
        elif "variance" in name:
            jscope.set(name, rng.uniform(0.5, 2.0, a.shape).astype(a.dtype))
    arrays = _scope_arrays(jscope)
    pscope = scope_from_numpy(arrays, "cpu")
    x = rng.randn(2, 3, 8, 8).astype(np.float32)
    exe = ptt.Executor(device="cpu")
    before, = exe.run(pmain, feed={"x": x}, fetch_list=[py.name],
                      scope=pscope, use_compiled=False)
    j_unique.switch()
    p_unique.switch()
    jax_passes.apply_passes(jmain, ["conv_bn_fuse_pass"], scope=jscope)
    pt_passes.apply_passes(pmain, ["conv_bn_fuse_pass"], scope=pscope)
    assert _json(pmain) == _json(jmain)
    folded = [n for n in dict(jscope.items()) if "@bn_" in n]
    assert len(folded) == 4
    for n in folded:
        np.testing.assert_allclose(pscope.find_var(n).numpy(),
                                   np.asarray(jscope.find_var(n)),
                                   rtol=0, atol=1e-6)
    after, = exe.run(pmain, feed={"x": x}, fetch_list=[py.name],
                     scope=pscope, use_compiled=False)
    want, = pt.Executor().run(jmain, feed={"x": x}, fetch_list=[jy.name],
                              scope=jscope, use_compiled=False)
    np.testing.assert_allclose(after, before, rtol=0, atol=1e-5)
    np.testing.assert_allclose(after, np.asarray(want), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the reference's own cases, the port run beside them
# ---------------------------------------------------------------------------

@pytest.fixture
def passes_beside(monkeypatch):
    """Every reference apply_passes call also runs the port's passes on a
    JSON copy of the program (and a copy of the scope): the JSON after
    them, and every value a pass put in the scope, must equal the
    reference's."""
    real = jax_passes.apply_passes
    calls = []

    def both(program, names, scope=None, feed_names=None, fetch_names=None,
             verify=None):
        pprog = _port(program)
        pscope = None if scope is None else scope_from_numpy(
            _scope_arrays(scope), "cpu")
        before = set() if scope is None else set(dict(scope.items()))
        p_unique.switch()
        out = real(program, names, scope=scope, feed_names=feed_names,
                   fetch_names=fetch_names, verify=verify)
        pt_passes.apply_passes(pprog, names, scope=pscope,
                               feed_names=feed_names,
                               fetch_names=fetch_names, verify=verify)
        assert _json(pprog) == _json(out), f"JSON differs after {names}"
        if scope is not None:
            for n in set(dict(scope.items())) - before:
                np.testing.assert_allclose(
                    pscope.find_var(n).numpy(), np.asarray(scope.find_var(n)),
                    rtol=0, atol=1e-6)
        calls.append(list(names))
        return out

    monkeypatch.setattr(jax_passes, "apply_passes", both)
    return calls


PASS_CASES = [("TestPasses", "test_attention_fuse_and_dropout_delete"),
              ("TestPasses", "test_embedding_eltwise_layernorm_fuse"),
              ("TestPasses", "test_fuse_elewise_add_act"),
              ("TestPasses", "test_fuse_add_gelu_keeps_exact_form"),
              ("TestPasses", "test_conv_bn_fuse"),
              ("TestPasses", "test_fc_fuse_simple"),
              ("TestFusionGroupPass", "test_pass_groups_and_matches"),
              ("TestFusionGroupPass", "test_intermediate_stays_fetchable")]


@pytest.mark.parametrize("cls,case", PASS_CASES,
                         ids=[c for _, c in PASS_CASES])
def test_reference_pass_cases_beside_the_port(cls, case, passes_beside):
    getattr(getattr(ref_inference, cls)(), case)(pt.Scope())
    assert passes_beside, "the case applied no pass"


@pytest.fixture
def verify_beside(monkeypatch):
    """Every reference verify_program call of tests/test_verify.py also
    verifies a JSON copy of the program in the port: the same outcome,
    the same checks fired, and the same located first error."""
    real = ref_verify.verify_program
    calls = []

    def both(program, **kw):
        pprog = _port(program)
        pkw = dict(kw)
        if kw.get("scope") is not None:
            pkw["scope"] = scope_from_numpy(_scope_arrays(kw["scope"]), "cpu")
        jerr = perr = None
        try:
            res = real(program, **kw)
        except jax_verify.ProgramVerifyError as e:
            jerr = e
        try:
            pres = pt_verify.verify_program(pprog, **pkw)
        except pt_verify.ProgramVerifyError as e:
            perr = e
        calls.append(kw)
        assert (jerr is None) == (perr is None), (jerr, perr)
        if jerr is not None:
            assert {v.check for v in perr.violations} == \
                {v.check for v in jerr.violations}
            assert (perr.check, perr.block_idx, perr.op_idx, perr.op_type) \
                == (jerr.check, jerr.block_idx, jerr.op_idx, jerr.op_type)
            raise jerr
        assert [(v.check, v.var) for v in pres.violations] == \
            [(v.check, v.var) for v in res.violations]
        return res

    monkeypatch.setattr(ref_verify, "verify_program", both)
    return calls


VERIFY_CASES = [("TestCorruptionClasses", n) for n in (
    "test_clean_program_verifies", "test_dangling_input",
    "test_undefined_output", "test_unregistered_op", "test_def_after_use",
    "test_waw_hazard", "test_waw_with_intervening_read_is_clean",
    "test_static_shape_mismatch_lowering_rejects",
    "test_static_shape_mismatch_declared_vs_inferred",
    "test_shapes_check_is_opt_in", "test_missing_required_attr",
    "test_dangling_read_with_feed_knowledge", "test_missing_fetch",
    "test_donated_feed_overlap")] + [
    ("TestTypedError", "test_error_carries_location_and_message"),
    ("TestTypedError", "test_warnings_do_not_raise"),
    ("TestApplyPassesGate", "test_fc_fuse_prunes_orphaned_intermediate")]


@pytest.mark.parametrize("cls,case", VERIFY_CASES,
                         ids=[c for _, c in VERIFY_CASES])
def test_reference_verifier_cases_beside_the_port(cls, case, verify_beside):
    getattr(getattr(ref_verify, cls)(), case)()
    assert verify_beside, "the case verified nothing"


def test_bad_pass_is_named_and_verify_false_skips():
    main, startup = ptt.Program(), ptt.Program()
    from paddle_tpu_torch import layers as pl

    with ptt.program_guard(main, startup):
        x = pl.data("x", [4])
        pl.fc(x, 8)

    @pt_passes.register_pass("_test_bad_pass")
    def _bad(program):
        program.global_block().ops[0].inputs["X"] = ["vanished"]
        return program

    try:
        with pytest.raises(pt_verify.ProgramVerifyError) as ei:
            pt_passes.apply_passes(main, ["_test_bad_pass"])
        assert "_test_bad_pass" in str(ei.value)
        assert ei.value.check == "dangling_input"
        pt_passes.apply_passes(_port(main), ["_test_bad_pass"], verify=False)
    finally:
        pt_passes._PASS_REGISTRY.pop("_test_bad_pass", None)


# ---------------------------------------------------------------------------
# the lowerings the passes emit
# ---------------------------------------------------------------------------

def _jax_op(op_type, ins, attrs):
    return jax_registry.normalize_outputs(jax_registry.get(op_type).forward(
        {k: [jnp.asarray(a) for a in v] for k, v in ins.items()},
        dict(attrs)))


def _pt_op(op_type, ins, attrs):
    return pt_registry.normalize_outputs(pt_registry.get(op_type).forward(
        {k: [torch.from_numpy(np.array(a)) for a in v]
         for k, v in ins.items()}, dict(attrs)))


def _case_inputs(name, rng):
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    if name == "fc[3d]":
        return "fc", {"Input": [f(2, 5, 8)], "W": [f(8, 6)], "Bias": [f(6)]}, \
            {"in_num_col_dims": 2}
    if name == "fc[nobias]":
        return "fc", {"Input": [f(4, 8)], "W": [f(8, 3)]}, \
            {"in_num_col_dims": 1}
    if name == "transpose2":
        return "transpose2", {"X": [f(2, 5, 3, 4)]}, {"axis": [0, 2, 1, 3]}
    if name == "fused_embedding_eltwise_layernorm":
        ids = [rng.randint(-2, n + 2, (2, 7)).astype(np.int32)
               for n in (11, 3, 9)]
        return name, {"Ids": ids, "Embs": [f(11, 6), f(3, 6), f(9, 6)],
                      "Scale": [f(6)], "Bias": [f(6)]}, {"epsilon": 1e-12}
    act = name.split("[")[1][:-1]
    return "fused_elemwise_activation", {"X": [f(3, 8)], "Y": [f(3, 8)]}, \
        {"functor_list": act.split(","), "approximate": True, "scale": 1.5}


OP_CASES = ["fc[3d]", "fc[nobias]", "transpose2",
            "fused_embedding_eltwise_layernorm",
            "fused_elemwise_activation[elementwise_add,relu]",
            "fused_elemwise_activation[elementwise_add,gelu]",
            "fused_elemwise_activation[elementwise_add,tanh]",
            "fused_elemwise_activation[elementwise_add,sigmoid]",
            "fused_elemwise_activation[elementwise_mul,scale]",
            "fused_elemwise_activation[relu,elementwise_add]"]


@pytest.mark.parametrize("case", OP_CASES)
def test_emitted_op_matches_reference(case):
    rng = np.random.RandomState(sum(map(ord, case)))
    op_type, ins, attrs = _case_inputs(case, rng)
    want = _jax_op(op_type, ins, attrs)
    got = _pt_op(op_type, ins, attrs)
    for slot, vals in want.items():
        for w, g in zip(vals, got[slot]):
            assert tuple(g.shape) == tuple(w.shape), slot
            if slot == "XShape":
                continue
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-6, err_msg=slot)


@pytest.mark.parametrize("case", ["transpose2", "fc[3d]"])
def test_emitted_op_vjp_grad_matches_reference(case):
    """Both packages make the same generic grad op, and its lowering
    returns the same gradients."""
    rng = np.random.RandomState(7)
    op_type, ins, attrs = _case_inputs(case, rng)
    outs = _jax_op(op_type, ins, attrs)
    in_names = {s: [f"{s}_{i}" for i in range(len(v))] for s, v in ins.items()}
    out_names = {s: [f"{s}_{i}" for i in range(len(v))]
                 for s, v in outs.items()}
    out_grads = {s: [None if s == "XShape" else f"{n}@GRAD" for n in names]
                 for s, names in out_names.items()}
    in_grads = {s: [f"{n}@GRAD" for n in names] for s, names in
                in_names.items()}
    (jg,) = jax_registry.default_grad_maker(
        JOpDesc(op_type, in_names, out_names, attrs), out_grads, in_grads)
    (pg,) = pt_registry.default_grad_maker(
        POpDesc(op_type, in_names, out_names, attrs), out_grads, in_grads)
    assert json.dumps(pg.to_dict(), sort_keys=True) == \
        json.dumps(jg.to_dict(), sort_keys=True)
    env = {n: a for s, names in in_names.items()
           for n, a in zip(names, ins[s])}
    for s, names in out_names.items():
        if s != "XShape":
            env.update({f"{n}@GRAD": rng.randn(*np.shape(o)).astype(
                np.float32) for n, o in zip(names, outs[s])})
    g_ins = {slot: [None if n == "@EMPTY@" else env[n] for n in names]
             for slot, names in jg.inputs.items()}
    want = jax_registry.normalize_outputs(jax_registry.get(
        "__vjp_grad__").forward({k: [None if a is None else jnp.asarray(a)
                                     for a in v] for k, v in g_ins.items()},
                                dict(jg.attrs)))
    got = pt_registry.normalize_outputs(pt_registry.get(
        "__vjp_grad__").forward({k: [None if a is None else
                                     torch.from_numpy(a) for a in v]
                                 for k, v in g_ins.items()}, dict(jg.attrs)))
    for slot, vals in want.items():
        for w, g in zip(vals, got[slot]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-5, err_msg=slot)


def test_fusion_group_replays_its_sub_ops_as_the_reference():
    from paddle_tpu import layers as jl
    from paddle_tpu_torch import layers as pl

    def build(pkg, layers):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = layers.data("x", [16])
            h = layers.scale(layers.tanh(x), scale=1.7, bias=0.3)
            out = layers.relu(layers.elementwise_mul(h, x))
        return main, out

    j_unique.switch()
    p_unique.switch()
    jmain, jout = build(pt, jl)
    pmain, pout = build(ptt, pl)
    jax_passes.apply_passes(jmain, ["fusion_group_pass"])
    pt_passes.apply_passes(pmain, ["fusion_group_pass"])
    assert _json(pmain) == _json(jmain)
    assert [o.type for o in pmain.global_block().ops] == ["fusion_group"]
    x = np.random.RandomState(3).randn(4, 16).astype(np.float32)
    want, = pt.Executor().run(jmain, feed={"x": x}, fetch_list=[jout.name],
                              scope=pt.Scope(), use_compiled=False)
    for compiled in (False, True):
        got, = ptt.Executor(device="cpu").run(
            pmain, feed={"x": x}, fetch_list=[pout.name], scope=ptt.Scope(),
            use_compiled=compiled)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)
