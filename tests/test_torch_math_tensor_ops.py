"""Every op type of the reference's ``ops/math_ops.py`` and
``ops/tensor_ops.py`` in paddle_tpu_torch, held against paddle_tpu's
lowering on the CPU.

Both lowerings get the same numpy inputs (int64 arrives as int32 and
float64 as float32 in both, 64-bit types being off in the reference).
The cases are the reference's own sweep tables
(``tests/test_op_registry_sweep.py``: UNARY, BINARY, SHAPE_CASES,
SMOKE_CASES, imported as they are) plus edge values: NaN, +-0, +-inf,
integer division by zero and INT_MIN / -1, negative and out-of-range
indices, ties, duplicate scatter ids. Integer and bool outputs must
match bit for bit, dtype and shape included; float outputs within
FLOAT_TOL of their family (the frameworks round transcendental
functions and sums their own way). Where the reference raises, the port
must raise the same exception type. ``randint`` draws its own bits, so
it is held to its range, dtype and moments. The gradients of the
differentiable float ops go through the port's ``__vjp_grad__`` against
``jax.vjp`` of the reference's lowering."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu.core import registry as jax_registry
from tests.test_op_registry_sweep import (BINARY, SHAPE_CASES, SMOKE_CASES,
                                          UNARY)

from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.tools.glue_cases import CASES as GLUE_CASES
from paddle_tpu_torch.tools.glue_cases import _u, family, rng as _rng

torch.set_num_threads(2)

MODULES = ("math_ops", "tensor_ops", "rnn_ops", "sequence_ops",
           "beam_search_ops")

# relative = absolute tolerance of float outputs against the reference,
# by family (``glue_cases.family``)
FLOAT_TOL = {"elementwise": 2e-6, "activation": 2e-6, "reduction": 1e-5,
             "loss": 1e-5, "matmul": 1e-5, "tensor": 0.0, "rnn": 1e-5,
             "sequence": 1e-5, "beam": 0.0}


def ref_ops(module):
    return sorted(n for n, od in jax_registry._REGISTRY.items()
                  if od.forward.__module__ == f"paddle_tpu.ops.{module}")


def _t(x):
    a = np.array(x, copy=True)
    if a.dtype == np.int64:
        a = a.astype(np.int32)
    elif a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(a)


def _lists(ins, conv):
    return {k: [None if v is None else conv(v) for v in vs]
            for k, vs in ins.items()}


def run_ref(op, ins, attrs):
    return jax_registry.normalize_outputs(jax_registry.get(op).forward(
        _lists(ins, jnp.asarray), dict(attrs)))


def run_port(op, ins, attrs):
    return pt_registry.normalize_outputs(pt_registry.get(op).forward(
        _lists(ins, _t), dict(attrs)))


def compare(tag, got, want, tol):
    want = np.asarray(want)
    got = got.detach().cpu().numpy()
    assert got.shape == want.shape, (tag, got.shape, want.shape)
    assert got.dtype == want.dtype, (tag, got.dtype, want.dtype)
    if not np.issubdtype(want.dtype, np.floating) or tol == 0.0:
        np.testing.assert_array_equal(got, want, err_msg=tag)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   equal_nan=True, err_msg=tag)


def check_op(op, ins, attrs, tag=None, tol=None):
    """Run both lowerings on ``ins``; both raise the same type, or every
    output agrees (floats within ``tol``, by default their family's)."""
    tag = tag or op
    tol = FLOAT_TOL[family(op)] if tol is None else tol
    try:
        want = run_ref(op, ins, attrs)
    except Exception as e:                  # noqa: BLE001
        with pytest.raises(type(e)):
            run_port(op, ins, attrs)
        return
    got = run_port(op, ins, attrs)
    assert set(got) >= set(want), (tag, set(got), set(want))
    for slot, vals in want.items():
        assert len(got[slot]) == len(vals), (tag, slot)
        for i, w in enumerate(vals):
            compare(f"{tag}:{slot}[{i}]", got[slot][i], w, tol)


OURS = set(ref_ops("math_ops")) | set(ref_ops("tensor_ops"))

# case name "op[variant]" -> rng -> (ins, attrs): the port's glue cases
# (``tools/glue_cases.py``, the ones chip_smoke's ops_glue_card runs on
# the card) and the reference's sweep tables as they are
CASES = {c: f for c, f in GLUE_CASES.items() if c.split("[")[0] in OURS}
for _op, (_attrs, _fn, (_lo, _hi)) in UNARY.items():
    if _op in OURS:
        CASES[f"{_op}[ref_sweep]"] = (lambda r, a=_attrs, lo=_lo, hi=_hi: (
            {"X": [_u(r, (3, 4), lo, hi)]}, dict(a)))
for _op in BINARY:
    if _op in OURS:
        CASES[f"{_op}[ref_sweep]"] = lambda r: (
            {"X": [_u(r, (3, 4), 0.5, 2.0)], "Y": [_u(r, (3, 4), 0.5, 2.0)]},
            {})
for _op, (_ins, _attrs, _want) in SHAPE_CASES.items():
    if _op in OURS:
        CASES[f"{_op}[ref_sweep]"] = lambda r, i=_ins, a=_attrs: (i, dict(a))
for _op, (_ins, _attrs, _shapes) in SMOKE_CASES.items():
    # the random ops draw their own bits in the port
    if _op in OURS - {"randint", "uniform_random", "gaussian_random",
                      "truncated_gaussian_random"}:
        CASES[f"{_op}[smoke]"] = lambda r, i=_ins, a=_attrs: (i, dict(a))

# the math and tensor op types earlier slices ported, each held against
# the reference in the test files of its own slice
EARLIER = frozenset((
    "accuracy", "assign", "assign_value", "cast", "clip", "concat",
    "cross_entropy", "elementwise_add", "elementwise_div", "elementwise_max",
    "elementwise_mul", "fc", "fill_constant", "gather", "gaussian_random",
    "gelu", "increment", "isfinite", "lookup_table", "lookup_table_sparse_grad",
    "lookup_table_v2", "matmul", "matmul_v2", "mean", "mul", "one_hot",
    "one_hot_v2", "reduce_mean", "reduce_sum", "relu", "reshape2", "scale",
    "sigmoid", "sign", "slice", "softmax", "softmax_with_cross_entropy",
    "sqrt", "square", "squeeze2", "sum", "tanh", "top_k", "transpose2",
    "truncated_gaussian_random", "uniform_random", "unsqueeze2"))


def test_every_op_type_of_the_five_modules_is_registered():
    """The port registers every op type of the reference's math, tensor,
    RNN, sequence and beam-search modules: 151, 104 of them new; 208 op
    types in all with the CRF, fused-RNN and control-flow ops that came
    after them, 247 with the 2.0 API's 36 and three aliases
    (``tests/test_torch_api_ops.py``), and 248 with ``@to_static``'s
    closure op ``__jax_fn__``."""
    ours = [op for m in MODULES for op in ref_ops(m)]
    assert len(ours) == 151 and len(set(ours) - EARLIER) == 104
    missing = [op for op in ours if pt_registry.lookup(op) is None]
    assert not missing, missing
    assert len(pt_registry.registered_ops()) == 208 + 36 + 3 + 1
    # the new ops a CUDA graph cannot replay as they ran: range's length
    # is read from its bounds, randint draws from a host-seeded generator
    new_uncapturable = sorted(op for op in set(ours) - EARLIER
                              if not pt_registry.get(op).capturable)
    assert new_uncapturable == ["randint", "range"]


def test_every_new_math_and_tensor_op_has_a_case():
    covered = {c.split("[")[0] for c in CASES} | {"randint"}
    assert OURS - EARLIER <= covered, sorted(OURS - EARLIER - covered)


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_the_reference(case):
    op = case.split("[")[0]
    ins, attrs = CASES[case](_rng(case))
    check_op(op, ins, attrs, case)


def test_randint_range_dtype_and_moments():
    """Its own bits (a torch generator from the op's seed, as the port's
    uniform_random): the reference's shape and dtype, values in [low,
    high), every value drawn, the mean near the middle, one seed one
    draw."""
    attrs = {"shape": [4000], "low": -3, "high": 7, "seed": 8}
    want = np.asarray(run_ref("randint", {}, attrs)["Out"][0])
    got = run_port("randint", {}, attrs)["Out"][0]
    assert tuple(got.shape) == want.shape and got.dtype == torch.int32
    assert str(want.dtype) == "int32"
    g = got.numpy()
    assert g.min() == -3 and g.max() == 6
    assert abs(g.mean() - 1.5) < 0.2
    again = run_port("randint", {}, attrs)["Out"][0]
    assert torch.equal(got, again)
    other = run_port("randint", {}, dict(attrs, seed=9))["Out"][0]
    assert not torch.equal(got, other)
    assert not pt_registry.get("randint").capturable


# -- gradients through __vjp_grad__ against jax.vjp ---------------------------

GRAD_CASES = {
    "elementwise_sub": lambda r: ({"X": [_u(r, (2, 3, 4))],
                                   "Y": [_u(r, (3,))]}, {"axis": 1}),
    "elementwise_pow": lambda r: ({"X": [_u(r, (3, 4), 0.5, 2)],
                                   "Y": [_u(r, (3, 4), 0.5, 2)]}, {}),
    "elementwise_min": lambda r: ({"X": [_u(r, (3, 4))],
                                   "Y": [_u(r, (3, 4))]}, {}),
    "elementwise_mod": lambda r: ({"X": [_u(r, (3, 4), 1, 5)],
                                   "Y": [_u(r, (3, 4), 0.7, 2)]}, {}),
    "maximum": lambda r: ({"X": [_u(r, (3, 4))], "Y": [_u(r, (3, 4))]}, {}),
    "exp": lambda r: ({"X": [_u(r, (3, 4))]}, {}),
    "log": lambda r: ({"X": [_u(r, (3, 4), 0.2, 3)]}, {}),
    "rsqrt": lambda r: ({"X": [_u(r, (3, 4), 0.2, 3)]}, {}),
    "abs": lambda r: ({"X": [_u(r, (3, 4))]}, {}),
    "softsign": lambda r: ({"X": [_u(r, (3, 4), -3, 3)]}, {}),
    "silu": lambda r: ({"X": [_u(r, (3, 4), -3, 3)]}, {}),
    "logsigmoid": lambda r: ({"X": [_u(r, (3, 4), -3, 3)]}, {}),
    "softplus": lambda r: ({"X": [_u(r, (3, 4), -3, 3)]}, {}),
    "leaky_relu": lambda r: ({"X": [_u(r, (3, 4), -3, 3)]}, {"alpha": 0.1}),
    "elu": lambda r: ({"X": [_u(r, (3, 4), -3, 3)]}, {}),
    "hard_swish": lambda r: ({"X": [_u(r, (3, 4), -5, 5)]}, {}),
    "erf": lambda r: ({"X": [_u(r, (3, 4))]}, {}),
    "pow": lambda r: ({"X": [_u(r, (3, 4), 0.5, 2)]}, {"factor": 2.5}),
    "log_softmax": lambda r: ({"X": [_u(r, (3, 5), -3, 3)]}, {}),
    "reduce_max": lambda r: ({"X": [_u(r, (3, 4))]}, {"dim": [1]}),
    "reduce_prod": lambda r: ({"X": [_u(r, (3, 4), 0.5, 1.5)]},
                              {"dim": [0, 1]}),
    "p_norm": lambda r: ({"X": [_u(r, (3, 4))]}, {"porder": 2.0, "axis": 1}),
    "squared_l2_norm": lambda r: ({"X": [_u(r, (3, 4))]}, {}),
    "bmm": lambda r: ({"X": [_u(r, (2, 3, 4))], "Y": [_u(r, (2, 4, 5))]},
                      {}),
    "dot": lambda r: ({"X": [_u(r, (3, 5))], "Y": [_u(r, (3, 5))]}, {}),
    "huber_loss": lambda r: ({"X": [_u(r, (4, 2), -2, 2)],
                              "Y": [_u(r, (4, 2), -2, 2)]}, {}),
    "smooth_l1_loss": lambda r: ({"X": [_u(r, (4, 3), -2, 2)],
                                  "Y": [_u(r, (4, 3), -2, 2)]}, {}),
    "kldiv_loss": lambda r: ({"X": [_u(r, (4, 3))],
                              "Target": [_u(r, (4, 3), -0.2, 0.5)]},
                             {"reduction": "batchmean"}),
    "sigmoid_cross_entropy_with_logits": lambda r: (
        {"X": [_u(r, (4, 3), -3, 3)],
         "Label": [(r.rand(4, 3) > 0.5).astype(np.float32)]}, {}),
    "square_error_cost": lambda r: ({"Input": [_u(r, (4, 2))],
                                     "Label": [_u(r, (4, 2))]}, {}),
    "strided_slice": lambda r: ({"Input": [_u(r, (4, 7))]},
                                {"axes": [1], "starts": [6], "ends": [0],
                                 "strides": [-2]}),
    "gather_nd": lambda r: ({"X": [_u(r, (3, 4))],
                             "Index": [np.array([[1, 2], [1, 2], [-1, 9]],
                                                np.int32)]}, {}),
    "scatter": lambda r: ({"X": [_u(r, (5, 3))],
                           "Ids": [np.array([4, 0, 2], np.int32)],
                           "Updates": [_u(r, (3, 3))]}, {}),
    "scatter[add]": lambda r: ({"X": [_u(r, (5, 3))],
                                "Ids": [np.array([4, 4, 7], np.int32)],
                                "Updates": [_u(r, (3, 3))]},
                               {"overwrite": False}),
    "split": lambda r: ({"X": [_u(r, (3, 10))]},
                        {"axis": 1, "sections": [2, 3, 5]}),
    "stack": lambda r: ({"X": [_u(r, (2, 3)), _u(r, (2, 3))]}, {"axis": 1}),
    "expand": lambda r: ({"X": [_u(r, (2, 3))]}, {"expand_times": [2, 2]}),
    "expand_v2": lambda r: ({"X": [_u(r, (3, 1))]}, {"shape": [2, 3, 4]}),
    "where": lambda r: ({"Condition": [r.rand(3, 4) > 0.5],
                         "X": [_u(r, (3, 4))], "Y": [_u(r, (3, 4))]}, {}),
    "cumsum": lambda r: ({"X": [_u(r, (3, 4))]}, {"axis": 0,
                                                  "reverse": True}),
    "pad": lambda r: ({"X": [_u(r, (2, 3))]}, {"paddings": [1, 0, 2, 3]}),
    "tril_triu": lambda r: ({"X": [_u(r, (4, 5))]}, {"diagonal": 1,
                                                     "lower": False}),
    "flatten_contiguous_range": lambda r: (
        {"X": [_u(r, (2, 3, 4))]}, {"start_axis": 0, "stop_axis": 1}),
}


def float_slots(op, ins):
    nd = set(jax_registry.get(op).non_diff_inputs)
    return [s for s, vs in ins.items() if s not in nd and vs
            and np.issubdtype(np.asarray(vs[0]).dtype, np.floating)]


def vjp_both(op, ins, attrs, rng, tol):
    """d(sum of each float output * a seeded cotangent)/d(each float
    input), the reference by jax.vjp of its lowering, the port by its
    generic ``__vjp_grad__`` op; within ``tol``."""
    slots = float_slots(op, ins)
    fwd = jax_registry.get(op).forward

    def f(*vals):
        full = _lists({k: vs for k, vs in ins.items() if k not in slots},
                      jnp.asarray)
        for s, v in zip(slots, vals):
            full[s] = list(v)
        out = jax_registry.normalize_outputs(fwd(full, dict(attrs)))
        return {k: v for k, v in out.items()
                if all(jnp.issubdtype(x.dtype, jnp.floating) for x in v)}

    primals = [tuple(jnp.asarray(v) for v in ins[s]) for s in slots]
    out, pull = jax.vjp(f, *primals)
    cts = {k: [np.asarray(rng.randn(*np.shape(x)), np.float32) for x in v]
           for k, v in out.items()}
    want = pull({k: [jnp.asarray(c) for c in v] for k, v in cts.items()})
    pins = {f"In__{s}": [None if v is None else _t(v) for v in vs]
            for s, vs in ins.items()}
    for k, v in cts.items():
        pins[f"OG__{k}"] = [_t(c) for c in v]
    got = pt_registry.get("__vjp_grad__").forward(
        pins, {"fwd_type": op, "fwd_attrs": dict(attrs)})
    for s, w in zip(slots, want):
        for i, wi in enumerate(w):
            compare(f"{op}:d{s}[{i}]", got[f"IG__{s}"][i], wi, tol)


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_gradient_matches_the_reference(case):
    op = case.split("[")[0]
    r = _rng(case)
    ins, attrs = GRAD_CASES[case](r)
    vjp_both(op, ins, attrs, r, 2e-5)
