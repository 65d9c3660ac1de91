"""Every op type of the reference's ``ops/linalg_ops.py`` in
paddle_tpu_torch, held against paddle_tpu's lowering on the CPU, and the
registry count the two modules of this slice bring.

Both lowerings get the same numpy inputs (int64 as int32, float64 as
float32, ``BF16`` inputs as bfloat16 in both). The cases are the glue
cases of ``paddle_tpu_torch/tools/glue_cases.py`` (the ones chip_smoke's
``ops_glue_card`` also runs on the card): edge values (NaN, +-0, +-inf),
ties, out-of-range and negative indices, repeated scatter rows, a
singular and a non-positive-definite matrix, ``axis=None`` and
``reduce_all``, integer and bf16 inputs; and the reference's own case
tables (``tests/test_ops_batch2.py`` TestAddmm through TestShardIndex and
TestOpsBatch3), imported as they are. Integer and bool outputs match bit
for bit with their dtype and shape; float outputs within ``TOL`` of
their family (bf16 outputs within ``BF16_TOL``). Where the reference
raises, the port raises the same exception type. Gradients go through
the port's ``__vjp_grad__`` against ``jax.vjp`` of the reference's
lowering within ``GRAD_TOL``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
import tests.test_ops_batch2 as ref_b2
from paddle_tpu.core import registry as jax_registry

from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.tools.glue_cases import (BF16, CASES, LINALG_OPS,
                                               EXTRA_OPS, as_tensor, family)
from paddle_tpu_torch.tools.glue_cases import rng as _rng

torch.set_num_threads(2)

# relative = absolute tolerance of float outputs against the reference
TOL = {"matmul": 1e-5, "reduction": 1e-5, "tensor": 0.0, "loss": 1e-5,
       "activation": 2e-6, "elementwise": 2e-6}
# a bf16 output: both sides round to bf16, the reference after each bf16
# step, torch after computing in fp32 (2 bf16 ulps)
BF16_TOL = 1.6e-2
GRAD_TOL = 2e-5


def ref_ops(module):
    return sorted(n for n, od in jax_registry._REGISTRY.items()
                  if od.forward.__module__ == f"paddle_tpu.ops.{module}")


def _jax_in(v):
    if isinstance(v, BF16):
        return jnp.asarray(v.values, jnp.bfloat16)
    a = np.array(v, copy=True)
    return jnp.asarray(a)


def run_ref(op, ins, attrs):
    return jax_registry.normalize_outputs(jax_registry.get(op).forward(
        {k: [None if v is None else _jax_in(v) for v in vs]
         for k, vs in ins.items()}, dict(attrs)))


def run_port(op, ins, attrs):
    return pt_registry.normalize_outputs(pt_registry.get(op).forward(
        {k: [None if v is None else as_tensor(v) for v in vs]
         for k, vs in ins.items()}, dict(attrs)))


def _np(x):
    """A port output as numpy with the reference's dtype name."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.float().numpy(), "bfloat16"
        return x.numpy(), str(x.numpy().dtype)
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.astype(np.float32), "bfloat16"
    return a, str(a.dtype)


def compare(tag, got, want, tol):
    (g, gd), (w, wd) = _np(got), _np(want)
    assert g.shape == w.shape, (tag, g.shape, w.shape)
    assert gd == wd, (tag, gd, wd)
    if wd == "bfloat16":
        tol = max(tol, BF16_TOL)
    if not np.issubdtype(w.dtype, np.floating) or tol == 0.0:
        np.testing.assert_array_equal(g, w, err_msg=tag)
    else:
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, equal_nan=True,
                                   err_msg=tag)


def check_op(op, ins, attrs, tag=None, tol=None):
    """Both lowerings on ``ins``: both raise the same type, or every
    output of the reference agrees."""
    tag = tag or op
    tol = TOL[family(op)] if tol is None else tol
    try:
        want = run_ref(op, ins, attrs)
    except Exception as e:                  # noqa: BLE001
        with pytest.raises(type(e)):
            run_port(op, ins, attrs)
        return None
    got = run_port(op, ins, attrs)
    assert set(got) >= set(want), (tag, set(got), set(want))
    for slot, vals in want.items():
        assert len(got[slot]) == len(vals), (tag, slot)
        for i, w in enumerate(vals):
            compare(f"{tag}:{slot}[{i}]", got[slot][i], w, tol)
    return got


def vjp_both(op, ins, attrs, rng, tol=GRAD_TOL):
    """d(sum of each float output * a seeded cotangent)/d(each float
    input of a differentiable slot): the reference by jax.vjp of its
    lowering, the port by its ``__vjp_grad__`` op."""
    nd = set(jax_registry.get(op).non_diff_inputs)
    slots = [s for s, vs in ins.items() if s not in nd and vs
             and np.issubdtype(np.asarray(vs[0]).dtype, np.floating)]
    fwd = jax_registry.get(op).forward

    def f(*vals):
        full = {k: [None if v is None else _jax_in(v) for v in vs]
                for k, vs in ins.items() if k not in slots}
        for s, v in zip(slots, vals):
            full[s] = list(v)
        out = jax_registry.normalize_outputs(fwd(full, dict(attrs)))
        return {k: v for k, v in out.items()
                if all(jnp.issubdtype(x.dtype, jnp.floating) for x in v)}

    primals = [tuple(_jax_in(v) for v in ins[s]) for s in slots]
    out, pull = jax.vjp(f, *primals)
    cts = {k: [np.asarray(rng.randn(*np.shape(x)), np.float32) for x in v]
           for k, v in out.items()}
    want = pull({k: [jnp.asarray(c) for c in v] for k, v in cts.items()})
    pins = {f"In__{s}": [None if v is None else as_tensor(v) for v in vs]
            for s, vs in ins.items()}
    for k, v in cts.items():
        pins[f"OG__{k}"] = [torch.from_numpy(c) for c in v]
    got = pt_registry.get("__vjp_grad__").forward(
        pins, {"fwd_type": op, "fwd_attrs": dict(attrs)})
    for s, w in zip(slots, want):
        for i, wi in enumerate(w):
            compare(f"{op}:d{s}[{i}]", got[f"IG__{s}"][i], wi, tol)


# -- the registry --------------------------------------------------------------

def test_every_op_type_of_linalg_and_extra_ops_is_registered():
    """The reference's 34 linalg_ops op types (bilinear_tensor_product
    came with the 2.0 API) and the 30 extra_ops ones the port lacked:
    312 op types in all, none of them one the reference lacks."""
    lin = set(ref_ops("linalg_ops")) - {"bilinear_tensor_product"}
    assert lin == set(LINALG_OPS) and len(lin) == 34
    extra = set(ref_ops("extra_ops"))
    assert set(EXTRA_OPS) <= extra and len(EXTRA_OPS) == 30
    assert [op for op in ref_ops("linalg_ops") + ref_ops("extra_ops")
            if pt_registry.lookup(op) is None] == []
    ours = set(pt_registry.registered_ops())
    assert len(ours) == 248 + 64
    assert ours <= set(jax_registry._REGISTRY)
    # the host-read refusals are the reference's own; every new op is
    # capturable, and every one but inverse (inv_ex cannot be captured on
    # CUDA) is captured into a compiled step's CUDA graph
    for op in LINALG_OPS + EXTRA_OPS:
        od = pt_registry.get(op)
        assert od.capturable, op
        assert bool(od.decides_on_host) == (op == "inverse"), op


def test_every_linalg_op_has_a_case():
    covered = {c.split("[")[0] for c in CASES}
    assert set(LINALG_OPS) <= covered


LINALG_CASES = sorted(c for c in CASES if c.split("[")[0] in LINALG_OPS)


@pytest.mark.parametrize("case", LINALG_CASES)
def test_linalg_op_matches_the_reference(case):
    op = case.split("[")[0]
    ins, attrs = CASES[case](_rng(case))
    check_op(op, ins, attrs, case)


# -- the reference's case tables, unedited -------------------------------------

REF_TABLES = ("TestAddmm", "TestCross", "TestMv", "TestTrace",
              "TestInverse", "TestCholesky", "TestLogsumexp",
              "TestFrobeniusNorm", "TestMultiplex", "TestReverse",
              "TestShardIndex")


def _table_inputs(t):
    ins = {}
    for slot, v in t.inputs.items():
        if isinstance(v, list):
            ins[slot] = [a for _, a in v]
        else:
            ins[slot] = [v]
    return ins


@pytest.mark.parametrize("name", REF_TABLES)
def test_reference_case_table(name):
    """Each OpTest case of ``tests/test_ops_batch2.py``: both lowerings
    agree, and the port matches the table's numpy outputs."""
    t = getattr(ref_b2, name)()
    t.setup()
    ins, attrs = _table_inputs(t), dict(getattr(t, "attrs", {}) or {})
    got = check_op(t.op_type, ins, attrs, name)
    for slot, want in t.outputs.items():
        g = got[slot][0].numpy()
        want = np.asarray(want)
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(g, want)
        else:
            np.testing.assert_allclose(g, want, rtol=1e-4, atol=1e-4)


class _PortTensors:
    """jnp arrays of a reference test to torch tensors, with the dtype
    rule of ``as_tensor``."""

    @staticmethod
    def lists(ins):
        return {k: [as_tensor(np.asarray(v)) for v in vs]
                for k, vs in ins.items()}


class TestPortOpsBatch3(ref_b2.TestOpsBatch3):
    """The reference's TestOpsBatch3 (mode, kthvalue, median,
    searchsorted, bincount, scatter_nd, diag_v2, size, lgamma, frac,
    bilinear_tensor_product) run on the port's lowerings."""

    def _run(self, name, ins, attrs={}):
        return pt_registry.lookup(name).forward(_PortTensors.lists(ins),
                                                dict(attrs))


# -- the rows where a plain torch call is wrong --------------------------------

def _port(op, ins, attrs=None):
    return run_port(op, ins, attrs or {})


def test_digamma_is_nan_at_zero_and_minus_inf():
    x = np.array([0.0, -0.0, -np.inf], np.float32)
    got = _port("digamma", {"X": [x]})["Out"][0]
    assert torch.isnan(got).all()
    plain = torch.digamma(torch.from_numpy(x))
    assert plain[0] == -np.inf and plain[1] == np.inf


def test_l1_norm_gradient_at_zero_is_one_as_jax_abs():
    x = np.array([0.0, -0.0, 2.0, -3.0], np.float32)
    vjp_both("l1_norm", {"X": [x]}, {}, np.random.RandomState(3))
    got = pt_registry.get("__vjp_grad__").forward(
        {"In__X": [torch.from_numpy(x)], "OG__Out": [torch.ones(())]},
        {"fwd_type": "l1_norm", "fwd_attrs": {}})["IG__X"][0]
    assert got.tolist() == [1.0, 1.0, 1.0, -1.0]
    t = torch.from_numpy(x).requires_grad_()
    torch.abs(t).sum().backward()
    assert t.grad[0] == 0.0


def test_cholesky_of_a_non_pd_member_fills_nan_without_raising():
    x = np.stack([np.eye(3, dtype=np.float32) * 4,
                  -np.eye(3, dtype=np.float32)])
    got = _port("cholesky", {"X": [x]})["Out"][0]
    assert torch.equal(got[0], torch.eye(3) * 2)
    low = torch.ones(3, 3, dtype=torch.bool).tril()
    assert torch.isnan(got[1][low]).all() and (got[1][~low] == 0).all()
    with pytest.raises(Exception):
        torch.linalg.cholesky(torch.from_numpy(x))


def test_inverse_of_a_singular_matrix_gives_infinities():
    x = np.array([[1, 2], [2, 4]], np.float32)
    check_op("inverse", {"Input": [x]}, {})
    got = _port("inverse", {"Input": [x]})["Output"][0]
    assert not torch.isfinite(got).all()
    with pytest.raises(Exception):
        torch.linalg.inv(torch.from_numpy(x))


def test_median_of_an_even_count_is_the_mean_of_the_middle_two():
    got = _port("median", {"X": [np.array([1, 4, 3, 2], np.float32)]})
    assert float(got["Out"][0]) == 2.5
    assert float(torch.median(torch.tensor([1.0, 4, 3, 2]))) == 2.0


def test_mode_takes_the_smallest_tie_and_its_first_index():
    x = np.array([3, 1, 3, 1, 2], np.float32)
    got = _port("mode", {"X": [x]})
    assert float(got["Out"][0]) == 1.0
    assert got["Indices"][0].dtype == torch.int32
    assert int(got["Indices"][0]) == 1


def test_bincount_drops_past_minlength_and_counts_negatives_in_bin_0():
    x = np.array([-3, 0, 1, 1, 7, 2], np.int32)
    got = _port("bincount", {"X": [x]}, {"minlength": 4})["Out"][0]
    assert got.dtype == torch.int32 and got.tolist() == [2, 2, 1, 0]
    with pytest.raises(ValueError):
        _port("bincount", {"X": [x]})
    with pytest.raises(RuntimeError):
        torch.bincount(torch.from_numpy(x), minlength=4)


def test_histogram_drops_nan_and_out_of_range_and_widens_equal_bounds():
    x = np.array([np.nan, -5, 0.6, 1.0, 1.4, 2.0, 9], np.float32)
    got = _port("histogram", {"X": [x]},
                {"bins": 3, "min": 1.0, "max": 1.0})["Out"][0]
    assert got.dtype == torch.int32 and got.tolist() == [1, 1, 1]
    data = check_op("histogram", {"X": [x[1:]]}, {"bins": 2})["Out"][0]
    assert data.tolist() == [4, 2]


def test_scatter_nd_drops_out_of_range_rows_and_sums_repeats_in_order():
    idx = np.array([[1], [1], [5], [-1], [0]], np.int32)
    upd = np.arange(5, dtype=np.float32) + 1
    got = _port("scatter_nd", {"Index": [idx], "Updates": [upd]},
                {"shape": [4]})["Out"][0]
    assert got.tolist() == [5.0, 3.0, 0.0, 4.0]
    out = torch.zeros(4)
    with pytest.raises(IndexError):
        out.index_put_((torch.from_numpy(idx[:, 0]).long(),),
                       torch.from_numpy(upd), accumulate=True)


def test_multiplex_wraps_negative_ids_and_clamps_large_ones():
    a, b = np.zeros((2, 3), np.float32), np.ones((2, 3), np.float32)
    ids = np.array([[3], [-1]], np.int32)
    got = _port("multiplex", {"X": [a, b], "Ids": [ids]})["Out"][0]
    assert (got == 1).all()
    with pytest.raises(IndexError):
        torch.stack([torch.from_numpy(a), torch.from_numpy(b)])[
            torch.tensor([3, -1]), torch.arange(2)]


def test_index_outputs_are_int32():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    for op, ins, attrs, slot in (
            ("size", {"Input": [x]}, {}, "Out"),
            ("rank", {"Input": [x]}, {}, "Out"),
            ("histogram", {"X": [x]}, {"bins": 3}, "Out"),
            ("searchsorted", {"SortedSequence": [x[0]], "Values": [x]}, {},
             "Out"),
            ("kthvalue", {"X": [x]}, {"k": 2}, "Indices"),
            ("mode", {"X": [x]}, {}, "Indices")):
        assert _port(op, ins, attrs)[slot][0].dtype == torch.int32, op
    assert torch.searchsorted(torch.tensor([1.0]),
                              torch.tensor([2.0])).dtype == torch.int64


# -- gradients -----------------------------------------------------------------

def _u(r, shape, lo=-1.0, hi=1.0):
    return (r.rand(*shape) * (hi - lo) + lo).astype(np.float32)


def _spd(r, b, n):
    a = r.randn(b, n, n)
    return (a @ a.transpose(0, 2, 1) / n + np.eye(n)).astype(np.float32)


GRAD_CASES = {
    "addmm": lambda r: ({"Input": [_u(r, (2, 4))], "X": [_u(r, (2, 3))],
                         "Y": [_u(r, (3, 4))]}, {"Alpha": 0.5,
                                                 "Beta": 2.0}),
    "cross": lambda r: ({"X": [_u(r, (3, 4))], "Y": [_u(r, (3, 4))]},
                        {"dim": 0}),
    "mv": lambda r: ({"X": [_u(r, (3, 4))], "Vec": [_u(r, (4,))]}, {}),
    "trace": lambda r: ({"Input": [_u(r, (2, 3, 4))]},
                        {"offset": 1, "axis1": 1, "axis2": 2}),
    "inverse": lambda r: ({"Input": [_spd(r, 2, 3)]}, {}),
    "cholesky": lambda r: ({"X": [_spd(r, 2, 3)]}, {}),
    "cholesky[upper_asymmetric]": lambda r: (
        {"X": [_spd(r, 2, 3) + np.triu(_u(r, (3, 3)), 1)]},
        {"upper": True}),
    "logsumexp": lambda r: ({"X": [_u(r, (3, 4), -3, 3)]},
                            {"axis": [1], "keepdim": True}),
    "logsumexp[all_minus_inf_row]": lambda r: (
        {"X": [np.array([[-np.inf] * 3, [1, 2, 3]], np.float32)]},
        {"axis": [1]}),
    "frobenius_norm": lambda r: ({"X": [_u(r, (2, 3))]}, {"dim": [1]}),
    "frobenius_norm[zeros]": lambda r: (
        {"X": [np.zeros((2, 3), np.float32)]}, {}),
    "l1_norm": lambda r: ({"X": [_u(r, (3, 4))]}, {}),
    "l1_norm[zeros]": lambda r: (
        {"X": [np.array([0.0, -0.0, 1.5, -2.0], np.float32)]}, {}),
    "multiplex": lambda r: ({"X": [_u(r, (3, 2)), _u(r, (3, 2))],
                             "Ids": [np.array([[3], [-1], [-5]],
                                              np.int32)]}, {}),
    "minus": lambda r: ({"X": [_u(r, (3, 2))], "Y": [_u(r, (3, 2))]}, {}),
    "expand_as": lambda r: ({"X": [_u(r, (1, 2))],
                             "target_tensor": [_u(r, (3, 4))]}, {}),
    "pad_constant_like": lambda r: ({"X": [_u(r, (3, 4))],
                                     "Y": [_u(r, (2, 3))]},
                                    {"pad_value": 0.5}),
    "reverse": lambda r: ({"X": [_u(r, (3, 4))]}, {"axis": [0, 1]}),
    "scatter_nd": lambda r: (
        {"Index": [np.array([[1], [1], [5], [-1], [0]], np.int32)],
         "Updates": [_u(r, (5, 3))]}, {"shape": [4, 3]}),
    "diag": lambda r: ({"Diagonal": [_u(r, (3,))]}, {}),
    "diag_v2": lambda r: ({"X": [_u(r, (3,))]},
                          {"offset": -1, "padding_value": 2.0}),
    "diag_v2[matrix]": lambda r: ({"X": [_u(r, (3, 4))]}, {"offset": 1}),
    "cumprod[zeros]": lambda r: (
        {"X": [np.array([[1.5, 0, 2, 3], [0, 0, 2, -1]], np.float32)]},
        {"dim": 1}),
    "cumprod": lambda r: ({"X": [_u(r, (3, 4))]}, {"dim": 0}),
    "lgamma": lambda r: ({"X": [_u(r, (3, 4), 0.2, 3)]}, {}),
    "digamma": lambda r: ({"X": [_u(r, (3, 4), 0.2, 3)]}, {}),
    "frac": lambda r: ({"X": [_u(r, (3, 4), -3, 3)]}, {}),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_linalg_gradient_matches_jax_vjp(case):
    op = case.split("[")[0]
    r = _rng(case)
    ins, attrs = GRAD_CASES[case](r)
    vjp_both(op, ins, attrs, r)
