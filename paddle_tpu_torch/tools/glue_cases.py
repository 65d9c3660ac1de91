"""Seeded cases for the math, tensor, sequence, beam-search, RNN, CRF,
fused-RNN and tensor-array ops: for each op type, inputs and attrs that
reach its edges (NaN, +-0, +-inf, integer division by zero and INT_MIN /
-1, negative and out-of-range indices, ties, duplicate scatter ids, empty
sequences, rows past the last offset; for the CRF a tie in Viterbi, a
length of 0, a length equal to S, S = 1 and bf16 emissions; for the 2.0
API's op types ties at their thresholds, every padding mode, empty and
full selections) beside the
shapes and ranges of the reference's sweep tables. The CPU tests run them through both packages; on the card,
chip_smoke's ``ops_glue_card`` runs each through the port on the card and
on the CPU.

``CASES`` maps "op[variant]" to a function of a ``numpy.random.RandomState``
giving (inputs {slot: [array or None, ...]}, attrs); an input wrapped in
``BF16`` is a float32 array of bf16 values that goes in as bfloat16
(``as_tensor``). ``rng(name)`` is the state a case is drawn from. ``family(op)`` names an op's family and
``CARD_TOL`` the float tolerance of each family on the card against the
CPU (the card's transcendental functions round 1-2 ulp from the CPU's,
its sums and products accumulate in another order)."""

from __future__ import annotations

import numpy as np

NAN, INF = float("nan"), float("inf")
EDGE = np.array([NAN, -INF, INF, -0.0, 0.0, 0.5, -0.5, 1.5, -2.5, 3.0,
                 1e-30, -1e30], np.float32)
I32_MIN, I32_MAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max


CARD_TOL = {"elementwise": 1e-5, "activation": 1e-5, "reduction": 1e-4,
            "matmul": 1e-4, "loss": 1e-5, "tensor": 1e-6, "sequence": 1e-5,
            "rnn": 1e-4, "beam": 1e-5, "crf": 1e-4, "fused_rnn": 1e-4,
            "array": 0.0, "norm": 1e-4, "optimizer": 1e-5}
_CRF = ("linear_chain_crf", "crf_decoding", "ctc_align", "edit_distance")
_FUSED_RNN = ("fusion_lstm", "fusion_gru", "attention_lstm",
              "fusion_seqconv_eltadd_relu", "fusion_seqexpand_concat_fc")
_ARRAY = ("array_read", "array_write", "lod_rank_table", "split_lod_tensor",
          "merge_lod_tensor", "shrink_rnn_memory", "lod_tensor_to_array",
          "array_to_lod_tensor")
_LOSSES = ("sigmoid_cross_entropy_with_logits", "huber_loss",
           "square_error_cost", "smooth_l1_loss", "kldiv_loss", "bce_loss",
           "margin_rank_loss", "hierarchical_sigmoid", "warpctc")
_NORMS = ("instance_norm", "group_norm", "sync_batch_norm", "lrn")
_OPTIMIZERS = ("adagrad", "adamax", "adadelta", "rmsprop",
               "decayed_adagrad", "ftrl")
_TENSOR = ("share_data", "reshape", "transpose", "split", "stack", "unstack",
           "flatten2", "flatten_contiguous_range", "strided_slice",
           "gather_nd", "scatter", "shape", "fill_zeros_like",
           "fill_any_like", "expand", "expand_v2", "tile", "range", "where",
           "pad", "tril_triu", "fill_constant_batch_size_like", "eye",
           "flip", "roll", "index_select", "masked_select", "pixel_shuffle",
           "pad2d", "broadcast_to")


def family(op):
    """The family of an op type, the key of its float tolerance."""
    if op in _CRF:
        return "crf"
    if op in _FUSED_RNN:
        return "fused_rnn"
    if op in _ARRAY:
        return "array"
    if op.startswith("sequence_"):
        return "sequence"
    if op in ("lstm", "gru", "gru_unit", "lstm_unit"):
        return "rnn"
    if op in _NORMS:
        return "norm"
    if op in _OPTIMIZERS:
        return "optimizer"
    if op in ("beam_search", "gather_tree", "beam_search_decode"):
        return "beam"
    if op.startswith("reduce_") or op in ("squared_l2_norm", "p_norm",
                                          "cumsum"):
        return "reduction"
    if op in ("bmm", "dot", "bilinear_tensor_product", "conv2d_transpose",
              "interpolate"):
        return "matmul"
    if op in _LOSSES:
        return "loss"
    if op.startswith("elementwise_") or op in ("maximum", "minimum",
                                                "linspace"):
        return "elementwise"
    if op in _TENSOR:
        return "tensor"
    return "activation"


def rng(name):
    return np.random.RandomState(sum(map(ord, name)) % (2 ** 31))


class BF16:
    """A case input that goes in as bfloat16: ``values`` is float32 and
    holds bf16 values exactly (its low 16 bits are 0)."""

    def __init__(self, values):
        bits = np.asarray(values, np.float32).view(np.uint32)
        self.values = (bits & np.uint32(0xFFFF0000)).view(np.float32)


def as_tensor(v):
    """A case input as the op gets it: int64 as int32 and float64 as
    float32 (64-bit types are off in the reference), a ``BF16`` as a
    bfloat16 tensor."""
    import torch

    if isinstance(v, BF16):
        return torch.from_numpy(v.values.copy()).to(torch.bfloat16)
    a = np.array(v, copy=True)
    if a.dtype == np.int64:
        a = a.astype(np.int32)
    elif a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(a)


def _u(r, shape, lo=-1.0, hi=1.0):
    return (r.rand(*shape) * (hi - lo) + lo).astype(np.float32)


def _ties(r, shape, levels=4):
    return r.randint(0, levels, shape).astype(np.float32) * 0.5


# case name "op[variant]" -> rng -> (ins, attrs)
CASES = {}

# the reference sweep's ranges of these unary ops
# (tests/test_op_registry_sweep.py UNARY)
SWEEP_UNARY = {
    "floor": ({}, (-3.0, 3.0)), "reciprocal": ({}, (0.5, 2.0)),
    "rsqrt": ({}, (0.5, 2.0)), "logsigmoid": ({}, (-3.0, 3.0)),
    "silu": ({}, (-3.0, 3.0)), "softsign": ({}, (-3.0, 3.0)),
    "softplus": ({}, (-3.0, 3.0)), "relu6": ({}, (-3.0, 8.0)),
    "elu": ({"alpha": 1.0}, (-3.0, 3.0)),
    "hard_sigmoid": ({"slope": 0.2, "offset": 0.5}, (-4.0, 4.0)),
    "hard_swish": ({"threshold": 6.0, "scale": 6.0, "offset": 3.0},
                   (-5.0, 5.0)),
    "swish": ({"beta": 1.0}, (-3.0, 3.0)),
    "isfinite_v2": ({}, (-2.0, 2.0)), "logical_not": ({}, (-1.0, 1.0)),
    "log_softmax": ({"axis": -1}, (-2.0, 2.0)),
}
for _op, (_attrs, (_lo, _hi)) in SWEEP_UNARY.items():
    CASES[f"{_op}[sweep]"] = (lambda r, a=_attrs, lo=_lo, hi=_hi: (
        {"X": [_u(r, (3, 4), lo, hi)]}, dict(a)))

_UNARY_OURS = ("relu6", "exp", "log", "log2", "rsqrt", "abs", "floor",
               "ceil", "round", "reciprocal", "softsign", "silu", "swish",
               "cos", "erf", "logsigmoid", "softplus", "leaky_relu", "elu",
               "hard_sigmoid", "hard_swish", "isfinite_v2", "logical_not",
               "log_softmax")
for _op in _UNARY_OURS:
    CASES[f"{_op}[edge]"] = lambda r: ({"X": [EDGE.reshape(3, 4)]}, {})
    CASES[f"{_op}[range]"] = lambda r: ({"X": [_u(r, (4, 5), -6, 6)]}, {})

CASES.update({
    "round[halves]": lambda r: (
        {"X": [np.array([0.5, 1.5, 2.5, -0.5, -1.5, 2.4999998],
                        np.float32)]}, {}),
    "abs[int32]": lambda r: (
        {"X": [np.array([-3, 0, 7, I32_MIN + 1], np.int32)]}, {}),
    "floor[int32]": lambda r: ({"X": [np.array([-3, 0, 7], np.int32)]}, {}),
    "softplus[beta]": lambda r: (
        {"X": [_u(r, (3, 4), -30, 30)]}, {"beta": 2.0, "threshold": 10.0}),
    "leaky_relu[alpha]": lambda r: (
        {"X": [_u(r, (3, 4), -3, 3)]}, {"alpha": 0.1}),
    "elu[alpha]": lambda r: ({"X": [_u(r, (3, 4), -3, 3)]}, {"alpha": 0.7}),
    "hard_swish[attrs]": lambda r: (
        {"X": [_u(r, (3, 4), -6, 6)]},
        {"threshold": 5.0, "scale": 4.0, "offset": 2.0}),
    "swish[beta_ignored]": lambda r: (
        {"X": [_u(r, (3, 4), -3, 3)]}, {"beta": 3.0}),
    "log_softmax[axis0]": lambda r: (
        {"X": [_u(r, (5, 3), -4, 4)]}, {"axis": 0}),
    "logical_not[bool]": lambda r: ({"X": [r.rand(3, 4) > 0.5]}, {}),
    "pow[float]": lambda r: ({"X": [_u(r, (3, 4), 0.5, 2.0)]},
                             {"factor": 2.5}),
    "pow[edge]": lambda r: ({"X": [EDGE.reshape(3, 4)]}, {"factor": 3.0}),
    "pow[int_base_float_factor]": lambda r: (
        {"X": [np.array([-2, 0, 3, 5], np.int32)]}, {"factor": 2.0}),
    "pow[int_base_int_factor]": lambda r: (
        {"X": [np.array([-2, 0, 3, 5], np.int32)]}, {"factor": 3}),
    "isfinite_v2[int]": lambda r: ({"X": [np.array([1, -2], np.int32)]}, {}),
})

BINARY_OPS = ("elementwise_sub", "elementwise_min", "elementwise_pow",
              "minimum", "maximum", "greater_equal", "less_equal",
              "not_equal", "logical_and", "logical_or", "logical_xor",
              "elementwise_mod", "elementwise_floordiv", "equal",
              "less_than", "greater_than")
for _op in BINARY_OPS:
    CASES[f"{_op}[sweep]"] = lambda r: (
        {"X": [_u(r, (3, 4), 0.5, 2.0)], "Y": [_u(r, (3, 4), 0.5, 2.0)]}, {})
    CASES[f"{_op}[edge]"] = lambda r: (
        {"X": [np.repeat(EDGE, 12)], "Y": [np.tile(EDGE, 12)]}, {})
    CASES[f"{_op}[ties]"] = lambda r: (
        {"X": [_ties(r, (4, 6))], "Y": [_ties(r, (4, 6))]}, {})
    CASES[f"{_op}[int32]"] = lambda r: (
        {"X": [np.array([7, -7, 5, -5, 0, 3, I32_MAX, I32_MIN, I32_MIN, -9,
                         2, -3], np.int32)],
         "Y": [np.array([3, 3, -2, -2, 0, 0, 0, -1, 0, 4, -1, 1],
                        np.int32)]}, {})
    CASES[f"{_op}[mixed_sign_f]"] = lambda r: (
        {"X": [_u(r, (4, 5), -9, 9)], "Y": [_u(r, (4, 5), -3, 3)]}, {})
for _op in ("elementwise_sub", "elementwise_min", "elementwise_pow",
            "elementwise_mod", "elementwise_floordiv"):
    CASES[f"{_op}[axis1]"] = lambda r: (
        {"X": [_u(r, (2, 3, 4), 0.5, 2.0)], "Y": [_u(r, (3,), 0.5, 2.0)]},
        {"axis": 1})
    CASES[f"{_op}[trailing]"] = lambda r: (
        {"X": [_u(r, (2, 3, 4), 0.5, 2.0)], "Y": [_u(r, (4,), 0.5, 2.0)]},
        {"axis": -1})
CASES.update({
    "elementwise_pow[int_negative_exp]": lambda r: (
        {"X": [np.array([2, 2, -2, 0, 1, -1, 3, 3, 2, 7], np.int32)],
         "Y": [np.array([3, -1, -2, -1, -5, -3, 0, 40, 31, 64], np.int32)]},
        {}),
    "elementwise_pow[float_int]": lambda r: (
        {"X": [_u(r, (3, 4), 0.5, 2.0)],
         "Y": [r.randint(-3, 4, (3, 4)).astype(np.int32)]}, {}),
    "elementwise_mod[inf_divisor]": lambda r: (
        {"X": [np.array([1.0, -1.0, 1e30, -0.0], np.float32)],
         "Y": [np.array([INF, INF, 3e-10, 2.0], np.float32)]}, {}),
    "less_than[axis_ignored]": lambda r: (
        {"X": [_u(r, (2, 3), -1, 1)], "Y": [_u(r, (3,), -1, 1)]},
        {"axis": 0}),
    "not_equal[int_float]": lambda r: (
        {"X": [np.array([1, 2, 3], np.int32)],
         "Y": [np.array([1.0, 2.5, 3.0], np.float32)]}, {}),
    "logical_and[bool]": lambda r: (
        {"X": [r.rand(3, 4) > 0.5], "Y": [r.rand(4) > 0.5]}, {}),
    "logical_xor[float_nan]": lambda r: (
        {"X": [EDGE], "Y": [EDGE[::-1].copy()]}, {}),
})

_REDUCE = ("reduce_max", "reduce_min", "reduce_prod", "reduce_any",
           "reduce_all")
for _op in _REDUCE:
    CASES[f"{_op}[dim1]"] = lambda r: ({"X": [_u(r, (3, 4))]}, {"dim": [1]})
    CASES[f"{_op}[all]"] = lambda r: ({"X": [_u(r, (3, 4))]},
                                      {"reduce_all": True})
    CASES[f"{_op}[no_dim_keep]"] = lambda r: ({"X": [_u(r, (2, 3, 4))]},
                                              {"keep_dim": True})
    CASES[f"{_op}[dims02_keep]"] = lambda r: (
        {"X": [_u(r, (2, 3, 4))]}, {"dim": [0, 2], "keep_dim": True})
    CASES[f"{_op}[negative_dim]"] = lambda r: (
        {"X": [_u(r, (2, 3, 4))]}, {"dim": [-1]})
    CASES[f"{_op}[empty_dim]"] = lambda r: ({"X": [_u(r, (3, 4))]},
                                            {"dim": []})
    CASES[f"{_op}[nan]"] = lambda r: ({"X": [EDGE.reshape(3, 4)]},
                                      {"dim": [0]})
    CASES[f"{_op}[int32]"] = lambda r: (
        {"X": [r.randint(-5, 6, (3, 4)).astype(np.int32)]}, {"dim": [1]})
    CASES[f"{_op}[bool]"] = lambda r: ({"X": [r.rand(3, 4) > 0.3]},
                                       {"dim": [0]})
CASES.update({
    "reduce_prod[empty_axis]": lambda r: (
        {"X": [np.zeros((0, 3), np.float32)]}, {"dim": [0]}),
    "reduce_max[empty_axis]": lambda r: (
        {"X": [np.zeros((0, 3), np.float32)]}, {"dim": [0]}),
    "squared_l2_norm[edge]": lambda r: ({"X": [EDGE]}, {}),
    "p_norm[axis_none_2d]": lambda r: ({"X": [_u(r, (3, 4))]},
                                       {"porder": 2.0}),
    "p_norm[axis_none_1d]": lambda r: ({"X": [_u(r, (7,))]},
                                       {"porder": 2.0}),
    "p_norm[p1_keep]": lambda r: ({"X": [_u(r, (3, 4))]},
                                  {"porder": 1.0, "axis": 0,
                                   "keepdim": True}),
    "p_norm[p3]": lambda r: ({"X": [_u(r, (3, 4))]},
                             {"porder": 3.0, "axis": -1}),
    "p_norm[inf]": lambda r: ({"X": [_u(r, (3, 4))]},
                              {"porder": INF, "axis": 1}),
    "bmm[sweep]": lambda r: ({"X": [_u(r, (2, 3, 4))],
                              "Y": [_u(r, (2, 4, 5))]}, {}),
    "dot[vec]": lambda r: ({"X": [_u(r, (5,))], "Y": [_u(r, (5,))]}, {}),
    "dot[rows]": lambda r: ({"X": [_u(r, (3, 5))], "Y": [_u(r, (3, 5))]},
                            {}),
    "sigmoid_cross_entropy_with_logits[sweep]": lambda r: (
        {"X": [_u(r, (4, 3), -30, 30)],
         "Label": [(r.rand(4, 3) > 0.5).astype(np.float32)]}, {}),
    "huber_loss[sweep]": lambda r: (
        {"X": [_u(r, (4, 2))], "Y": [_u(r, (4, 2))]}, {"delta": 0.5}),
    "huber_loss[default]": lambda r: (
        {"X": [_u(r, (4, 2), -3, 3)], "Y": [_u(r, (4, 2), -3, 3)]}, {}),
    "square_error_cost[sweep]": lambda r: (
        {"Input": [_u(r, (4, 2))], "Label": [_u(r, (4, 2))]}, {}),
    "smooth_l1_loss[sigma1]": lambda r: (
        {"X": [_u(r, (4, 3), -2, 2)], "Y": [_u(r, (4, 3), -2, 2)]},
        {"sigma": 1.0}),
    "smooth_l1_loss[sigma3]": lambda r: (
        {"X": [_u(r, (4, 3), -2, 2)], "Y": [_u(r, (4, 3), -2, 2)]},
        {"sigma": 3.0}),
})
for _red in ("none", "mean", "sum", "batchmean"):
    CASES[f"kldiv_loss[{_red}]"] = lambda r, red=_red: (
        {"X": [_u(r, (4, 3))],
         "Target": [np.array([[0.2, 0.0, -0.3]] * 4, np.float32)
                    + _u(r, (4, 3), 0, 0.5)]}, {"reduction": red})

_SORT_INPUTS = {
    "sweep": lambda r: _u(r, (3, 5)),
    "ties": lambda r: _ties(r, (4, 7)),
    "edge": lambda r: np.stack([EDGE, EDGE[::-1], np.roll(EDGE, 5)]),
    "zeros": lambda r: np.array([[0.0, -0.0, 0.0, -0.0, 1.0]], np.float32),
}
for _v, _mk in _SORT_INPUTS.items():
    CASES[f"top_k_v2[{_v}]"] = lambda r, mk=_mk: ({"X": [mk(r)]}, {"k": 3})
    CASES[f"arg_max[{_v}]"] = lambda r, mk=_mk: ({"X": [mk(r)]},
                                                 {"axis": 1})
    CASES[f"arg_min[{_v}]"] = lambda r, mk=_mk: ({"X": [mk(r)]},
                                                 {"axis": 0})
    CASES[f"argsort[{_v}]"] = lambda r, mk=_mk: ({"X": [mk(r)]},
                                                 {"axis": -1})
    CASES[f"argsort[{_v},desc]"] = lambda r, mk=_mk: (
        {"X": [mk(r)]}, {"axis": -1, "descending": True})
    CASES[f"argsort[{_v},axis0]"] = lambda r, mk=_mk: (
        {"X": [mk(r)]}, {"axis": 0, "descending": True})
CASES.update({
    "arg_max[keepdims]": lambda r: ({"X": [_u(r, (3, 4))]},
                                    {"axis": 0, "keepdims": True}),
    "arg_max[bool]": lambda r: ({"X": [r.rand(3, 4) > 0.5]}, {"axis": 1}),
    "arg_min[int32]": lambda r: (
        {"X": [r.randint(-2, 2, (3, 6)).astype(np.int32)]}, {"axis": 1}),
    "argsort[int32]": lambda r: (
        {"X": [r.randint(-2, 2, (3, 6)).astype(np.int32)]}, {"axis": 1}),
})


CASES.update({
    "share_data[int]": lambda r: (
        {"X": [np.arange(6, dtype=np.int32).reshape(2, 3)]}, {}),
    "reshape[zero_and_infer]": lambda r: (
        {"X": [_u(r, (2, 3, 4))]}, {"shape": [0, -1, 2]}),
    "transpose[perm]": lambda r: ({"X": [_u(r, (2, 3, 4))]},
                                  {"axis": [1, 2, 0]}),
    "split[sections]": lambda r: ({"X": [_u(r, (3, 10))]},
                                  {"axis": 1, "sections": [2, 3, 5]}),
    "split[num]": lambda r: ({"X": [_u(r, (4, 6))]}, {"axis": 0, "num": 2}),
    "split[num_uneven]": lambda r: ({"X": [_u(r, (5, 6))]},
                                    {"axis": 0, "num": 2}),
    "split[minus_one]": lambda r: ({"X": [_u(r, (3, 10))]},
                                   {"axis": 1, "sections": [3, -1, 2]}),
    "split[negative_axis]": lambda r: ({"X": [_u(r, (3, 6))]},
                                       {"axis": -1, "sections": [1, 5]}),
    "stack[axis1]": lambda r: ({"X": [_u(r, (2, 3)), _u(r, (2, 3)),
                                      _u(r, (2, 3))]}, {"axis": 1}),
    "stack[int]": lambda r: ({"X": [np.arange(3, dtype=np.int32)] * 2},
                             {"axis": 0}),
    "unstack[axis1]": lambda r: ({"X": [_u(r, (2, 3, 4))]}, {"axis": 1}),
    "flatten2[axis0]": lambda r: ({"X": [_u(r, (2, 3, 4))]}, {"axis": 0}),
    "flatten_contiguous_range[neg]": lambda r: (
        {"X": [_u(r, (2, 3, 4, 5))]}, {"start_axis": 1, "stop_axis": -2}),
    "strided_slice[negative_strides]": lambda r: (
        {"Input": [np.arange(12, dtype=np.float32).reshape(3, 4)]},
        {"axes": [0, 1], "starts": [5, -1], "ends": [-10, 0],
         "strides": [-1, -2]}),
    "strided_slice[clamped]": lambda r: (
        {"Input": [_u(r, (4, 7))]},
        {"axes": [1], "starts": [-100], "ends": [100], "strides": [3]}),
    "strided_slice[empty]": lambda r: (
        {"Input": [_u(r, (4, 7))]},
        {"axes": [1], "starts": [5], "ends": [2], "strides": [1]}),
    "strided_slice[neg_empty]": lambda r: (
        {"Input": [_u(r, (4, 7))]},
        {"axes": [1], "starts": [1], "ends": [5], "strides": [-2]}),
    "strided_slice[neg_to_start]": lambda r: (
        {"Input": [_u(r, (4, 7))]},
        {"axes": [0, 1], "starts": [-1, 6], "ends": [-5, -8],
         "strides": [-3, -1]}),
    "gather_nd[negative_oob]": lambda r: (
        {"X": [np.arange(12, dtype=np.float32).reshape(3, 4)],
         "Index": [np.array([[-1, -5], [3, 9], [-4, 0]], np.int32)]}, {}),
    "gather_nd[partial]": lambda r: (
        {"X": [_u(r, (3, 4, 2))],
         "Index": [np.array([[[2], [-1]], [[0], [7]]], np.int64)]}, {}),
    "gather_nd[int]": lambda r: (
        {"X": [np.arange(24, dtype=np.int32).reshape(2, 3, 4)],
         "Index": [np.array([[1, 2, 3], [0, -1, -1]], np.int32)]}, {}),
    "scatter[dup_overwrite]": lambda r: (
        {"X": [np.arange(12, dtype=np.float32).reshape(3, 4)],
         "Ids": [np.array([1, 1, -1, 5, -4], np.int32)],
         "Updates": [np.arange(20, dtype=np.float32).reshape(5, 4) + 100]},
        {}),
    "scatter[dup_add]": lambda r: (
        {"X": [np.arange(12, dtype=np.float32).reshape(3, 4)],
         "Ids": [np.array([1, 1, -1, 5, -4, 0], np.int32)],
         "Updates": [_u(r, (6, 4))]}, {"overwrite": False}),
    "scatter[unique]": lambda r: (
        {"X": [_u(r, (5, 3))], "Ids": [np.array([4, 0, 2], np.int64)],
         "Updates": [_u(r, (3, 3))]}, {"overwrite": True}),
    "scatter[int_many_dups]": lambda r: (
        {"X": [np.zeros((4,), np.int32)],
         "Ids": [r.randint(-5, 6, (40,)).astype(np.int32)],
         "Updates": [np.arange(40, dtype=np.int32)]}, {}),
    "shape[3d]": lambda r: ({"Input": [_u(r, (2, 3, 5))]}, {}),
    "shape[scalar]": lambda r: ({"Input": [np.float32(1.0)]}, {}),
    "fill_zeros_like[int]": lambda r: (
        {"X": [np.ones((2, 3), np.int32)]}, {}),
    "fill_any_like[int_trunc]": lambda r: (
        {"X": [np.zeros((2,), np.int32)]}, {"value": 3.7}),
    "fill_any_like[dtype]": lambda r: (
        {"X": [_u(r, (2, 3))]}, {"value": -2.5, "dtype": "int64"}),
    "fill_any_like[dtype_minus1]": lambda r: (
        {"X": [_u(r, (2, 3))]}, {"value": 1.0, "dtype": -1}),
    "expand[short_times]": lambda r: ({"X": [_u(r, (2, 3))]},
                                      {"expand_times": [3]}),
    "expand[long_times]": lambda r: ({"X": [_u(r, (2, 3))]},
                                     {"expand_times": [2, 1, 2]}),
    "expand_v2[minus_one]": lambda r: ({"X": [_u(r, (3, 1))]},
                                       {"shape": [2, -1, 4]}),
    "tile[sweep]": lambda r: ({"X": [_u(r, (2, 3))]},
                              {"repeat_times": [2, 2]}),
    "tile[int]": lambda r: ({"X": [np.arange(3, dtype=np.int32)]},
                            {"repeat_times": [2, 1, 3]}),
    "range[float_step]": lambda r: (
        {}, {"start": 0.0, "end": 1.0, "step": 0.1, "dtype": "float32"}),
    "range[float_step_uneven]": lambda r: (
        {}, {"start": 0.5, "end": 3.3, "step": 0.7, "dtype": "float32"}),
    "range[int]": lambda r: ({}, {"start": 1, "end": 10, "step": 3,
                                  "dtype": "int64"}),
    "range[negative_step]": lambda r: ({}, {"start": 10, "end": 1,
                                            "step": -3, "dtype": "int32"}),
    "range[empty]": lambda r: ({}, {"start": 5, "end": 1, "step": 1,
                                    "dtype": "int64"}),
    "range[tensors_0d]": lambda r: (
        {"Start": [np.array(0.5, np.float32)],
         "End": [np.array(3.3, np.float32)],
         "Step": [np.array(0.7, np.float32)]}, {"dtype": "float32"}),
    "range[tensors_1]": lambda r: (
        {"Start": [np.array([0.0], np.float32)],
         "End": [np.array([1.0], np.float32)],
         "Step": [np.array([0.1], np.float32)]}, {"dtype": "float32"}),
    "where[bool]": lambda r: ({"Condition": [r.rand(3, 4) > 0.5],
                               "X": [_u(r, (3, 4))], "Y": [_u(r, (3, 4))]},
                              {}),
    "where[float_cond]": lambda r: (
        {"Condition": [np.array([1.0, 0.0, NAN, -0.0], np.float32)],
         "X": [_u(r, (4,))], "Y": [_u(r, (4,))]}, {}),
    "where[broadcast]": lambda r: ({"Condition": [r.rand(3, 1) > 0.5],
                                    "X": [_u(r, (3, 4))],
                                    "Y": [_u(r, (4,))]}, {}),
    "cumsum[axis1]": lambda r: ({"X": [_u(r, (3, 4))]}, {"axis": 1}),
    "cumsum[default_axis]": lambda r: ({"X": [_u(r, (3, 4))]}, {}),
    "cumsum[reverse]": lambda r: ({"X": [_u(r, (3, 4))]},
                                  {"axis": 0, "reverse": True}),
    "cumsum[flatten]": lambda r: ({"X": [_u(r, (3, 4))]},
                                  {"flatten": True}),
    "cumsum[int]": lambda r: (
        {"X": [r.randint(-9, 9, (3, 4)).astype(np.int32)]}, {"axis": 1}),
    "cumsum[bool]": lambda r: ({"X": [r.rand(3, 4) > 0.5]}, {"axis": 1}),
    "pad[sweep]": lambda r: ({"X": [_u(r, (2, 3))]},
                             {"paddings": [1, 0, 2, 3], "pad_value": 0.5}),
    "pad[int]": lambda r: ({"X": [np.ones((2, 2), np.int32)]},
                           {"paddings": [0, 1, 1, 0], "pad_value": 2.7}),
    "tril_triu[upper]": lambda r: ({"X": [_u(r, (4, 5))]},
                                   {"diagonal": 1, "lower": False}),
    "tril_triu[lower_neg]": lambda r: ({"X": [_u(r, (2, 4, 5))]},
                                       {"diagonal": -1, "lower": True}),
    "fill_constant_batch_size_like[idx]": lambda r: (
        {"Input": [_u(r, (2, 6))]},
        {"shape": [4, 1, 3], "value": 1.5, "input_dim_idx": 1,
         "output_dim_idx": 2, "dtype": "int32"}),
})




def lod(*lengths):
    return np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)


CASES.update({
    "sequence_mask[int64]": lambda r: (
        {"X": [np.array([2, 0, 3, 7], np.int64)]}, {"maxlen": 5}),
    "sequence_mask[float32]": lambda r: (
        {"X": [np.array([[2], [4]], np.int32)]},
        {"maxlen": 4, "out_dtype": "float32"}),
    "sequence_mask[no_maxlen]": lambda r: (
        {"X": [np.array([2, 1], np.int32)]}, {}),
    "sequence_pad[sweep]": lambda r: (
        {"X": [_u(r, (6, 3))], "Lod": [lod(2, 0, 4)]},
        {"padded_length": 5}),
    "sequence_pad[pad_value]": lambda r: (
        {"X": [_u(r, (6, 3))], "Lod": [lod(3, 3)],
         "PadValue": [np.array([-7.5], np.float32)]}, {"padded_length": 4}),
    "sequence_pad[truncate]": lambda r: (
        {"X": [_u(r, (7,))], "Lod": [lod(5, 2)]}, {"padded_length": 3}),
    "sequence_pad[empty_last]": lambda r: (
        {"X": [_u(r, (4, 2))], "Lod": [lod(4, 0)]}, {"padded_length": 2}),
    "sequence_unpad[sweep]": lambda r: (
        {"X": [_u(r, (2, 4, 3))], "Length": [np.array([2, 4], np.int32)]},
        {}),
    "sequence_softmax[sweep]": lambda r: (
        {"X": [_u(r, (7,), -3, 3)], "Lod": [lod(3, 1, 3)]}, {}),
    "sequence_softmax[past_lod]": lambda r: (
        {"X": [_u(r, (8, 1), -3, 3)], "Lod": [lod(3, 2)]}, {}),
    "sequence_reverse[sweep]": lambda r: (
        {"X": [_u(r, (7, 2))], "Lod": [lod(3, 0, 4)]}, {}),
    "sequence_reverse[past_lod]": lambda r: (
        {"X": [np.arange(9, dtype=np.int32)], "Lod": [lod(4, 3)]}, {}),
    "sequence_expand[sweep]": lambda r: (
        {"X": [_u(r, (2, 3))], "RefLod": [lod(2, 3)]}, {"out_rows": 5}),
    "sequence_expand[past_rows]": lambda r: (
        {"X": [_u(r, (2, 3))], "RefLod": [lod(1, 1)]}, {"out_rows": 4}),
    "sequence_expand[no_rows]": lambda r: (
        {"X": [_u(r, (2, 3))], "RefLod": [lod(1, 1)]}, {}),
    "sequence_concat[lod]": lambda r: (
        {"X": [_u(r, (2, 3, 2)), _u(r, (2, 4, 2))],
         "Lod": [np.array([[3, 1], [2, 4]], np.int32)]}, {}),
    "sequence_concat[no_lod]": lambda r: (
        {"X": [_u(r, (2, 3)), _u(r, (2, 1)), _u(r, (2, 2))]}, {}),
    "sequence_slice[sweep]": lambda r: (
        {"X": [_u(r, (2, 5, 3))], "Offset": [np.array([0, 1], np.int64)],
         "Length": [np.array([3, 2], np.int64)]}, {"max_length": 3}),
    "sequence_slice[past_end]": lambda r: (
        {"X": [_u(r, (3, 4))], "Offset": [np.array([2, 3, -1], np.int32)],
         "Length": [np.array([4, 1, 2], np.int32)]}, {}),
    "sequence_reshape[sweep]": lambda r: (
        {"X": [_u(r, (2, 4, 6))]}, {"new_dim": 3}),
    "sequence_enumerate[sweep]": lambda r: (
        {"X": [r.randint(0, 9, (2, 5)).astype(np.int64)]},
        {"win_size": 3, "pad_value": -1}),
    "sequence_scatter[sweep]": lambda r: (
        {"X": [_u(r, (2, 4))], "Ids": [np.array([[0, 1], [2, 3]], np.int64)],
         "Updates": [_u(r, (2, 2))]}, {}),
    "sequence_scatter[dup_neg_oob]": lambda r: (
        {"X": [_u(r, (2, 4))],
         "Ids": [np.array([[1, 1, -1, 4], [-5, 0, 0, 3]], np.int32)],
         "Updates": [_u(r, (2, 4))]}, {}),
    "sequence_erase[sweep]": lambda r: (
        {"X": [np.array([[1, 2, 0, 3], [0, 0, 5, 1]], np.int64)]},
        {"tokens": [0, 1]}),
    "sequence_erase[no_tokens]": lambda r: (
        {"X": [np.array([[1, 2, 0, 3]], np.int32)]}, {}),
    "sequence_conv[sweep]": lambda r: (
        {"X": [_u(r, (2, 5, 3))], "Filter": [_u(r, (9, 4))]},
        {"contextStart": -1, "contextLength": 3}),
    "sequence_conv[forward_window]": lambda r: (
        {"X": [_u(r, (2, 5, 2))], "Filter": [_u(r, (8, 3))]},
        {"contextStart": 1}),
    "sequence_conv[stride2]": lambda r: (
        {"X": [_u(r, (2, 5, 2))], "Filter": [_u(r, (6, 3))]},
        {"contextStride": 2}),
    "sequence_expand_as[y]": lambda r: (
        {"X": [_u(r, (2, 3))], "Y": [_u(r, (2, 4, 1))]}, {}),
    "sequence_expand_as[ylength]": lambda r: (
        {"X": [_u(r, (3, 2))], "YLength": [np.array([1, 0, 3], np.int32)]},
        {"max_len": 3}),
    "sequence_expand_as[no_width]": lambda r: (
        {"X": [_u(r, (3, 2))], "YLength": [np.array([1, 0, 3], np.int32)]},
        {}),
})
for _pt in ("SUM", "MEAN", "AVERAGE", "SQRT", "MAX", "LAST", "FIRST"):
    CASES[f"sequence_pool[{_pt}]"] = lambda r, p=_pt: (
        {"X": [_u(r, (7, 2), -3, 3)], "Lod": [lod(3, 0, 4)]},
        {"pooltype": p})
    CASES[f"sequence_pool[{_pt},past_lod]"] = lambda r, p=_pt: (
        {"X": [_u(r, (9,), -3, 3)], "Lod": [lod(2, 5)]}, {"pooltype": p})
CASES["sequence_pool[MAX,nan_inf]"] = lambda r: (
    {"X": [np.array([1.0, np.nan, 2.0, np.inf, -1.0, 3.0], np.float32)],
     "Lod": [lod(2, 2, 2)]}, {"pooltype": "MAX"})
CASES["sequence_pool[SUM,int]"] = lambda r: (
    {"X": [np.arange(7, dtype=np.int32)], "Lod": [lod(3, 4)]},
    {"pooltype": "SUM"})
for _ks in ((1,), (1, 3), (2, 5)):
    CASES[f"sequence_topk_avg_pooling[topks={_ks}]"] = \
        lambda r, ks=_ks: (
            {"X": [r.randint(0, 4, (2, 3, 4, 6)).astype(np.float32) * 0.5],
             "ROW": [np.array([4, 2], np.int32)],
             "COLUMN": [np.array([6, 3], np.int32)]}, {"topks": list(ks)})
CASES.update({
    "beam_search[accumulated]": lambda r: (
        {"pre_ids": [np.array([[3], [2], [5], [1]], np.int64)],
         "pre_scores": [_u(r, (4, 1), -3, 0)],
         "scores": [_u(r, (4, 6), -6, 0)]},
        {"beam_size": 2, "end_id": 2, "is_accumulated": True}),
    "beam_search[probabilities]": lambda r: (
        {"pre_ids": [np.array([[3], [4], [5], [1]], np.int32)],
         "pre_scores": [_u(r, (4, 1), -3, 0)],
         "scores": [np.concatenate([_u(r, (4, 5), 0, 1),
                                    np.zeros((4, 1), np.float32)], 1)]},
        {"beam_size": 2, "end_id": 0, "is_accumulated": False}),
    "beam_search[ties]": lambda r: (
        {"pre_ids": [np.array([[1], [1], [1]], np.int32)],
         "pre_scores": [np.zeros((3, 1), np.float32)],
         "scores": [np.array([[-1.0, -0.5, -0.5, -2.0, -0.5]] * 3,
                             np.float32)]},
        {"beam_size": 3, "end_id": 4}),
    "beam_search[finished_lanes]": lambda r: (
        {"pre_ids": [np.array([[2], [2], [0], [2]], np.int32)],
         "pre_scores": [np.array([[-1.0], [-2.0], [-0.5], [-3.0]],
                                 np.float32)],
         "scores": [_u(r, (4, 5), -4, 0)]},
        {"beam_size": 2, "end_id": 2}),
    "gather_tree[sweep]": lambda r: (
        {"Ids": [r.randint(0, 9, (4, 2, 3)).astype(np.int64)],
         "Parents": [r.randint(0, 3, (4, 2, 3)).astype(np.int64)]}, {}),
    "gather_tree[negative_oob]": lambda r: (
        {"Ids": [r.randint(0, 9, (3, 2, 3)).astype(np.int32)],
         "Parents": [np.array([[[0, -1, 5]] * 2, [[2, -4, 1]] * 2,
                               [[1, 1, 0]] * 2], np.int32)]}, {}),
    "beam_search_decode[sweep]": lambda r: (
        {"Ids": [r.randint(0, 9, (4, 2, 3)).astype(np.int32)],
         "ParentIdx": [r.randint(0, 3, (4, 2, 3)).astype(np.int32)],
         "Scores": [_u(r, (2, 3))]}, {}),
})


def rnn_ins(r, kind, *, seq_len=False, h0=False, projected=False, b=3,
             s=5, d=4, h=6):
    """lstm or gru inputs: Input [b, s, d] (or the projected gates),
    WeightX, WeightH and Bias, with SequenceLength [s, 2, 0] (a full, a
    short and an empty row), H0 (and C0) on request."""
    g = 4 if kind == "lstm" else 3
    ins = {"Input": [_u(r, (b, s, g * h if projected else d))],
           "WeightH": [_u(r, (h, g * h), -0.5, 0.5)],
           "Bias": [_u(r, (g * h,), -0.2, 0.2)]}
    if not projected:
        ins["WeightX"] = [_u(r, (d, g * h), -0.5, 0.5)]
    if seq_len:
        ins["SequenceLength"] = [np.array([s, 2, 0][:b], np.int32)]
    if h0:
        ins["H0"] = [_u(r, (b, h))]
        if kind == "lstm":
            ins["C0"] = [_u(r, (b, h))]
    return ins


for _kind in ("lstm", "gru"):
    for _sl, _rev, _h0, _proj in ((False, False, False, False),
                                  (True, True, True, False),
                                  (True, False, False, True)):
        CASES[f"{_kind}[len={_sl},rev={_rev},h0={_h0},proj={_proj}]"] = (
            lambda r, k=_kind, sl=_sl, rev=_rev, h0=_h0, pj=_proj: (
                rnn_ins(r, k, seq_len=sl, h0=h0, projected=pj),
                {"is_reverse": rev}))


# -- the CRF family: ragged lengths with a 0 and an S, S = 1, Viterbi
#    ties (equal emissions, tied transitions), bf16 emissions -------------

def crf_ins(r, lengths, s, t=3, *, ties=False, bf16=False, label=True):
    """linear_chain_crf / crf_decoding inputs: Emission [B, S, T] (all
    equal with ``ties``), Transition [T + 2, T] (on a grid of 0.5 with
    ``ties``), Label [B, S], Length [B] (None: no Length input)."""
    b = 2 if lengths is None else len(lengths)
    e = np.zeros((b, s, t), np.float32) if ties else _u(r, (b, s, t), -2, 2)
    w = _ties(r, (t + 2, t)) if ties else _u(r, (t + 2, t))
    ins = {"Emission": [BF16(e) if bf16 else e], "Transition": [w]}
    if label:
        ins["Label"] = [r.randint(0, t, (b, s)).astype(np.int64)]
    if lengths is not None:
        ins["Length"] = [np.array(lengths, np.int64)]
    return ins


for _name, _lens, _s, _kw in (("ragged", [5, 3, 0, 1], 5, {}),
                              ("full", None, 4, {}),
                              ("s1", [1, 0], 1, {}),
                              ("ties", [4, 2, 4], 4, {"ties": True}),
                              ("bf16", [6, 6, 2], 6, {"bf16": True})):
    CASES[f"linear_chain_crf[{_name}]"] = (
        lambda r, ln=_lens, s=_s, kw=_kw: (crf_ins(r, ln, s, **kw), {}))
    CASES[f"crf_decoding[{_name}]"] = (
        lambda r, ln=_lens, s=_s, kw=_kw: (
            crf_ins(r, ln, s, label=False, **kw), {}))
CASES["crf_decoding[label]"] = lambda r: (crf_ins(r, [5, 3, 0], 5), {})
CASES.update({
    "ctc_align[reference]": lambda r: (
        {"Input": [np.array([[0, 1, 1, 0, 2, 2, 0, 3],
                             [1, 1, 2, 0, 0, 3, 3, 0]], np.int32)],
         "InputLength": [np.array([8, 6], np.int64)]},
        {"blank": 0, "padding_value": -1}),
    "ctc_align[ragged]": lambda r: (
        {"Input": [r.randint(0, 4, (4, 7)).astype(np.int64)],
         "InputLength": [np.array([7, 3, 0, 1], np.int32)]},
        {"blank": 2}),
    "ctc_align[no_length]": lambda r: (
        {"Input": [r.randint(0, 3, (3, 6)).astype(np.int32)]},
        {"blank": 0, "padding_value": 9}),
    "edit_distance[ragged]": lambda r: (
        {"Hyps": [r.randint(1, 5, (4, 6)).astype(np.int64)],
         "Refs": [r.randint(1, 5, (4, 5)).astype(np.int64)],
         "HypsLength": [np.array([6, 4, 0, 1], np.int64)],
         "RefsLength": [np.array([5, 5, 2, 0], np.int64)]},
        {"normalized": False}),
    "edit_distance[normalized_ref0]": lambda r: (
        {"Hyps": [r.randint(1, 4, (3, 5)).astype(np.int32)],
         "Refs": [r.randint(1, 4, (3, 4)).astype(np.int32)],
         "HypsLength": [np.array([5, 2, 3], np.int32)],
         "RefsLength": [np.array([4, 0, 1], np.int32)]},
        {"normalized": True}),
    "edit_distance[no_length]": lambda r: (
        {"Hyps": [r.randint(0, 3, (2, 4)).astype(np.int32)],
         "Refs": [r.randint(0, 3, (2, 6)).astype(np.int32)]},
        {"normalized": True}),
})


# -- the fused RNN ops: with and without lengths (a 0 and an S among
#    them), reversed, with H0 / C0, other activations ------------------

def fused_ins(r, kind, *, seq_len=False, h0=False, b=3, s=5, m=4, h=6):
    """fusion_lstm (G = 4) or fusion_gru (G = 3) inputs: X [b, s, m],
    WeightX, WeightH and Bias, SequenceLength [s, 2, 0] on request, H0
    (and C0) on request."""
    g = 4 if kind == "fusion_lstm" else 3
    ins = {"X": [_u(r, (b, s, m))],
           "WeightX": [_u(r, (m, g * h), -0.5, 0.5)],
           "WeightH": [_u(r, (h, g * h), -0.5, 0.5)],
           "Bias": [_u(r, (g * h,), -0.2, 0.2)]}
    if seq_len:
        ins["SequenceLength"] = [np.array([s, 2, 0][:b], np.int32)]
    if h0:
        ins["H0"] = [_u(r, (b, h))]
        if kind == "fusion_lstm":
            ins["C0"] = [_u(r, (b, h))]
    return ins


def attention_lstm_ins(r, *, scalar=True, seq_len=True, b=3, s=4, m=4,
                       d=3):
    ins = {"X": [_u(r, (b, s, m))], "C0": [_u(r, (b, d), -0.5, 0.5)],
           "H0": [_u(r, (b, d), -0.5, 0.5)],
           "AttentionWeight": [_u(r, (m + d, 1), -0.6, 0.6)],
           "AttentionBias": [np.array([0.1], np.float32)],
           "LSTMWeight": [_u(r, (d + m, 4 * d), -0.5, 0.5)],
           "LSTMBias": [_u(r, (4 * d,), -0.2, 0.2)]}
    if scalar:
        ins["AttentionScalar"] = [np.array([1.3], np.float32)]
        ins["AttentionScalarBias"] = [np.array([0.05], np.float32)]
    if seq_len:
        ins["SequenceLength"] = [np.array([s, 2, 0][:b], np.int32)]
    return ins


for _kind in ("fusion_lstm", "fusion_gru"):
    for _sl, _rev, _h0 in ((False, False, False), (True, True, True),
                           (True, False, False), (False, True, True)):
        CASES[f"{_kind}[len={_sl},rev={_rev},h0={_h0}]"] = (
            lambda r, k=_kind, sl=_sl, rev=_rev, h0=_h0: (
                fused_ins(r, k, seq_len=sl, h0=h0), {"is_reverse": rev}))
CASES.update({
    "fusion_lstm[relu_identity]": lambda r: (
        fused_ins(r, "fusion_lstm", seq_len=True),
        {"gate_activation": "sigmoid", "cell_activation": "relu",
         "candidate_activation": "identity"}),
    "fusion_lstm[peepholes]": lambda r: (
        fused_ins(r, "fusion_lstm"), {"use_peepholes": True}),
    "fusion_gru[origin_mode]": lambda r: (
        fused_ins(r, "fusion_gru", seq_len=True, h0=True),
        {"origin_mode": True}),
    "fusion_gru[relu]": lambda r: (
        fused_ins(r, "fusion_gru"), {"activation": "relu",
                                     "origin_mode": True}),
    "attention_lstm[scalar]": lambda r: (attention_lstm_ins(r), {}),
    "attention_lstm[no_scalar]": lambda r: (
        attention_lstm_ins(r, scalar=False), {}),
    "attention_lstm[no_length]": lambda r: (
        attention_lstm_ins(r, seq_len=False), {}),
    "fusion_seqconv_eltadd_relu[window3]": lambda r: (
        {"X": [_u(r, (2, 5, 3))], "Filter": [_u(r, (9, 4), -0.5, 0.5)],
         "Bias": [_u(r, (4,), -0.2, 0.2)]},
        {"contextLength": 3, "contextStart": -1, "contextStride": 1}),
    "fusion_seqconv_eltadd_relu[forward]": lambda r: (
        {"X": [_u(r, (2, 4, 2))], "Filter": [_u(r, (4, 3))],
         "Bias": [_u(r, (3,))]}, {"contextStart": 1}),
    "fusion_seqexpand_concat_fc[relu]": lambda r: (
        {"X": [_u(r, (2, 3, 3)), _u(r, (2, 2))],
         "FCWeight": [_u(r, (5, 4), -0.5, 0.5)],
         "FCBias": [_u(r, (4,), -0.2, 0.2)]}, {"fc_activation": "relu"}),
    "fusion_seqexpand_concat_fc[two_rows_no_bias]": lambda r: (
        {"X": [_u(r, (3, 2, 2)), _u(r, (3, 1)), _u(r, (3, 3))],
         "FCWeight": [_u(r, (6, 2))]}, {}),
})


# -- the tensor-array, rank-table and split/merge ops ------------------

CASES.update({
    "array_read[sweep]": lambda r: (
        {"X": [_u(r, (4, 2, 3))], "I": [np.array([2], np.int64)]}, {}),
    "array_read[int]": lambda r: (
        {"X": [r.randint(-9, 9, (3, 4)).astype(np.int32)],
         "I": [np.array(0, np.int32)]}, {}),
    "array_write[sweep]": lambda r: (
        {"X": [_u(r, (4, 2, 3))], "I": [np.array([3], np.int32)],
         "V": [_u(r, (2, 3))]}, {}),
    "lod_rank_table[ties]": lambda r: (
        {"X": [np.array([3, 5, 3, 0, 5, 1], np.int64)]}, {}),
    "lod_rank_table[column]": lambda r: (
        {"X": [np.array([[2], [7], [4]], np.int32)]}, {}),
    "split_lod_tensor[rows]": lambda r: (
        {"X": [_u(r, (4, 3))],
         "Mask": [np.array([[1], [0], [1], [0]], np.int32)]}, {}),
    "split_lod_tensor[3d_bool]": lambda r: (
        {"X": [_u(r, (3, 2, 2))],
         "Mask": [np.array([True, True, False])]}, {}),
    "merge_lod_tensor[rows]": lambda r: (
        {"InTrue": [_u(r, (4, 3))], "InFalse": [_u(r, (4, 3))],
         "Mask": [np.array([[0], [1], [1], [0]], np.float32)]}, {}),
    "shrink_rnn_memory[step2]": lambda r: (
        {"X": [_u(r, (4, 3))],
         "RankTable": [np.array([5, 3, 2, 1], np.int32),
                       np.array([1, 0, 3, 2], np.int32)],
         "I": [np.array([2], np.int64)]}, {}),
    "lod_tensor_to_array[ragged]": lambda r: (
        {"X": [_u(r, (3, 4, 2))],
         "RankTable": [np.array([4, 2, 0], np.int32),
                       np.array([2, 0, 1], np.int32)]}, {}),
    "array_to_lod_tensor[ragged]": lambda r: (
        {"X": [_u(r, (4, 3, 2))],
         "RankTable": [np.array([4, 2, 0], np.int32),
                       np.array([2, 0, 1], np.int32)]}, {}),
})


# -- the op types of the 2.0 API (nn, nn.functional, tensor, the 2.0
# optimizers): edges, ties at thresholds, out-of-range indices, empty and
# full selections, every padding mode and layout variant -------------------

_API_ACT = ("sin", "selu", "brelu", "thresholded_relu", "tanh_shrink",
            "softshrink", "hard_shrink")
for _op in _API_ACT:
    CASES[f"{_op}[edge]"] = lambda r: ({"X": [EDGE.reshape(3, 4)]}, {})
    CASES[f"{_op}[range]"] = lambda r: ({"X": [_u(r, (4, 5), -6, 6)]}, {})

_OPT_SHAPE = (3, 4)


def _opt_ins(r, **state):
    """Param, Grad, LearningRate and the named state (each "pos" for a
    positive array, "any" for any sign, a float for a [1] fill)."""
    ins = {"Param": [_u(r, _OPT_SHAPE)], "Grad": [_u(r, _OPT_SHAPE)],
           "LearningRate": [np.array([0.05], np.float32)]}
    for slot, kind in state.items():
        if kind == "pos":
            ins[slot] = [_u(r, _OPT_SHAPE, 0.01, 1.0)]
        elif kind == "any":
            ins[slot] = [_u(r, _OPT_SHAPE)]
        else:
            ins[slot] = [np.array([kind], np.float32)]
    return ins


CASES.update({
    "selu[attrs]": lambda r: ({"X": [_u(r, (3, 4), -3, 3)]},
                              {"scale": 1.5, "alpha": 0.5}),
    "brelu[bounds]": lambda r: (
        {"X": [np.array([-1.0, 0.0, 0.5, 2.0, 3.0, NAN], np.float32)]},
        {"t_min": 0.0, "t_max": 2.0}),
    "thresholded_relu[at]": lambda r: (
        {"X": [np.array([0.5, 1.0, 1.5, -1.0], np.float32)]},
        {"threshold": 1.0}),
    "softshrink[at]": lambda r: (
        {"X": [np.array([-0.5, 0.5, 0.7, -0.7, 0.0], np.float32)]},
        {"lambda": 0.5}),
    "hard_shrink[at]": lambda r: (
        {"X": [np.array([-0.5, 0.5, 0.7, -0.7, -0.0], np.float32)]},
        {"threshold": 0.5}),
    "eye[square]": lambda r: ({}, {"num_rows": 4, "dtype": "float32"}),
    "eye[rect_int]": lambda r: ({}, {"num_rows": 2, "num_columns": 5,
                                     "dtype": "int64"}),
    "linspace[basic]": lambda r: (
        {"Start": [np.array([-1.5], np.float32)],
         "Stop": [np.array([2.0], np.float32)]}, {"num": 7}),
    "linspace[one]": lambda r: (
        {"Start": [np.array([3.0], np.float32)],
         "Stop": [np.array([9.0], np.float32)]}, {"num": 1}),
    "linspace[descending]": lambda r: (
        {"Start": [np.array([1.0], np.float32)],
         "Stop": [np.array([-1.0], np.float32)]}, {"num": 5}),
    "index_select[basic]": lambda r: (
        {"X": [_u(r, (4, 3))], "Index": [np.array([2, 0, 2], np.int64)]},
        {"dim": 0}),
    "index_select[wrap_and_range]": lambda r: (
        {"X": [_u(r, (3, 5))],
         "Index": [np.array([-1, -5, 4, 5, -6], np.int64)]}, {"dim": 1}),
    "index_select[int]": lambda r: (
        {"X": [np.arange(12, dtype=np.int32).reshape(3, 4)],
         "Index": [np.array([3, 9, -1], np.int32)]}, {"dim": 1}),
    "index_select[empty]": lambda r: (
        {"X": [_u(r, (3, 2))], "Index": [np.zeros((0,), np.int32)]},
        {"dim": 0}),
    "flip[axes]": lambda r: ({"X": [_u(r, (2, 3, 4))]}, {"axis": [0, 2]}),
    "flip[int]": lambda r: ({"X": [np.arange(6, dtype=np.int32)]},
                            {"axis": [0]}),
    "roll[flat]": lambda r: ({"X": [_u(r, (3, 4))]}, {"shifts": [5]}),
    "roll[axes]": lambda r: ({"X": [_u(r, (3, 4))]},
                             {"shifts": [-1, 6], "axis": [0, 1]}),
    "bce_loss[basic]": lambda r: (
        {"X": [_u(r, (4, 3), 0.05, 0.95)],
         "Label": [(r.rand(4, 3) > 0.5).astype(np.float32)]}, {}),
    "bce_loss[saturated]": lambda r: (
        {"X": [np.array([0.0, 1.0, 1e-20, 1.0 - 1e-9], np.float32)],
         "Label": [np.array([1.0, 0.0, 1.0, 0.0], np.float32)]}, {}),
    "margin_rank_loss[basic]": lambda r: (
        {"X1": [_u(r, (5, 1))], "X2": [_u(r, (5, 1))],
         "Label": [np.sign(_u(r, (5, 1))).astype(np.float32)]},
        {"margin": 0.1}),
    "margin_rank_loss[ties]": lambda r: (
        {"X1": [np.array([[1.0], [0.5], [NAN]], np.float32)],
         "X2": [np.array([[1.0], [0.4], [0.0]], np.float32)],
         "Label": [np.array([[1.0], [-1.0], [1.0]], np.float32)]},
        {"margin": 0.0}),
    "instance_norm[affine]": lambda r: (
        {"X": [_u(r, (2, 3, 4, 5), -2, 2)], "Scale": [_u(r, (3,))],
         "Bias": [_u(r, (3,))]}, {"epsilon": 1e-5}),
    "instance_norm[plain_const]": lambda r: (
        {"X": [np.ones((2, 2, 3, 3), np.float32)]}, {}),
    "gru_unit[basic]": lambda r: (
        {"Input": [_u(r, (3, 12))], "HiddenPrev": [_u(r, (3, 4))],
         "Weight": [_u(r, (4, 12))], "Bias": [_u(r, (1, 12))]}, {}),
    "lstm_unit[forget_bias]": lambda r: (
        {"X": [_u(r, (3, 16), -3, 3)], "C_prev": [_u(r, (3, 4))]},
        {"forget_bias": 1.0}),
    "warpctc[full]": lambda r: (
        {"Logits": [_u(r, (2, 6, 5), -2, 2)],
         "Label": [np.array([[1, 2, 2], [3, 1, 4]], np.int32)]},
        {"blank": 0}),
    "warpctc[lengths]": lambda r: (
        {"Logits": [_u(r, (3, 7, 4), -2, 2)],
         "Label": [np.array([[1, 1, 2], [3, 0, 0], [2, 3, 1]], np.int32)],
         "LogitsLength": [np.array([7, 4, 6], np.int64)],
         "LabelLength": [np.array([3, 1, 2], np.int64)]}, {"blank": 0}),
    "masked_select[basic]": lambda r: (
        {"X": [_u(r, (3, 4))], "Mask": [r.rand(3, 4) > 0.5]}, {}),
    "masked_select[none]": lambda r: (
        {"X": [_u(r, (2, 3))], "Mask": [np.zeros((2, 3), bool)]}, {}),
    "masked_select[all_nan]": lambda r: (
        {"X": [EDGE.reshape(3, 4)], "Mask": [np.ones((3, 4), bool)]}, {}),
    "pixel_shuffle[r2]": lambda r: ({"X": [_u(r, (2, 8, 3, 2))]},
                                    {"upscale_factor": 2}),
    "lrn[basic]": lambda r: ({"X": [_u(r, (2, 6, 3, 3))]},
                             {"n": 5, "alpha": 1e-2, "beta": 0.75,
                              "k": 1.0}),
    "lrn[even_n]": lambda r: ({"X": [_u(r, (1, 4, 2, 2))]},
                              {"n": 2, "alpha": 0.1, "beta": 0.5,
                               "k": 2.0}),
    "bilinear_tensor_product[bias]": lambda r: (
        {"X": [_u(r, (3, 4))], "Y": [_u(r, (3, 5))],
         "Weight": [_u(r, (2, 4, 5))], "Bias": [_u(r, (1, 2))]}, {}),
    "bilinear_tensor_product[plain]": lambda r: (
        {"X": [_u(r, (2, 3))], "Y": [_u(r, (2, 3))],
         "Weight": [_u(r, (4, 3, 3))]}, {}),
    "conv2d_transpose[basic]": lambda r: (
        {"Input": [_u(r, (2, 3, 4, 4))], "Filter": [_u(r, (3, 2, 3, 3))]},
        {"strides": [1, 1], "paddings": [0, 0]}),
    "conv2d_transpose[stride_pad]": lambda r: (
        {"Input": [_u(r, (1, 2, 3, 5))], "Filter": [_u(r, (2, 3, 3, 2))]},
        {"strides": [2, 3], "paddings": [1, 0]}),
    "conv2d_transpose[groups_pads4]": lambda r: (
        {"Input": [_u(r, (1, 4, 4, 4))], "Filter": [_u(r, (4, 1, 3, 3))]},
        {"strides": [2, 2], "paddings": [0, 1, 1, 2], "groups": 2}),
    "conv2d_transpose[dilation]": lambda r: (
        {"Input": [_u(r, (1, 2, 5, 5))], "Filter": [_u(r, (2, 2, 3, 3))]},
        {"strides": [1, 1], "paddings": [1, 1], "dilations": [2, 2]}),
    "conv2d_transpose[same]": lambda r: (
        {"Input": [_u(r, (1, 2, 4, 4))], "Filter": [_u(r, (2, 3, 3, 3))]},
        {"strides": [2, 2], "padding_algorithm": "SAME"}),
    "conv2d_transpose[valid]": lambda r: (
        {"Input": [_u(r, (1, 2, 4, 4))], "Filter": [_u(r, (2, 3, 2, 2))]},
        {"strides": [1, 1], "padding_algorithm": "VALID"}),
    "hierarchical_sigmoid[default]": lambda r: (
        {"X": [_u(r, (4, 3))], "W": [_u(r, (5, 3))],
         "Label": [np.array([0, 5, 3, 2], np.int64)],
         "Bias": [_u(r, (5, 1))]}, {"num_classes": 6}),
    "hierarchical_sigmoid[custom]": lambda r: (
        {"X": [_u(r, (2, 3))], "W": [_u(r, (4, 3))],
         "Label": [np.array([0, 1], np.int64)],
         "PathTable": [np.array([[0, 2, -1], [1, 3, 0]], np.int64)],
         "PathCode": [np.array([[1, 0, 0], [0, 1, 1]], np.int64)]},
        {"num_classes": 5}),
    "sync_batch_norm[train]": lambda r: (
        {"X": [_u(r, (4, 3, 2, 2), -2, 2)], "Scale": [_u(r, (3,))],
         "Bias": [_u(r, (3,))], "Mean": [_u(r, (3,))],
         "Variance": [_u(r, (3,), 0.5, 1.5)]},
        {"momentum": 0.9, "epsilon": 1e-5, "is_test": False}),
    "sync_batch_norm[test]": lambda r: (
        {"X": [_u(r, (2, 3, 2, 2))], "Scale": [_u(r, (3,))],
         "Bias": [_u(r, (3,))], "Mean": [_u(r, (3,))],
         "Variance": [_u(r, (3,), 0.5, 1.5)]}, {"is_test": True}),
    "group_norm[affine]": lambda r: (
        {"X": [_u(r, (2, 6, 3, 2), -2, 2)], "Scale": [_u(r, (6,))],
         "Bias": [_u(r, (6,))]}, {"groups": 3, "epsilon": 1e-5}),
    "interpolate[nearest_up]": lambda r: (
        {"X": [_u(r, (1, 2, 3, 4))]},
        {"out_h": 7, "out_w": 8, "interp_method": "nearest"}),
    "interpolate[nearest_down]": lambda r: (
        {"X": [_u(r, (1, 2, 6, 5))]},
        {"out_h": 4, "out_w": 2, "interp_method": "nearest"}),
    "interpolate[bilinear_up]": lambda r: (
        {"X": [_u(r, (2, 1, 3, 4))]},
        {"scale": 2.0, "interp_method": "bilinear"}),
    "interpolate[bilinear_down]": lambda r: (
        {"X": [_u(r, (1, 2, 8, 6))]},
        {"out_h": 3, "out_w": 4, "interp_method": "bilinear"}),
    "pad2d[constant]": lambda r: (
        {"X": [_u(r, (1, 2, 3, 3))]},
        {"paddings": [1, 0, 2, 1], "mode": "constant", "pad_value": -0.5}),
    "pad2d[reflect]": lambda r: (
        {"X": [_u(r, (1, 2, 3, 4))]},
        {"paddings": [2, 1, 0, 3], "mode": "reflect"}),
    "pad2d[edge]": lambda r: (
        {"X": [_u(r, (1, 1, 2, 3))]},
        {"paddings": [1, 2, 2, 0], "mode": "edge"}),
    "pad2d[circular]": lambda r: (
        {"X": [_u(r, (1, 1, 3, 3))]},
        {"paddings": [1, 1, 2, 2], "mode": "circular"}),
    "prelu[all]": lambda r: (
        {"X": [EDGE.reshape(3, 4)], "Alpha": [np.array([0.25],
                                                       np.float32)]},
        {"mode": "all"}),
    "prelu[channel]": lambda r: (
        {"X": [_u(r, (2, 3, 2, 2))], "Alpha": [_u(r, (3,))]},
        {"mode": "channel"}),
    "broadcast_to[shape]": lambda r: ({"X": [_u(r, (1, 3, 1))]},
                                      {"shape": [2, 3, 4]}),
    "adagrad[basic]": lambda r: (_opt_ins(r, Moment="pos"),
                                 {"epsilon": 1e-6}),
    "adamax[basic]": lambda r: (
        _opt_ins(r, Moment="any", InfNorm="pos", Beta1Pow=0.81),
        {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    "adadelta[basic]": lambda r: (
        _opt_ins(r, AvgSquaredGrad="pos", AvgSquaredUpdate="pos"),
        {"rho": 0.95, "epsilon": 1e-6}),
    "rmsprop[plain]": lambda r: (
        _opt_ins(r, MeanSquare="pos", Moment="any"),
        {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.5}),
    "rmsprop[centered]": lambda r: (
        _opt_ins(r, MeanSquare="pos", Moment="any", MeanGrad="any"),
        {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.0,
         "centered": True}),
    "decayed_adagrad[basic]": lambda r: (_opt_ins(r, Moment="pos"),
                                         {"decay": 0.9, "epsilon": 1e-6}),
    "ftrl[l1_l2]": lambda r: (
        _opt_ins(r, SquaredAccumulator="pos", LinearAccumulator="any"),
        {"l1": 0.01, "l2": 0.1, "lr_power": -0.5}),
    "ftrl[zero_state]": lambda r: (
        dict(_opt_ins(r, LinearAccumulator="any"),
             SquaredAccumulator=[np.zeros(_OPT_SHAPE, np.float32)]),
        {"l1": 0.0, "l2": 0.0, "lr_power": -0.5}),
})

# the op types of the 2.0 API, by family
API_OPS = ("sin", "selu", "brelu", "thresholded_relu", "tanh_shrink",
           "softshrink", "hard_shrink", "eye", "linspace", "index_select",
           "flip", "roll", "bce_loss", "margin_rank_loss", "instance_norm",
           "gru_unit", "lstm_unit", "warpctc", "masked_select",
           "pixel_shuffle", "lrn", "bilinear_tensor_product",
           "conv2d_transpose", "hierarchical_sigmoid", "sync_batch_norm",
           "group_norm", "interpolate", "pad2d", "prelu", "broadcast_to",
           "adagrad", "adamax", "adadelta", "rmsprop", "decayed_adagrad",
           "ftrl")
