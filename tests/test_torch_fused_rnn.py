"""The fused RNN ops of paddle_tpu_torch (``ops/fused_rnn_ops.py``:
fusion_lstm, fusion_gru, attention_lstm, fusion_seqconv_eltadd_relu,
fusion_seqexpand_concat_fc) held against paddle_tpu on the CPU.

* The reference's tables (``tests/test_ops_round5.py``: the same seeded
  inputs and numpy oracles of TestFusionLstm, TestFusionGru in both
  modes, TestAttentionLstm, TestFusionSeqconvEltaddRelu and
  TestFusionSeqexpandConcatFc), within the reference tests' tolerances.
* Every fused-RNN case of ``tools/glue_cases.py`` (with and without
  SequenceLength, a length of 0 and one of S among them, reversed, H0 /
  C0, relu and identity activations, ``origin_mode``, attention with and
  without its scalar, ``use_peepholes`` raising in both) against the
  reference's lowering within 1e-5, and each op's gradients through the
  port's ``__vjp_grad__`` against ``jax.vjp`` within 2e-5.
* The ``dynamic_lstm`` fault of both packages (ROADMAP queue C): the
  layer accepts gate / cell / candidate activations and drops them, so
  its program and output are the same whatever activations it is given,
  in both packages; only ``fusion_lstm`` honours them.
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core import unique_name as jax_names
import tests.test_ops_round5 as round5
from tests.test_torch_math_tensor_ops import (check_op, ref_ops, run_port,
                                              vjp_both)

import paddle_tpu_torch as ptt
from paddle_tpu_torch import layers as players
from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.core import unique_name as pt_names
from paddle_tpu_torch.tools.glue_cases import CASES, family
from paddle_tpu_torch.tools.glue_cases import rng as _rng

torch.set_num_threads(2)

TOL, GRAD_TOL = 1e-5, 2e-5

FUSED_CASES = {c: f for c, f in CASES.items()
               if family(c.split("[")[0]) == "fused_rnn"}


def test_every_fused_rnn_op_type_is_registered():
    ours = ref_ops("fused_rnn_ops")
    assert sorted(ours) == sorted(
        ["fusion_lstm", "fusion_gru", "attention_lstm",
         "fusion_seqconv_eltadd_relu", "fusion_seqexpand_concat_fc"])
    assert all(pt_registry.lookup(op) is not None for op in ours)
    assert {c.split("[")[0] for c in FUSED_CASES} == set(ours)


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_op_matches_the_reference(case):
    check_op(case.split("[")[0], *FUSED_CASES[case](_rng(case)), case, TOL)


@pytest.mark.parametrize("case", sorted(c for c in FUSED_CASES
                                        if "peepholes" not in c))
def test_fused_op_gradient_matches_the_reference(case):
    r = _rng(case)
    ins, attrs = FUSED_CASES[case](r)
    vjp_both(case.split("[")[0], ins, attrs, r, GRAD_TOL)


def _out(op, ins, attrs=None):
    return {k: v[0].numpy() for k, v in run_port(op, ins,
                                                  attrs or {}).items()}


def test_fusion_lstm_reference_table():
    r = np.random.RandomState(0)
    B, S, M, H = 2, 4, 3, 5
    x = r.randn(B, S, M).astype(np.float32) * 0.5
    wx = r.randn(M, 4 * H).astype(np.float32) * 0.3
    wh = r.randn(H, 4 * H).astype(np.float32) * 0.3
    b = r.randn(4 * H).astype(np.float32) * 0.1
    lens = np.array([4, 3], np.int32)
    xx, hs, cs = round5.TestFusionLstm()._oracle(
        x.astype(np.float64), wx.astype(np.float64), wh.astype(np.float64),
        b.astype(np.float64), lens)
    got = _out("fusion_lstm", {"X": [x], "WeightX": [wx], "WeightH": [wh],
                               "Bias": [b], "SequenceLength": [lens]})
    for k, want in (("XX", xx), ("Hidden", hs), ("Cell", cs)):
        np.testing.assert_allclose(got[k], want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("origin", [False, True])
def test_fusion_gru_reference_table(origin):
    r = np.random.RandomState(1)
    B, S, M, H = 2, 3, 4, 3
    x = r.randn(B, S, M).astype(np.float32) * 0.5
    wx = r.randn(M, 3 * H).astype(np.float32) * 0.3
    wh = r.randn(H, 3 * H).astype(np.float32) * 0.3
    b = r.randn(3 * H).astype(np.float32) * 0.1
    xx, hs = round5.TestFusionGru()._oracle(
        x.astype(np.float64), wx.astype(np.float64), wh.astype(np.float64),
        b.astype(np.float64), origin)
    got = _out("fusion_gru", {"X": [x], "WeightX": [wx], "WeightH": [wh],
                              "Bias": [b]}, {"origin_mode": origin})
    np.testing.assert_allclose(got["XX"], xx, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got["Hidden"], hs, atol=1e-4, rtol=1e-4)


def test_attention_lstm_reference_table():
    r = np.random.RandomState(2)
    B, S, M, D = 2, 3, 4, 3
    x = r.randn(B, S, M).astype(np.float32) * 0.5
    c0 = r.randn(B, D).astype(np.float32) * 0.3
    h0 = r.randn(B, D).astype(np.float32) * 0.3
    aw = r.randn(M + D, 1).astype(np.float32) * 0.4
    ab, scal, scal_b = np.float32(0.1), np.float32(1.3), np.float32(0.05)
    lw = r.randn(D + M, 4 * D).astype(np.float32) * 0.3
    lb = r.randn(4 * D).astype(np.float32) * 0.1
    lens = np.array([3, 2], np.int32)
    hs, cs = round5.TestAttentionLstm()._oracle(
        x.astype(np.float64), c0.astype(np.float64), h0.astype(np.float64),
        aw.astype(np.float64), float(ab), float(scal), float(scal_b),
        lw.astype(np.float64), lb.astype(np.float64), lens)
    got = _out("attention_lstm", {
        "X": [x], "C0": [c0], "H0": [h0], "AttentionWeight": [aw],
        "AttentionBias": [np.array([ab])],
        "AttentionScalar": [np.array([scal])],
        "AttentionScalarBias": [np.array([scal_b])],
        "LSTMWeight": [lw], "LSTMBias": [lb], "SequenceLength": [lens]})
    np.testing.assert_allclose(got["Hidden"], hs, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(got["Cell"], cs, atol=1e-4, rtol=1e-3)


def test_seqconv_and_seqexpand_reference_tables():
    r = np.random.RandomState(0)
    B, S, D, WIN, MO = 2, 5, 3, 3, 4
    x = r.randn(B, S, D).astype(np.float32)
    w = r.randn(WIN * D, MO).astype(np.float32) * 0.3
    b = r.randn(MO).astype(np.float32) * 0.2
    ctx = np.zeros((B, S, WIN * D))
    for k in range(WIN):
        for t in range(S):
            if 0 <= t - 1 + k < S:
                ctx[:, t, k * D:(k + 1) * D] = x[:, t - 1 + k]
    got = _out("fusion_seqconv_eltadd_relu",
               {"X": [x], "Filter": [w], "Bias": [b]},
               {"contextLength": WIN, "contextStart": -1,
                "contextStride": 1})["Out"]
    np.testing.assert_allclose(got, np.maximum(ctx @ w + b, 0.0),
                               atol=1e-5)
    r = np.random.RandomState(4)
    B, S, D0, D1, H = 2, 3, 3, 2, 4
    x0 = r.randn(B, S, D0).astype(np.float32)
    x1 = r.randn(B, D1).astype(np.float32)
    w = r.randn(D0 + D1, H).astype(np.float32) * 0.4
    b = r.randn(H).astype(np.float32) * 0.1
    cat = np.concatenate([x0, np.broadcast_to(x1[:, None], (B, S, D1))], -1)
    got = _out("fusion_seqexpand_concat_fc",
               {"X": [x0, x1], "FCWeight": [w], "FCBias": [b]},
               {"fc_activation": "relu"})["Out"]
    np.testing.assert_allclose(got, np.maximum(cat @ w + b, 0.0),
                               atol=1e-5)


# -- ROADMAP queue C: dynamic_lstm drops its activations in both packages ----

def _dynamic_lstm(pkg, names, L, acts):
    main, startup = pkg.Program(), pkg.Program()
    with names.guard(), pkg.program_guard(main, startup):
        x = L.static_data("x", [2, 5, 24])
        out, _ = L.dynamic_lstm(x, 24, **acts)
    return main, startup


def test_dynamic_lstm_drops_its_activations_in_both_packages():
    """The book's db_lstm asks for relu / sigmoid activations; both
    packages' ``dynamic_lstm`` append the ``lstm`` op with only
    ``is_reverse``, so the activations change nothing: the programs
    given sigmoid/tanh and relu/identity are the same, and equal across
    the packages."""
    progs = []
    for acts in ({}, {"gate_activation": "relu",
                      "cell_activation": "identity",
                      "candidate_activation": "relu"}):
        j = _dynamic_lstm(pt, jax_names, pt.layers, acts)
        p = _dynamic_lstm(ptt, pt_names, players, acts)
        jj = [json.loads(json.dumps(x.to_dict())) for x in j]
        pj = [json.loads(json.dumps(x.to_dict())) for x in p]
        assert pj == jj
        lstm_ops = [op for op in p[0].global_block().ops
                    if op.type == "lstm"]
        assert [sorted(k for k in op.attrs if k != "op_role")
                for op in lstm_ops] == [["is_reverse"]]
        progs.append(pj)
    assert progs[0] == progs[1]
