"""The RNN, sequence and beam-search ops of paddle_tpu_torch held against
paddle_tpu's lowerings on the CPU: ``lstm`` and ``gru`` forward and
gradients (with and without SequenceLength, is_reverse, H0/C0, and the
pre-projected input without WeightX), every one of the 16 sequence ops
and the 3 beam-search ops, on the same seeded numpy inputs, with edge
values (empty sequences, rows past the last offset, out-of-range and
negative ids, ties among beam candidates, NaN in a pooled segment).
Integer outputs bit for bit, floats within 1e-5 (the recurrences'
products accumulate in their own order), gradients within 2e-5; the
layers that wrap these ops build the reference's program JSON."""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core import unique_name as jax_names
from tests.test_torch_math_tensor_ops import check_op, run_port, vjp_both

import paddle_tpu_torch as ptt
from paddle_tpu_torch import layers as players
from paddle_tpu_torch.core import unique_name as pt_names
from paddle_tpu_torch.tools.glue_cases import CASES, _u, lod, rnn_ins
from paddle_tpu_torch.tools.glue_cases import rng as _rng

torch.set_num_threads(2)

# float tolerances: the recurrences and segment sums accumulate in their
# own order; beam search's scores are selected, not computed
RNN_TOL, SEQ_TOL, BEAM_TOL = 1e-5, 1e-5, 0.0
B, S, H = 3, 5, 6


# each of the four options on and off, in four combinations a kind
RNN_CASES = {}
for _kind in ("lstm", "gru"):
    for _sl, _rev, _h0, _proj in ((False, False, False, False),
                                  (True, True, True, False),
                                  (True, False, False, True),
                                  (False, True, True, True)):
        RNN_CASES[f"{_kind}[len={_sl},rev={_rev},h0={_h0},"
                  f"proj={_proj}]"] = (_kind, _sl, _rev, _h0, _proj)


@pytest.mark.parametrize("case", sorted(RNN_CASES))
def test_rnn_forward_and_gradients_match_the_reference(case):
    kind, sl, rev, h0, proj = RNN_CASES[case]
    r = _rng(case)
    ins = rnn_ins(r, kind, seq_len=sl, h0=h0, projected=proj)
    attrs = {"is_reverse": rev}
    check_op(kind, ins, attrs, case, RNN_TOL)
    vjp_both(kind, ins, attrs, r, 2e-5)


def test_padded_steps_keep_the_frozen_state():
    """Out at a position past a row's length is that row's frozen h (not
    0), in both packages; a row of length 0 keeps H0 throughout."""
    r = _rng("frozen")
    ins = rnn_ins(r, "lstm", seq_len=True, h0=True)
    out = run_port("lstm", ins, {})
    o, last_h = out["Out"][0].numpy(), out["LastH"][0].numpy()
    np.testing.assert_array_equal(o[1, 2:], np.broadcast_to(o[1, 1], (3, H)))
    np.testing.assert_array_equal(o[2], np.broadcast_to(ins["H0"][0][2],
                                                        (S, H)))
    np.testing.assert_array_equal(last_h[1], o[1, 1])


SEQ_CASES = {c: f for c, f in CASES.items()
             if c.startswith("sequence_")}
BEAM_CASES = {c: f for c, f in CASES.items()
              if c.split("[")[0] in ("beam_search", "gather_tree",
                                     "beam_search_decode")}


@pytest.mark.parametrize("case", sorted(SEQ_CASES))
def test_sequence_op_matches_the_reference(case):
    check_op(case.split("[")[0], *SEQ_CASES[case](_rng(case)), case,
             SEQ_TOL)


SEQ_GRAD_CASES = {
    "sequence_pad": lambda r: ({"X": [_u(r, (6, 3))], "Lod": [lod(2, 0, 4)]},
                               {"padded_length": 5}),
    "sequence_pool[SUM]": lambda r: ({"X": [_u(r, (7, 2))],
                                      "Lod": [lod(3, 0, 4)]},
                                     {"pooltype": "SUM"}),
    "sequence_pool[SQRT]": lambda r: ({"X": [_u(r, (7, 2))],
                                       "Lod": [lod(3, 4)]},
                                      {"pooltype": "SQRT"}),
    "sequence_pool[MAX]": lambda r: ({"X": [_u(r, (7, 2))],
                                      "Lod": [lod(3, 4)]},
                                     {"pooltype": "MAX"}),
    "sequence_softmax": lambda r: ({"X": [_u(r, (7,))],
                                    "Lod": [lod(3, 1, 3)]}, {}),
    "sequence_reverse": lambda r: ({"X": [_u(r, (7, 2))],
                                    "Lod": [lod(3, 4)]}, {}),
    "sequence_conv": lambda r: ({"X": [_u(r, (2, 5, 3))],
                                 "Filter": [_u(r, (9, 4))]},
                                {"contextStart": -1, "contextLength": 3}),
    "sequence_slice": lambda r: ({"X": [_u(r, (2, 5, 3))],
                                  "Offset": [np.array([0, 1], np.int32)],
                                  "Length": [np.array([3, 2], np.int32)]},
                                 {"max_length": 3}),
    "sequence_scatter": lambda r: ({"X": [_u(r, (2, 4))],
                                    "Ids": [np.array([[0, 0], [2, 3]],
                                                     np.int32)],
                                    "Updates": [_u(r, (2, 2))]}, {}),
    "sequence_topk_avg_pooling": lambda r: (
        {"X": [_u(r, (2, 3, 4, 6))], "ROW": [np.array([4, 2], np.int32)],
         "COLUMN": [np.array([6, 3], np.int32)]}, {"topks": [1, 3]}),
}


@pytest.mark.parametrize("case", sorted(SEQ_GRAD_CASES))
def test_sequence_gradient_matches_the_reference(case):
    op = case.split("[")[0]
    r = _rng(case)
    ins, attrs = SEQ_GRAD_CASES[case](r)
    vjp_both(op, ins, attrs, r, 2e-5)


@pytest.mark.parametrize("case", sorted(BEAM_CASES))
def test_beam_search_op_matches_the_reference(case):
    check_op(case.split("[")[0], *BEAM_CASES[case](_rng(case)), case,
             BEAM_TOL)


def _json(prog):
    return json.loads(json.dumps(prog.to_dict()))


def _both(build):
    """Build one program in each package with ``build(pkg, layers)``."""
    out = []
    for pkg, names, lyr in ((pt, jax_names, pt.layers),
                            (ptt, pt_names, players)):
        main, startup = pkg.Program(), pkg.Program()
        with names.guard(), pkg.program_guard(main, startup):
            build(lyr)
        out.append((_json(main), _json(startup)))
    return out


def _rnn_layers(L):
    x = L.static_data("x", [2, 5, 4])
    ln = L.static_data("ln", [2], "int32")
    h, last_h, last_c = L.lstm_unit_layer(x, 6, seq_length=ln,
                                          is_reverse=True, name="enc")
    g, gh = L.gru_layer(h, 3, h0=L.fill_constant([2, 3], "float32", 0.5))
    pre = L.fc(x, 24, num_flatten_dims=2)
    dl, dc = L.dynamic_lstm(pre, 24, sequence_length=ln)
    dg = L.dynamic_gru(L.fc(x, 9, num_flatten_dims=2), 3, is_reverse=True)
    L.lstm(x, L.create_parameter([4, 24], "float32", name="wx"),
           L.create_parameter([6, 24], "float32", name="wh"))
    mask = L.sequence_mask(ln, maxlen=5, dtype="float32")
    flat = L.static_data("flat", [7, 3])
    lod = L.static_data("lod", [3], "int32")
    L.sequence_pool(flat, "max", lod=lod)
    L.sequence_pad(flat, lod, padded_length=4)
    L.sequence_softmax(L.static_data("f1", [7]), lod)
    L.sequence_reverse(flat, lod)
    L.sequence_expand(L.static_data("e", [2, 3]), lod, out_rows=7)
    L.sequence_concat([g, dg])
    L.sequence_conv(h, L.create_parameter([18, 2], "float32", name="cf"),
                    contextStart=-1, contextLength=3)
    L.sequence_enumerate(L.static_data("ids", [2, 5], "int64"), win_size=2)
    L.sequence_reshape(h, new_dim=3)
    L.sequence_slice(h, L.static_data("off", [2], "int32"), ln)
    L.sequence_unpad(h, ln)
    L.sequence_scatter(mask, L.static_data("sid", [2, 2], "int32"),
                       L.static_data("su", [2, 2]))
    L.sequence_expand_as(last_h, None, ln, max_len=5)
    ids = L.static_data("bids", [4, 1], "int64")
    sc = L.static_data("bsc", [4, 1])
    L.beam_search(ids, sc, L.static_data("probs", [4, 6]), beam_size=2,
                  end_id=1)
    tid = L.static_data("tid", [3, 2, 2], "int64")
    L.gather_tree(tid, tid)
    L.beam_search_decode(tid, L.static_data("fs", [2, 2]), tid)
    return dl, dc, last_c


def test_rnn_and_sequence_layers_build_the_reference_program():
    (jm, js), (pm, ps) = _both(_rnn_layers)
    assert pm == jm and ps == js
