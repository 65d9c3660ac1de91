"""The layers of paddle_tpu_torch that wrap the math, tensor, RNN,
sequence and beam-search ops, against paddle_tpu's: every such
``paddle_tpu.layers`` name exists in the port with the reference's
parameters (names, kinds and defaults); the generated table is the
reference's rows whose op types the port registers; a program built from
these layers (and from Variable's operators) serialises to the
reference's JSON, so the shapes and dtypes the port infers on meta
tensors are the reference's; and the three compositions that raise in
the reference raise alike."""

import json

import pytest

import paddle_tpu as pt
from paddle_tpu import layers as jl
from paddle_tpu.core import unique_name as jax_names
from paddle_tpu.layers import generated as jgen

import paddle_tpu_torch as ptt
from paddle_tpu_torch import layers as pl
from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.core import unique_name as pt_names
from paddle_tpu_torch.layers import generated as pgen


# every paddle_tpu.layers name that wraps a math, tensor, RNN, sequence or
# beam-search op type the port gained with them
LAYER_NAMES = (
    "exp", "log", "rsqrt", "abs", "floor", "ceil", "round", "reciprocal",
    "softplus", "softsign", "silu", "swish", "cos", "erf", "logsigmoid",
    "leaky_relu", "log_softmax", "elementwise_sub", "elementwise_pow",
    "elementwise_min", "elementwise_mod", "elementwise_floordiv", "equal",
    "not_equal", "less_than", "less_equal", "greater_than", "greater_equal",
    "logical_and", "logical_or", "logical_xor", "logical_not",
    "reduce_max", "reduce_min", "reduce_prod", "reduce_any", "reduce_all",
    "split", "stack", "unstack", "flatten", "zeros_like", "ones_like",
    "expand", "where", "argmax", "argmin", "argsort", "cumsum", "pow", "elu",
    "relu6", "hard_sigmoid", "hard_swish", "isfinite", "has_nan", "has_inf",
    "sigmoid_cross_entropy_with_logits", "square_error_cost", "huber_loss",
    "kldiv_loss", "smooth_l1", "dice_loss", "mean_iou", "npair_loss",
    "soft_relu", "gather_nd", "scatter", "shape", "array_length",
    "strided_slice", "range", "fill_constant_batch_size_like",
    "uniform_random", "gaussian_random", "lstm", "lstm_unit_layer",
    "gru_layer", "dynamic_lstm", "dynamic_gru", "sequence_mask",
    "sequence_pool", "sequence_first_step", "sequence_last_step",
    "sequence_concat", "sequence_conv", "sequence_enumerate",
    "sequence_expand", "sequence_expand_as", "sequence_pad",
    "sequence_reshape", "sequence_reverse", "sequence_scatter",
    "sequence_slice", "sequence_softmax", "sequence_unpad", "beam_search",
    "beam_search_decode", "gather_tree")


def _params(fn):
    import inspect

    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("name", LAYER_NAMES)
def test_layer_exists_with_the_reference_parameters(name):
    assert hasattr(pl, name), name
    assert _params(getattr(pl, name)) == _params(getattr(jl, name)), name


def test_generated_table_is_the_reference_rows_of_registered_ops():
    want = [tuple(map(lambda v: tuple(v) if isinstance(v, list) else v, row))
            for row in jgen._TABLE if pt_registry.lookup(row[1])]
    got = [tuple(map(lambda v: tuple(v) if isinstance(v, list) else v, row))
           for row in pgen.TABLE]
    assert got == want


def _math_layers(L):
    x = L.static_data("x", [4, 6])
    y = L.static_data("y", [4, 6])
    ids = L.static_data("ids", [4, 1], "int64")
    outs = [L.exp(x), L.log(x), L.round(x), L.softplus(x), L.swish(x),
            L.leaky_relu(x, 0.1), L.log_softmax(x, 0), L.erf(x),
            L.elementwise_sub(x, y), L.elementwise_pow(x, 2.0),
            L.elementwise_mod(x, y, axis=-1), L.elementwise_floordiv(x, y),
            L.equal(x, y), L.less_than(x, 0.5), L.greater_equal(x, y),
            L.logical_and(L.less_equal(x, y), L.not_equal(x, y)),
            L.logical_not(L.greater_than(x, y)),
            L.reduce_max(x, dim=1), L.reduce_prod(x, dim=[0, 1],
                                                  keep_dim=True),
            L.reduce_any(L.less_than(x, y), dim=[1]),
            L.where(L.less_than(x, y), x, y), L.argmax(x, axis=0),
            L.argmin(x), L.argmin(x, axis=1), L.argsort(x, descending=True),
            L.cumsum(x, axis=0), L.pow(x, 3), L.pow(x, y), L.elu(x, 0.5),
            L.relu6(x), L.hard_sigmoid(x), L.hard_swish(x), L.has_nan(x),
            L.has_inf(x), L.soft_relu(x), L.expand(x, [2, 1]),
            L.strided_slice(x, axes=[1], starts=[5], ends=[0], strides=[-2]),
            L.gather_nd(x, L.static_data("nd", [3, 2], "int32")),
            L.scatter(x, L.static_data("sid", [2], "int32"),
                      L.static_data("su", [2, 6])),
            L.shape(x), L.array_length(x), L.range(0, 10, 2, "int32"),
            L.fill_constant_batch_size_like(x, shape=[1, 3], value=2.0,
                                            dtype="float32"),
            L.huber_loss(x, y, delta=0.5), L.kldiv_loss(x, y),
            L.sigmoid_cross_entropy_with_logits(x, y),
            L.square_error_cost(x, y), L.smooth_l1(x, y),
            L.npair_loss(x, y, L.static_data("lab", [4], "int64")),
            L.stack([x, y], axis=1), L.flatten(L.stack([x, y]), axis=2),
            L.zeros_like(x), L.ones_like(ids), x[1:3, -1], -x, x @ L.transpose(
                y, [1, 0]), (x - 1.0) ** y, 2.0 - x, (x >= y).astype("int32")]
    outs += L.split(x, [2, 4], dim=1) + L.split(x, 2, dim=0)
    outs += list(L.mean_iou(L.argmax(x, axis=1), ids, 6))
    outs.append(L.unstack(x, axis=0))
    return outs


def test_math_and_tensor_layers_build_the_reference_program():
    got = []
    for pkg, names, lyr in ((pt, jax_names, pt.layers),
                            (ptt, pt_names, pl)):
        main, startup = pkg.Program(), pkg.Program()
        with names.guard(), pkg.program_guard(main, startup):
            _math_layers(lyr)
        got.append(json.loads(json.dumps(main.to_dict())))
    assert got[1] == got[0]


@pytest.mark.parametrize("name", ["dice_loss", "sequence_first_step",
                                  "sequence_last_step"])
def test_layers_that_raise_in_the_reference_raise_alike(name):
    """Three compositions of the reference raise TypeError whatever their
    input, and the port's copies do too: ``dice_loss`` calls ``range``,
    which its module rebinds to the range layer, and the sequence steps
    pass ``sequence_pool`` a ``length`` it does not take (ROADMAP queue
    C)."""
    for pkg, lyr in ((pt, pt.layers), (ptt, pl)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = lyr.static_data("x", [4, 3])
            with pytest.raises(TypeError):
                if name == "dice_loss":
                    lyr.dice_loss(x, lyr.static_data("l", [4, 1], "int64"))
                else:
                    getattr(lyr, name)(x)
