"""Op-emitting layer functions: the subset of ``paddle_tpu/layers/nn.py``
the ported programs are built from (the decoder LM, BERT/ERNIE
pre-training, ResNet, LeNet, the WMT Transformer, word2vec, seq2seq,
sentiment and VGG16), with every hand-written wrapper of the math,
tensor, RNN and sequence ops. Each function creates output vars and
appends ops with the same types, slots and attrs as the reference, so
the two packages build the same program."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..core import unique_name
from ..core.ir import Variable, default_main_program
from ..core.types import dtype_name
from ..initializer import MSRA, Constant, Xavier
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from ..parallel.api import set_logical_axes

__all__ = ["data", "static_data", "create_parameter", "create_global_var",
           "fc", "linear", "embedding", "layer_norm", "dropout",
           "cross_entropy", "softmax_with_cross_entropy",
           "sigmoid_cross_entropy_with_logits", "square_error_cost",
           "topk", "mean", "l2_normalize",
           "relu", "tanh", "sigmoid", "gelu", "sqrt", "square", "clip",
           "exp", "log", "rsqrt", "abs", "floor", "ceil", "round",
           "reciprocal", "softplus", "softsign", "silu", "swish", "cos",
           "erf", "sign", "logsigmoid", "leaky_relu", "log_softmax",
           "elementwise_add", "elementwise_sub", "elementwise_mul",
           "elementwise_div", "elementwise_pow", "elementwise_max",
           "elementwise_min", "elementwise_mod",
           "equal", "not_equal", "less_than", "greater_than",
           "reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
           "reduce_prod", "matmul", "mul",
           "reshape", "transpose", "squeeze", "unsqueeze", "slice", "gather",
           "split", "stack", "flatten", "expand", "where", "argmax",
           "zeros", "ones", "zeros_like", "ones_like",
           "scale", "fill_constant", "take_along_axis", "flash_attention",
           "conv2d", "conv2d_transpose", "pool2d", "batch_norm",
           "instance_norm", "cos_sim", "auc", "accuracy", "softmax", "cast",
           "one_hot", "label_smooth", "concat",
           "lstm_unit_layer", "gru_layer", "sequence_mask", "sequence_pool",
           "linear_chain_crf", "crf_decoding", "ctc_greedy_decoder",
           "edit_distance", "increment"]


def _pair(v):
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v, v]


def data(name: str, shape: Sequence[int], dtype="float32",
         append_batch_size: bool = True, lod_level: int = 0,
         stop_gradient: bool = True) -> Variable:
    """fluid.layers.data (reference ``paddle_tpu/layers/nn.py:30``): a var
    fed at run time; -1 is prepended as the batch dim when
    ``append_batch_size`` is set and the shape does not start with -1."""
    shape = list(shape)
    if append_batch_size and (not shape or shape[0] != -1):
        shape = [-1] + shape
    return default_main_program().global_block().create_var(
        name=name, shape=shape, dtype=dtype, stop_gradient=stop_gradient,
        lod_level=lod_level)


def static_data(name: str, shape: Sequence[int], dtype="float32",
                lod_level: int = 0) -> Variable:
    """paddle.static.data — a var fed at run time, shape given in full
    (may contain -1)."""
    return data(name, shape, dtype, append_batch_size=False,
                lod_level=lod_level)


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None):
    helper = LayerHelper("create_parameter", name=name)
    attr = attr or ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def create_global_var(shape, value, dtype, persistable=False, name=None):
    """A non-parameter var in the main program, filled with ``value`` by
    a fill_constant op in the startup program."""
    helper = LayerHelper("global_var", name=name)
    block = helper.main_program.global_block()
    var = block.create_var(name=name or unique_name.generate("global_var"),
                           shape=shape, dtype=dtype, persistable=persistable,
                           stop_gradient=True)
    sblock = helper.startup_program.global_block()
    sblock.create_var(name=var.name, shape=shape, dtype=dtype,
                      persistable=persistable, stop_gradient=True)
    sblock.append_op("fill_constant", {}, {"Out": [var.name]},
                     {"shape": list(shape), "value": float(value),
                      "dtype": dtype_name(dtype)})
    return var


def fc(input: Variable, size: int, num_flatten_dims: int = 1,
       param_attr=None, bias_attr=None, act: Optional[str] = None,
       name=None) -> Variable:
    """mul (flattening at num_flatten_dims) -> elementwise_add -> act."""
    helper = LayerHelper("fc", name=name)
    in_features = int(np.prod(input.shape[num_flatten_dims:]))
    w = helper.create_parameter(param_attr, [in_features, size], input.dtype)
    set_logical_axes(w, ("embed", "mlp"))
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("mul", {"X": [input], "Y": [w]}, {"Out": [out]},
                     {"x_num_col_dims": num_flatten_dims,
                      "y_num_col_dims": 1})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [size], input.dtype,
                                    is_bias=True)
        set_logical_axes(b, ("mlp",))
        pre_act = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op("elementwise_add", {"X": [out], "Y": [b]},
                         {"Out": [pre_act]}, {"axis": num_flatten_dims})
        out = pre_act
    return helper.append_activation(out, act)


def embedding(input: Variable, size, is_sparse: bool = False,
              padding_idx: Optional[int] = None, param_attr=None,
              dtype="float32", name=None) -> Variable:
    helper = LayerHelper("embedding", name=name)
    w = helper.create_parameter(param_attr, list(size), dtype,
                                default_initializer=Xavier())
    set_logical_axes(w, ("vocab", "embed"))
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("lookup_table_v2", {"W": [w], "Ids": [input]},
                     {"Out": [out]},
                     {"padding_idx": -1 if padding_idx is None
                      else padding_idx, "is_sparse": is_sparse})
    return out


def linear(x: Variable, weight: Variable, bias: Optional[Variable] = None,
           name=None) -> Variable:
    helper = LayerHelper("linear", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("matmul_v2", {"X": [x], "Y": [weight]}, {"Out": [out]},
                     {})
    if bias is not None:
        out2 = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op("elementwise_add", {"X": [out], "Y": [bias]},
                         {"Out": [out2]}, {"axis": -1})
        out = out2
    return out


def layer_norm(input: Variable, scale: bool = True, shift: bool = True,
               begin_norm_axis: int = 1, epsilon: float = 1e-5,
               param_attr=None, bias_attr=None, act=None,
               name=None) -> Variable:
    helper = LayerHelper("layer_norm", name=name)
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": [input]}
    if scale:
        inputs["Scale"] = [helper.create_parameter(
            param_attr, norm_shape, "float32",
            default_initializer=Constant(1.0))]
    if shift:
        inputs["Bias"] = [helper.create_parameter(
            bias_attr, norm_shape, "float32", is_bias=True)]
    y = helper.create_variable_for_type_inference(input.dtype)
    mean = helper.create_variable_for_type_inference("float32", True)
    var = helper.create_variable_for_type_inference("float32", True)
    helper.append_op("layer_norm", inputs,
                     {"Y": [y], "Mean": [mean], "Variance": [var]},
                     {"epsilon": epsilon, "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(y, act)


def dropout(x: Variable, dropout_prob: float, is_test: bool = False,
            seed: Optional[int] = None,
            dropout_implementation: str = "downgrade_in_infer",
            name=None) -> Variable:
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference("uint8", True)
    helper.append_op("dropout", {"X": [x]}, {"Out": [out], "Mask": [mask]},
                     {"dropout_prob": dropout_prob, "is_test": is_test,
                      "seed": seed or default_main_program().next_op_seed(),
                      "dropout_implementation": dropout_implementation})
    return out


def cross_entropy(input: Variable, label: Variable, soft_label: bool = False,
                  ignore_index: int = -100) -> Variable:
    """The cross_entropy op over probabilities ``input`` (reference
    ``paddle_tpu/layers/nn.py:280``)."""
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("cross_entropy", {"X": [input], "Label": [label]},
                     {"Y": [out]},
                     {"soft_label": soft_label, "ignore_index": ignore_index})
    return out


def softmax_with_cross_entropy(logits: Variable, label: Variable,
                               soft_label: bool = False,
                               ignore_index: int = -100, axis: int = -1,
                               return_softmax: bool = False):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax_out = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op("softmax_with_cross_entropy",
                     {"Logits": [logits], "Label": [label]},
                     {"Softmax": [softmax_out], "Loss": [loss]},
                     {"soft_label": soft_label, "ignore_index": ignore_index,
                      "axis": axis})
    if return_softmax:
        return loss, softmax_out
    return loss


def topk(input: Variable, k: int = 1):
    helper = LayerHelper("top_k")
    out = helper.create_variable_for_type_inference(input.dtype)
    idx = helper.create_variable_for_type_inference("int64")
    helper.append_op("top_k", {"X": [input]},
                     {"Out": [out], "Indices": [idx]}, {"k": k})
    return out, idx


def mean(x: Variable, name=None) -> Variable:
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("mean", {"X": [x]}, {"Out": [out]}, {})
    return out


def _unary(op_type):
    def fn(x: Variable, name=None) -> Variable:
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(op_type, {"X": [x]}, {"Out": [out]}, {})
        return out

    fn.__name__ = op_type
    fn.__doc__ = f"Emit a ``{op_type}`` op."
    return fn


relu = _unary("relu")
sigmoid = _unary("sigmoid")
tanh = _unary("tanh")
exp = _unary("exp")
log = _unary("log")
sqrt = _unary("sqrt")
rsqrt = _unary("rsqrt")
square = _unary("square")
abs = _unary("abs")
floor = _unary("floor")
ceil = _unary("ceil")
round = _unary("round")
reciprocal = _unary("reciprocal")
softplus = _unary("softplus")
softsign = _unary("softsign")
silu = _unary("silu")
swish = _unary("swish")
cos = _unary("cos")
erf = _unary("erf")
sign = _unary("sign")
logsigmoid = _unary("logsigmoid")


def gelu(x: Variable, approximate: bool = False, name=None) -> Variable:
    helper = LayerHelper("gelu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("gelu", {"X": [x]}, {"Out": [out]},
                     {"approximate": approximate})
    return out


def leaky_relu(x, alpha=0.02, name=None):
    helper = LayerHelper("leaky_relu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("leaky_relu", {"X": [x]}, {"Out": [out]},
                     {"alpha": alpha})
    return out


def log_softmax(input, axis=-1, name=None):
    helper = LayerHelper("log_softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("log_softmax", {"X": [input]}, {"Out": [out]},
                     {"axis": axis})
    return out


def _reduce_layer(op_type):
    def fn(input: Variable, dim=None, keep_dim: bool = False,
           name=None) -> Variable:
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(input.dtype)
        if dim is not None and not isinstance(dim, (list, tuple)):
            dim = [dim]
        helper.append_op(op_type, {"X": [input]}, {"Out": [out]},
                         {"dim": dim, "keep_dim": keep_dim,
                          "reduce_all": dim is None})
        return out

    fn.__name__ = op_type
    return fn


reduce_sum = _reduce_layer("reduce_sum")
reduce_mean = _reduce_layer("reduce_mean")
reduce_max = _reduce_layer("reduce_max")
reduce_min = _reduce_layer("reduce_min")
reduce_prod = _reduce_layer("reduce_prod")


def matmul(x: Variable, y: Variable, transpose_x: bool = False,
           transpose_y: bool = False, alpha: float = 1.0,
           name=None) -> Variable:
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("matmul", {"X": [x], "Y": [y]}, {"Out": [out]},
                     {"transpose_X": transpose_x, "transpose_Y": transpose_y,
                      "alpha": alpha})
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("mul", {"X": [x], "Y": [y]}, {"Out": [out]},
                     {"x_num_col_dims": x_num_col_dims,
                      "y_num_col_dims": y_num_col_dims})
    return out


def reshape(x: Variable, shape, actual_shape=None, inplace=False,
            name=None) -> Variable:
    helper = LayerHelper("reshape2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op("reshape2", {"X": [x]},
                     {"Out": [out], "XShape": [xshape]},
                     {"shape": list(shape)})
    return out


def transpose(x: Variable, perm, name=None) -> Variable:
    helper = LayerHelper("transpose2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op("transpose2", {"X": [x]},
                     {"Out": [out], "XShape": [xshape]}, {"axis": list(perm)})
    return out


def squeeze(input: Variable, axes, name=None) -> Variable:
    helper = LayerHelper("squeeze2", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op("squeeze2", {"X": [input]},
                     {"Out": [out], "XShape": [xshape]}, {"axes": axes})
    return out


def unsqueeze(input: Variable, axes, name=None) -> Variable:
    helper = LayerHelper("unsqueeze2", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op("unsqueeze2", {"X": [input]},
                     {"Out": [out], "XShape": [xshape]}, {"axes": axes})
    return out


def slice(input: Variable, axes, starts, ends, name=None) -> Variable:
    helper = LayerHelper("slice", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("slice", {"Input": [input]}, {"Out": [out]},
                     {"axes": list(axes), "starts": list(starts),
                      "ends": list(ends)})
    return out


def gather(input: Variable, index: Variable, name=None) -> Variable:
    helper = LayerHelper("gather", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("gather", {"X": [input], "Index": [index]},
                     {"Out": [out]}, {})
    return out


def scale(x: Variable, scale: float = 1.0, bias: float = 0.0,
          bias_after_scale: bool = True, act=None, name=None) -> Variable:
    helper = LayerHelper("scale", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("scale", {"X": [x]}, {"Out": [out]},
                     {"scale": scale, "bias": bias,
                      "bias_after_scale": bias_after_scale})
    return helper.append_activation(out, act)


def clip(x: Variable, min: float, max: float, name=None) -> Variable:
    helper = LayerHelper("clip", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("clip", {"X": [x]}, {"Out": [out]},
                     {"min": min, "max": max})
    return out


def fill_constant(shape, dtype, value, name=None, out=None) -> Variable:
    helper = LayerHelper("fill_constant", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op("fill_constant", {}, {"Out": [out]},
                     {"shape": list(shape), "value": float(value),
                      "dtype": dtype_name(dtype)})
    return out


def take_along_axis(input, index, axis, name=None):
    """Batched gather along ``axis`` with a broadcastable index (numpy
    semantics)."""
    helper = LayerHelper("take_along_axis", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("take_along_axis", {"Input": [input], "Index": [index]},
                     {"Result": [out]}, {"Axis": axis})
    return out


def _attn_dropout_attrs(attrs, dropout_rate, is_test, seed):
    """Build-time attrs of attention-probs dropout."""
    if dropout_rate and not is_test:
        attrs["dropout_prob"] = float(dropout_rate)
        attrs["seed"] = (default_main_program().next_op_seed()
                         if seed is None else int(seed))


def flash_attention(q, k, v, bias=None, causal=False, scale=None,
                    dropout_rate=0.0, is_test=False, seed=None, name=None,
                    num_heads=None):
    """Fused attention softmax(q k^T * scale + bias) v. q [B,H,Sq,D] and
    k/v [B,H,Sk,D]; or PACKED [B,S,n*hd] 3-D with num_heads set, the form
    the decoder LM's prefill and the BERT/ERNIE encoder emit, which feeds
    the projection outputs to the kernels with no head transposes in the
    program. bias optional, a key bias [B,1,1,Sk] or [B,Sk]. dropout_rate
    > 0 (and not is_test) applies attention-probs dropout with a
    per-step, position-keyed mask that the backward recomputes."""
    helper = LayerHelper("flash_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    # saved log-sum-exp: the grad op runs the backward kernel from the
    # saved forward instead of running the forward again
    lse = helper.create_variable_for_type_inference("float32")
    lse.stop_gradient = True
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if bias is not None:
        inputs["Bias"] = [bias]
    attrs = {"causal": causal}
    if len(q.shape or ()) == 3:
        if not num_heads:
            raise ValueError("packed (3-D) flash_attention needs num_heads")
        attrs["num_heads"] = int(num_heads)
        attrs["head_dim"] = int(q.shape[-1]) // int(num_heads)
    if scale is not None:
        attrs["scale"] = float(scale)
    _attn_dropout_attrs(attrs, dropout_rate, is_test, seed)
    helper.append_op("flash_attention", inputs,
                     {"Out": [out], "Lse": [lse]}, attrs)
    return out


def _to_var(value, ref: Variable) -> Variable:
    """Promote a Python scalar to a [1] fill_constant var of ref's dtype."""
    if isinstance(value, Variable):
        return value
    helper = LayerHelper("const")
    out = helper.create_variable_for_type_inference(ref.dtype, True)
    helper.append_op("fill_constant", {}, {"Out": [out]},
                     {"shape": [1], "value": float(value),
                      "dtype": dtype_name(ref.dtype)})
    return out


def _elementwise_binary(x, y, op_type, reverse=False):
    """``x + y`` and the like on Variables: one elementwise op, numpy
    trailing broadcast (axis -1)."""
    if not isinstance(x, Variable) and isinstance(y, Variable):
        x, y = y, x
        if op_type in ("elementwise_sub", "elementwise_div"):
            reverse = not reverse
    helper = LayerHelper(op_type)
    y = _to_var(y, x)
    if reverse:
        x, y = y, x
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(op_type, {"X": [x], "Y": [y]}, {"Out": [out]},
                     {"axis": -1})
    return out


def _binary(op_type):
    def fn(x: Variable, y: Variable, axis: int = -1, act=None,
           name=None) -> Variable:
        helper = LayerHelper(op_type, name=name)
        y = _to_var(y, x)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(op_type, {"X": [x], "Y": [y]}, {"Out": [out]},
                         {"axis": axis})
        return helper.append_activation(out, act)

    fn.__name__ = op_type
    return fn


elementwise_add = _binary("elementwise_add")
elementwise_sub = _binary("elementwise_sub")
elementwise_mul = _binary("elementwise_mul")
elementwise_div = _binary("elementwise_div")
elementwise_pow = _binary("elementwise_pow")
elementwise_max = _binary("elementwise_max")
elementwise_min = _binary("elementwise_min")
elementwise_mod = _binary("elementwise_mod")


def _compare(x, y, op_type):
    """A comparison of x with y (a Python scalar becomes a fill_constant
    of x's dtype): a bool var (reference ``layers/nn.py:479``)."""
    helper = LayerHelper(op_type)
    y = _to_var(y, x)
    out = helper.create_variable_for_type_inference("bool", True)
    helper.append_op(op_type, {"X": [x], "Y": [y]}, {"Out": [out]}, {})
    return out


def equal(x, y, name=None):
    return _compare(x, y, "equal")


def not_equal(x, y, name=None):
    return _compare(x, y, "not_equal")


def less_than(x, y, name=None):
    return _compare(x, y, "less_than")


def greater_than(x, y, name=None):
    return _compare(x, y, "greater_than")


def l2_normalize(x, axis=-1, epsilon=1e-12, name=None):
    sq = reduce_sum(elementwise_mul(x, x), dim=[axis], keep_dim=True)
    norm = sqrt(elementwise_max(sq, fill_constant([1], x.dtype, epsilon)))
    return elementwise_div(x, norm)


def conv2d(input: Variable, num_filters: int, filter_size, stride=1,
           padding=0, dilation=1, groups: int = 1, param_attr=None,
           bias_attr=None, act: Optional[str] = None, use_cudnn: bool = True,
           name=None, data_format: str = "NCHW") -> Variable:
    """NCHW conv with an OIHW filter (MSRA normal by default), then an
    optional bias on the channel axis and an activation."""
    helper = LayerHelper("conv2d", name=name)
    c_in = input.shape[1]
    fsize = _pair(filter_size)
    w = helper.create_parameter(
        param_attr, [num_filters, c_in // groups, fsize[0], fsize[1]],
        input.dtype, default_initializer=MSRA(uniform=False))
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("conv2d", {"Input": [input], "Filter": [w]},
                     {"Output": [out]},
                     {"strides": _pair(stride), "paddings": _pair(padding),
                      "dilations": _pair(dilation), "groups": groups,
                      "data_format": data_format})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters], input.dtype,
                                    is_bias=True)
        pre = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op("elementwise_add", {"X": [out], "Y": [b]},
                         {"Out": [pre]}, {"axis": 1})
        out = pre
    return helper.append_activation(out, act)


def conv2d_transpose(input: Variable, num_filters: int, filter_size,
                     stride=1, padding=0, dilation=1, groups: int = 1,
                     param_attr=None, bias_attr=None, act=None,
                     name=None) -> Variable:
    """A transposed NCHW conv with an [C_in, num_filters / groups, kh, kw]
    filter (Xavier by default), then an optional bias on the channel axis
    and an activation (reference ``paddle_tpu/layers/nn.py:156``)."""
    helper = LayerHelper("conv2d_transpose", name=name)
    c_in = input.shape[1]
    fsize = _pair(filter_size)
    w = helper.create_parameter(
        param_attr, [c_in, num_filters // groups, fsize[0], fsize[1]],
        input.dtype, default_initializer=Xavier())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("conv2d_transpose", {"Input": [input], "Filter": [w]},
                     {"Output": [out]},
                     {"strides": _pair(stride), "paddings": _pair(padding),
                      "dilations": _pair(dilation), "groups": groups})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters], input.dtype,
                                    is_bias=True)
        pre = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op("elementwise_add", {"X": [out], "Y": [b]},
                         {"Out": [pre]}, {"axis": 1})
        out = pre
    return helper.append_activation(out, act)


def pool2d(input: Variable, pool_size=2, pool_type: str = "max",
           pool_stride=None, pool_padding=0, global_pooling: bool = False,
           ceil_mode: bool = False, exclusive: bool = True,
           name=None) -> Variable:
    helper = LayerHelper("pool2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("pool2d", {"X": [input]}, {"Out": [out]},
                     {"ksize": _pair(pool_size), "pooling_type": pool_type,
                      "strides": _pair(pool_stride or pool_size),
                      "paddings": _pair(pool_padding),
                      "global_pooling": global_pooling,
                      "ceil_mode": ceil_mode, "exclusive": exclusive})
    return out


def batch_norm(input: Variable, act: Optional[str] = None,
               is_test: bool = False, momentum: float = 0.9,
               epsilon: float = 1e-5, param_attr=None, bias_attr=None,
               data_layout: str = "NCHW", name=None, moving_mean_name=None,
               moving_variance_name=None,
               use_global_stats: bool = False) -> Variable:
    """Scale (1) and bias (0) parameters, and the moving mean (0) and
    variance (1) as non-trainable parameters that the op names as both
    input and output."""
    helper = LayerHelper("batch_norm", name=name)
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(param_attr, [c], "float32",
                                    default_initializer=Constant(1.0))
    bias = helper.create_parameter(bias_attr, [c], "float32", is_bias=True)
    mean = helper.create_parameter(
        ParamAttr(name=moving_mean_name, initializer=Constant(0.0),
                  trainable=False), [c], "float32")
    variance = helper.create_parameter(
        ParamAttr(name=moving_variance_name, initializer=Constant(1.0),
                  trainable=False), [c], "float32")
    mean.stop_gradient = True
    variance.stop_gradient = True
    y = helper.create_variable_for_type_inference(input.dtype)
    saved_mean = helper.create_variable_for_type_inference("float32", True)
    saved_var = helper.create_variable_for_type_inference("float32", True)
    helper.append_op(
        "batch_norm",
        {"X": [input], "Scale": [scale], "Bias": [bias], "Mean": [mean],
         "Variance": [variance]},
        {"Y": [y], "MeanOut": [mean], "VarianceOut": [variance],
         "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        {"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
         "data_layout": data_layout, "use_global_stats": use_global_stats})
    return helper.append_activation(y, act)


def accuracy(input: Variable, label: Variable, k: int = 1) -> Variable:
    """top_k + accuracy: the share of rows whose label is among their k
    largest inputs."""
    helper = LayerHelper("accuracy")
    topk_out = helper.create_variable_for_type_inference(input.dtype, True)
    topk_idx = helper.create_variable_for_type_inference("int64", True)
    helper.append_op("top_k", {"X": [input]},
                     {"Out": [topk_out], "Indices": [topk_idx]}, {"k": k})
    acc = helper.create_variable_for_type_inference("float32", True)
    correct = helper.create_variable_for_type_inference("int32", True)
    total = helper.create_variable_for_type_inference("int32", True)
    helper.append_op("accuracy",
                     {"Out": [topk_out], "Indices": [topk_idx],
                      "Label": [label]},
                     {"Accuracy": [acc], "Correct": [correct],
                      "Total": [total]}, {})
    return acc


def softmax(input: Variable, axis: int = -1, use_cudnn: bool = False,
            name=None) -> Variable:
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("softmax", {"X": [input]}, {"Out": [out]},
                     {"axis": axis})
    return out


def concat(input: List[Variable], axis: int = 0, name=None) -> Variable:
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("concat", {"X": input}, {"Out": [out]}, {"axis": axis})
    return out


def cast(x: Variable, dtype) -> Variable:
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("cast", {"X": [x]}, {"Out": [out]},
                     {"out_dtype": dtype_name(dtype)})
    return out


def one_hot(input: Variable, depth: int, name=None) -> Variable:
    """float32 one-hot rows of ``depth`` (reference
    ``paddle_tpu/layers/nn.py:676``)."""
    helper = LayerHelper("one_hot", name=name)
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op("one_hot", {"X": [input]}, {"Out": [out]},
                     {"depth": depth})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """label * (1 - epsilon) + epsilon / classes (reference
    ``paddle_tpu/layers/nn.py:789``; the prior is uniform)."""
    helper = LayerHelper("label_smooth", name=name)
    out = helper.create_variable_for_type_inference(label.dtype)
    helper.append_op("label_smooth", {"X": [label]}, {"Out": [out]},
                     {"epsilon": epsilon})
    return out


def sigmoid_cross_entropy_with_logits(x, label, name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("sigmoid_cross_entropy_with_logits",
                     {"X": [x], "Label": [label]}, {"Out": [out]}, {})
    return out


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("square_error_cost", {"Input": [input], "Label": [label]},
                     {"Out": [out]}, {})
    return out


def split(input: Variable, num_or_sections, dim: int = -1, name=None):
    helper = LayerHelper("split", name=name)
    if isinstance(num_or_sections, int):
        n, sections = num_or_sections, None
    else:
        n, sections = len(num_or_sections), list(num_or_sections)
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(n)]
    helper.append_op("split", {"X": [input]}, {"Out": outs},
                     {"axis": dim, "num": 0 if sections else n,
                      "sections": sections or []})
    return outs


def stack(x: List[Variable], axis: int = 0, name=None) -> Variable:
    helper = LayerHelper("stack", name=name)
    out = helper.create_variable_for_type_inference(x[0].dtype)
    helper.append_op("stack", {"X": x}, {"Y": [out]}, {"axis": axis})
    return out


def flatten(x: Variable, axis: int = 1, name=None) -> Variable:
    helper = LayerHelper("flatten2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op("flatten2", {"X": [x]},
                     {"Out": [out], "XShape": [xshape]}, {"axis": axis})
    return out


def _getitem(var: Variable, idx):
    """``var[idx]`` as one slice op (reference ``layers/nn.py:628``): an
    int index takes one position and drops the axis, a slice its range
    (a step is not read), an Ellipsis anchors what follows to the
    trailing axes. None (a new axis) raises."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    ndim = len(var.shape or ())
    axis_of = []
    ell = next((k for k, s in enumerate(idx) if s is Ellipsis), None)
    for k in range(len(idx)):
        if ell is None or k < ell:
            axis_of.append(k)
        elif k == ell:
            axis_of.append(None)
        else:
            axis_of.append(ndim - (len(idx) - k))
    int_max = int(np.iinfo(np.int32).max)
    axes, starts, ends, decrease = [], [], [], []
    for k, s in enumerate(idx):
        i = axis_of[k]
        if s is Ellipsis:
            continue
        if isinstance(s, int):
            axes.append(i)
            starts.append(s)
            ends.append(s + 1 if s != -1 else int_max)
            decrease.append(i)
        elif s is None:
            raise NotImplementedError("newaxis indexing not supported yet")
        else:
            if s.start is None and s.stop is None:
                continue
            axes.append(i)
            starts.append(s.start or 0)
            ends.append(s.stop if s.stop is not None else int_max)
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(var.dtype)
    helper.append_op("slice", {"Input": [var]}, {"Out": [out]},
                     {"axes": axes, "starts": starts, "ends": ends,
                      "decrease_axis": decrease})
    return out


def zeros(shape, dtype="float32", name=None):
    return fill_constant(shape, dtype, 0.0, name=name)


def ones(shape, dtype="float32", name=None):
    return fill_constant(shape, dtype, 1.0, name=name)


def zeros_like(x, name=None):
    helper = LayerHelper("zeros_like", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("fill_zeros_like", {"X": [x]}, {"Out": [out]}, {})
    return out


def ones_like(x, name=None):
    helper = LayerHelper("ones_like", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("fill_any_like", {"X": [x]}, {"Out": [out]},
                     {"value": 1.0, "dtype": -1})
    return out


def expand(x: Variable, expand_times, name=None) -> Variable:
    helper = LayerHelper("expand", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("expand", {"X": [x]}, {"Out": [out]},
                     {"expand_times": list(expand_times)})
    return out


def where(condition, x, y, name=None):
    helper = LayerHelper("where", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("where", {"Condition": [condition], "X": [x], "Y": [y]},
                     {"Out": [out]}, {})
    return out


def argmax(x, axis=-1, name=None):
    helper = LayerHelper("arg_max", name=name)
    out = helper.create_variable_for_type_inference("int64", True)
    helper.append_op("arg_max", {"X": [x]}, {"Out": [out]}, {"axis": axis})
    return out


def lstm_unit_layer(input, hidden_size, param_attr=None, bias_attr=None,
                    h0=None, c0=None, is_reverse=False, seq_length=None,
                    name=None):
    """A padded LSTM over [B, S, D] (the reference's ``dynamic_lstm``
    with the LoD as an optional ``seq_length``; ``ops/rnn_ops.py``):
    (Out [B, S, H], LastH, LastC). The recurrent weight is named
    ``<name>_wh_<k>``."""
    helper = LayerHelper("lstm", name=name)
    d = int(input.shape[-1])
    wx = helper.create_parameter(param_attr or ParamAttr(),
                                 [d, 4 * hidden_size], input.dtype)
    wh = helper.create_parameter(
        ParamAttr(name=unique_name.generate((name or "lstm") + "_wh")),
        [hidden_size, 4 * hidden_size], input.dtype)
    b = helper.create_parameter(bias_attr or ParamAttr(), [4 * hidden_size],
                                input.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(input.dtype)
    last_h = helper.create_variable_for_type_inference(input.dtype)
    last_c = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"Input": [input], "WeightX": [wx], "WeightH": [wh], "Bias": [b]}
    if h0 is not None:
        inputs["H0"] = [h0]
    if c0 is not None:
        inputs["C0"] = [c0]
    if seq_length is not None:
        inputs["SequenceLength"] = [seq_length]
    helper.append_op("lstm", inputs,
                     {"Out": [out], "LastH": [last_h], "LastC": [last_c]},
                     {"is_reverse": is_reverse})
    return out, last_h, last_c


def gru_layer(input, hidden_size, param_attr=None, bias_attr=None, h0=None,
              is_reverse=False, seq_length=None, name=None):
    """A padded GRU over [B, S, D] (the reference's ``dynamic_gru``):
    (Out [B, S, H], LastH)."""
    helper = LayerHelper("gru", name=name)
    d = int(input.shape[-1])
    wx = helper.create_parameter(param_attr or ParamAttr(),
                                 [d, 3 * hidden_size], input.dtype)
    wh = helper.create_parameter(
        ParamAttr(name=unique_name.generate((name or "gru") + "_wh")),
        [hidden_size, 3 * hidden_size], input.dtype)
    b = helper.create_parameter(bias_attr or ParamAttr(), [3 * hidden_size],
                                input.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(input.dtype)
    last_h = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"Input": [input], "WeightX": [wx], "WeightH": [wh], "Bias": [b]}
    if h0 is not None:
        inputs["H0"] = [h0]
    if seq_length is not None:
        inputs["SequenceLength"] = [seq_length]
    helper.append_op("gru", inputs, {"Out": [out], "LastH": [last_h]},
                     {"is_reverse": is_reverse})
    return out, last_h


def sequence_mask(x, maxlen, dtype="int64", name=None):
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op("sequence_mask", {"X": [x]}, {"Y": [out]},
                     {"maxlen": int(maxlen), "out_dtype": dtype})
    return out


def sequence_pool(input, pool_type="sum", lod=None, name=None):
    """Pool a (flat values, offsets) pair per sequence; ``lod`` is the
    offsets tensor."""
    if lod is None:
        raise ValueError("sequence_pool requires lod= (the explicit "
                         "offsets tensor; see ops/sequence_ops.py)")
    helper = LayerHelper("sequence_pool", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    idx = helper.create_variable_for_type_inference("int32", True)
    helper.append_op("sequence_pool", {"X": [input], "Lod": [lod]},
                     {"Out": [out], "MaxIndex": [idx]},
                     {"pooltype": pool_type.upper()})
    return out


def linear_chain_crf(input, label, param_attr=None, length=None, name=None):
    """The CRF's negative log-likelihood [B, 1] of emissions ``input``
    [B, S, T] against ``label`` [B, S] (``length`` [B] optional); creates
    the [T + 2, T] transition parameter (rows 0 and 1 the start and stop
    weights)."""
    helper = LayerHelper("linear_chain_crf", name=name)
    t = int(input.shape[-1])
    trans = helper.create_parameter(param_attr or ParamAttr(),
                                    [t + 2, t], "float32")
    ll = helper.create_variable_for_type_inference("float32")
    alpha = helper.create_variable_for_type_inference("float32", True)
    ee = helper.create_variable_for_type_inference("float32", True)
    te = helper.create_variable_for_type_inference("float32", True)
    ins = {"Emission": [input], "Transition": [trans], "Label": [label]}
    if length is not None:
        ins["Length"] = [length]
    helper.append_op("linear_chain_crf", ins,
                     {"LogLikelihood": [ll], "Alpha": [alpha],
                      "EmissionExps": [ee], "TransitionExps": [te]}, {})
    return ll


def crf_decoding(input, param_attr, label=None, length=None, name=None):
    """The Viterbi path [B, S] int64 under the transition parameter that
    ``param_attr`` names, the one ``linear_chain_crf`` created (with
    ``label``: the 0/1 mask of where the path equals it)."""
    helper = LayerHelper("crf_decoding", name=name)
    t = int(input.shape[-1])
    trans = helper.create_parameter(param_attr, [t + 2, t], "float32")
    out = helper.create_variable_for_type_inference("int64", True)
    ins = {"Emission": [input], "Transition": [trans]}
    if label is not None:
        ins["Label"] = [label]
    if length is not None:
        ins["Length"] = [length]
    helper.append_op("crf_decoding", ins, {"ViterbiPath": [out]}, {})
    return out


def ctc_greedy_decoder(input, blank, input_length=None, padding_value=0,
                       name=None):
    """Greedy CTC decoding: ``arg_max`` over the last axis, then
    ``ctc_align`` (repeats merged, ``blank`` dropped). Returns (ids
    [B, S] left-packed, lengths [B, 1])."""
    helper = LayerHelper("ctc_greedy_decoder", name=name)
    am = helper.create_variable_for_type_inference("int64", True)
    helper.append_op("arg_max", {"X": [input]}, {"Out": [am]},
                     {"axis": -1, "keepdims": False})
    out = helper.create_variable_for_type_inference("int64", True)
    ln = helper.create_variable_for_type_inference("int32", True)
    ins = {"Input": [am]}
    if input_length is not None:
        ins["InputLength"] = [input_length]
    helper.append_op("ctc_align", ins,
                     {"Output": [out], "OutputLength": [ln]},
                     {"blank": int(blank),
                      "padding_value": int(padding_value)})
    return out, ln


def edit_distance(input, label, normalized=True, input_length=None,
                  label_length=None, name=None):
    """Levenshtein distance of each row of ``input`` to ``label``: returns
    (distance [B, 1] float32, the row count [1])."""
    helper = LayerHelper("edit_distance", name=name)
    out = helper.create_variable_for_type_inference("float32", True)
    sn = helper.create_variable_for_type_inference("int64", True)
    ins = {"Hyps": [input], "Refs": [label]}
    if input_length is not None:
        ins["HypsLength"] = [input_length]
    if label_length is not None:
        ins["RefsLength"] = [label_length]
    helper.append_op("edit_distance", ins,
                     {"Out": [out], "SequenceNum": [sn]},
                     {"normalized": bool(normalized)})
    return out, sn


def cos_sim(X, Y, name=None):
    """Row-wise cosine similarity of X and Y (the cos_sim op; its XNorm
    and YNorm are created and not returned)."""
    helper = LayerHelper("cos_sim", name=name)
    out = helper.create_variable_for_type_inference(X.dtype)
    xn = helper.create_variable_for_type_inference(X.dtype)
    yn = helper.create_variable_for_type_inference(X.dtype)
    helper.append_op("cos_sim", {"X": [X], "Y": [Y]},
                     {"Out": [out], "XNorm": [xn], "YNorm": [yn]}, {})
    return out


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    """Per-(N, C) normalisation with a [C] scale (ones) and bias."""
    helper = LayerHelper("instance_norm", name=name)
    c = int(input.shape[1])
    scale = helper.create_parameter(param_attr or ParamAttr(), [c],
                                    input.dtype,
                                    default_initializer=Constant(1.0))
    bias = helper.create_parameter(bias_attr or ParamAttr(), [c],
                                   input.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(input.dtype)
    sm = helper.create_variable_for_type_inference(input.dtype, True)
    sv = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op("instance_norm",
                     {"X": [input], "Scale": [scale], "Bias": [bias]},
                     {"Y": [out], "SavedMean": [sm], "SavedVariance": [sv]},
                     {"epsilon": epsilon})
    return out


def auc(input, label, num_thresholds=4095, name=None):
    """Streaming AUC: the auc op over two persistable float32 stat vars
    of num_thresholds + 1 buckets, zeroed by the startup program and
    updated in place each run. Returns (auc, [stat_pos, stat_neg])."""
    helper = LayerHelper("auc", name=name)
    pos = create_global_var([num_thresholds + 1], 0.0, "float32",
                            persistable=True,
                            name=unique_name.generate("auc_stat_pos"))
    neg = create_global_var([num_thresholds + 1], 0.0, "float32",
                            persistable=True,
                            name=unique_name.generate("auc_stat_neg"))
    out = helper.create_variable_for_type_inference("float32", True)
    helper.append_op("auc",
                     {"Predict": [input], "Label": [label],
                      "StatPos": [pos], "StatNeg": [neg]},
                     {"AUC": [out], "StatPosOut": [pos],
                      "StatNegOut": [neg]},
                     {"num_thresholds": num_thresholds})
    return out, [pos, neg]


def increment(x: Variable, value: float = 1.0, in_place: bool = True
              ) -> Variable:
    """x + value; with ``in_place`` the op writes the sum under x's name."""
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("increment", {"X": [x]}, {"Out": [out]}, {"step": value})
    return out
