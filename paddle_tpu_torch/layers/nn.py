"""Op-emitting layer functions — the subset of ``paddle_tpu/layers/nn.py``
the decoder LM's, the BERT/ERNIE pre-training, the ResNet classifier, the
LeNet and the WMT Transformer programs are built from.
Each function creates output vars and appends ops with the same types,
slots and attrs as the reference, so the two packages build the same
program."""

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
           "cross_entropy", "softmax_with_cross_entropy", "topk", "mean",
           "relu", "tanh", "sigmoid", "gelu", "sqrt", "square", "clip",
           "elementwise_add", "elementwise_mul", "elementwise_div",
           "elementwise_max", "reduce_sum", "reduce_mean",
           "matmul", "mul",
           "reshape", "transpose", "squeeze", "unsqueeze", "slice", "gather",
           "scale", "fill_constant", "take_along_axis", "flash_attention",
           "conv2d", "pool2d", "batch_norm", "accuracy", "softmax", "cast",
           "one_hot", "label_smooth", "concat"]


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


def static_data(name: str, shape: Sequence[int],
                dtype="float32") -> Variable:
    """paddle.static.data — a var fed at run time, shape given in full
    (may contain -1)."""
    return default_main_program().global_block().create_var(
        name=name, shape=list(shape), dtype=dtype, stop_gradient=True)


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
tanh = _unary("tanh")
sigmoid = _unary("sigmoid")
sqrt = _unary("sqrt")
square = _unary("square")


def gelu(x: Variable, approximate: bool = False, name=None) -> Variable:
    helper = LayerHelper("gelu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("gelu", {"X": [x]}, {"Out": [out]},
                     {"approximate": approximate})
    return out


def reduce_sum(input: Variable, dim=None, keep_dim: bool = False,
               name=None) -> Variable:
    helper = LayerHelper("reduce_sum", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if dim is not None and not isinstance(dim, (list, tuple)):
        dim = [dim]
    helper.append_op("reduce_sum", {"X": [input]}, {"Out": [out]},
                     {"dim": dim, "keep_dim": keep_dim,
                      "reduce_all": dim is None})
    return out


def reduce_mean(input: Variable, dim=None, keep_dim: bool = False,
                name=None) -> Variable:
    helper = LayerHelper("reduce_mean", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if dim is not None and not isinstance(dim, (list, tuple)):
        dim = [dim]
    helper.append_op("reduce_mean", {"X": [input]}, {"Out": [out]},
                     {"dim": dim, "keep_dim": keep_dim,
                      "reduce_all": dim is None})
    return out


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


def reshape(x: Variable, shape, name=None) -> Variable:
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
          bias_after_scale: bool = True, name=None) -> Variable:
    helper = LayerHelper("scale", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("scale", {"X": [x]}, {"Out": [out]},
                     {"scale": scale, "bias": bias,
                      "bias_after_scale": bias_after_scale})
    return out


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
        if op_type == "elementwise_div":
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
elementwise_mul = _binary("elementwise_mul")
elementwise_div = _binary("elementwise_div")
elementwise_max = _binary("elementwise_max")


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
