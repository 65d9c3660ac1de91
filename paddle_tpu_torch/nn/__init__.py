"""paddle.nn: the 2.0 Layer classes.

The port of ``paddle_tpu/nn/__init__.py``: Linear, the convolutions,
the norm layers, Embedding, Dropout, the activation classes (:735-765),
pooling, the containers, the losses, the RNN layers and cells, and
``MultiHeadAttention`` / ``TransformerEncoder`` (:628-730), on the
dygraph ``Layer`` base. Their bodies are ``nn.functional`` calls, so a
Layer runs eagerly under a dygraph guard and builds a Program inside
``program_guard``.

``MultiHeadAttention`` runs the ``flash_attention`` op in the [B,H,S,D]
layout; under autograd its lowering runs the bnsd forward and backward
kernels through ``FlashAttentionFunction``. Its ``attn_mask`` reaches
the kernel as a key bias when it is [B,1,1,S] or [B,S]; any other mask
takes the op's plain general route.
"""

from __future__ import annotations

import collections
from typing import Optional, Sequence

import numpy as np

from ..clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                    ClipGradByValue)
from ..dygraph.layers import Layer
from ..initializer import Constant, Normal, Uniform, Xavier
from . import functional
from . import functional as F
from . import initializer

__all__ = [
    "Layer", "Linear", "Conv2D", "Conv2DTranspose", "Embedding", "Dropout",
    "BatchNorm", "BatchNorm1D", "BatchNorm2D", "SyncBatchNorm", "LayerNorm",
    "GroupNorm", "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
    "ReLU", "GELU", "Sigmoid", "Tanh", "Softmax", "LeakyReLU", "Hardswish",
    "Silu", "MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D", "AdaptiveMaxPool2D",
    "Flatten", "Pad2D", "Sequential", "LayerList", "ParameterList",
    "CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCEWithLogitsLoss",
    "SmoothL1Loss", "KLDivLoss", "Upsample", "functional",
    "InstanceNorm2D", "LSTM", "GRU", "MultiHeadAttention",
    "TransformerEncoderLayer", "TransformerEncoder",
]


def _ntuple(v, n=2):
    return (v,) * n if isinstance(v, int) else tuple(v)


class Linear(Layer):
    """y = xW + b (reference: python/paddle/nn/layer/common.py Linear;
    fluid dygraph/nn.py Linear)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=Xavier())
        self.bias = self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Conv2D(Layer):
    """NCHW conv (reference: nn/layer/conv.py Conv2D; filter OIHW)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__()
        k = _ntuple(kernel_size)
        self._stride, self._padding, self._dilation = stride, padding, dilation
        self._groups = groups
        self._padding_mode = padding_mode
        self._data_format = data_format
        fan_in = in_channels * k[0] * k[1]
        bound = 1.0 / np.sqrt(fan_in)
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, k[0], k[1]], attr=weight_attr,
            default_initializer=Normal(0.0, np.sqrt(2.0 / fan_in)))
        self.bias = self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=Uniform(-bound, bound)
            if bias_attr is None else None)

    def forward(self, x):
        padding = self._padding
        if self._padding_mode != "zeros":
            # non-zero padding modes: explicit pad2d first, then a VALID conv
            p = _ntuple(self._padding)
            x = F.pad(x, [p[0], p[0], p[1], p[1]], mode=self._padding_mode,
                      data_format=self._data_format)
            padding = 0
        return F.conv2d(x, self.weight, self.bias, stride=self._stride,
                        padding=padding, dilation=self._dilation,
                        groups=self._groups, data_format=self._data_format)


class Conv2DTranspose(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__()
        k = _ntuple(kernel_size)
        self._stride, self._padding, self._dilation = stride, padding, dilation
        self._groups = groups
        self.weight = self.create_parameter(
            [in_channels, out_channels // groups, k[0], k[1]], attr=weight_attr,
            default_initializer=Xavier())
        self.bias = self.create_parameter([out_channels], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return F.conv2d_transpose(x, self.weight, self.bias,
                                  stride=self._stride, padding=self._padding,
                                  dilation=self._dilation, groups=self._groups)


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=Normal(0.0, 1.0 / np.sqrt(embedding_dim)))

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)


class Dropout(Layer):
    def __init__(self, p=0.5, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training, mode=self.mode)


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._momentum, self._epsilon = momentum, epsilon
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr, default_initializer=Constant(1.0))
        self.bias = self.create_parameter([num_features], attr=bias_attr,
                                          is_bias=True)
        self.register_buffer("_mean", np.zeros([num_features], np.float32))
        self.register_buffer("_variance", np.ones([num_features], np.float32))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format)


class BatchNorm(_BatchNormBase):
    """fluid dygraph/nn.py BatchNorm signature (num_channels first)."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 is_test=False, **kw):
        kw.pop("dtype", None)
        super().__init__(num_channels, momentum=momentum, epsilon=epsilon, **kw)
        self._act = act

    def forward(self, x):
        y = super().forward(x)
        if self._act:
            y = getattr(F, self._act)(y)
        return y


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """Cross-rank batch norm (reference: python/paddle/nn/layer/norm.py
    SyncBatchNorm) over the ``sync_batch_norm`` op: ``batch_norm`` at
    world size 1; the collective form is ROADMAP A8."""

    def forward(self, x):
        y = F.sync_batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format)
        # fluid-style BatchNorm(act=...) converted layers keep their act
        act = getattr(self, "_act", None)
        if act:
            y = getattr(F, act)(y)
        return y

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """Recursively replace BatchNorm* sublayers with SyncBatchNorm,
        reusing parameters and running-stat buffers (reference:
        python/paddle/nn/layer/norm.py convert_sync_batchnorm)."""
        if isinstance(layer, _BatchNormBase) and not isinstance(
                layer, SyncBatchNorm):
            out = cls.__new__(cls)
            Layer.__init__(out)
            out._momentum, out._epsilon = layer._momentum, layer._epsilon
            out._data_format = layer._data_format
            out._act = getattr(layer, "_act", None)
            # adopt params/buffers in place so optimizer state carries
            # over — alias the existing vars directly (register_buffer
            # would re-create them in static mode)
            out.weight, out.bias = layer.weight, layer.bias
            out._buffers["_mean"] = layer._mean
            out._buffers["_variance"] = layer._variance
            return out
        for name, sub in list(getattr(layer, "_sub_layers", {}).items()):
            layer._sub_layers[name] = cls.convert_sync_batchnorm(sub)
        return layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        n = int(np.prod(self._normalized_shape))
        self.weight = self.create_parameter([n], attr=weight_attr,
                                            default_initializer=Constant(1.0))
        self.bias = self.create_parameter([n], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self.weight = self.create_parameter([num_channels], attr=weight_attr,
                                            default_initializer=Constant(1.0))
        self.bias = self.create_parameter([num_channels], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self.weight, self.bias,
                            self._epsilon)


# -- activation layers --------------------------------------------------------

def _act_layer(name, fn_name, **defaults):
    class _Act(Layer):
        def __init__(self, **kw):
            super().__init__()
            self._kw = {**defaults, **kw}

        def forward(self, x):
            return getattr(F, fn_name)(x, **self._kw)

    _Act.__name__ = name
    return _Act


ReLU = _act_layer("ReLU", "relu")
GELU = _act_layer("GELU", "gelu")
Sigmoid = _act_layer("Sigmoid", "sigmoid")
Tanh = _act_layer("Tanh", "tanh")
Hardswish = _act_layer("Hardswish", "hardswish")
Silu = _act_layer("Silu", "silu")


class Softmax(Layer):
    def __init__(self, axis=-1):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.softmax(x, axis=self._axis)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01):
        super().__init__()
        self._slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self._slope)


# -- pooling / shape ----------------------------------------------------------

class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 name=None):
        super().__init__()
        self._k, self._s, self._p = kernel_size, stride, padding
        self._ceil = ceil_mode

    def forward(self, x):
        return F.max_pool2d(x, self._k, self._s, self._p, self._ceil)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, name=None):
        super().__init__()
        self._k, self._s, self._p = kernel_size, stride, padding
        self._ceil, self._excl = ceil_mode, exclusive

    def forward(self, x):
        return F.avg_pool2d(x, self._k, self._s, self._p, self._ceil,
                            self._excl)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self._size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self._size)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self._size = output_size

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self._size)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self._start, self._stop = start_axis, stop_axis

    def forward(self, x):
        shape = list(x.shape)
        stop = self._stop if self._stop >= 0 else len(shape) + self._stop
        n = int(np.prod(shape[self._start:stop + 1]))
        new_shape = shape[:self._start] + [n] + shape[stop + 1:]
        return x.reshape(new_shape)


class Pad2D(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW"):
        super().__init__()
        self._padding = padding if isinstance(padding, (list, tuple)) \
            else [padding] * 4
        self._mode, self._value, self._fmt = mode, value, data_format

    def forward(self, x):
        return F.pad(x, self._padding, self._mode, self._value, self._fmt)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, name=None):
        super().__init__()
        self._size, self._scale = size, scale_factor
        self._mode, self._align = mode, align_corners

    def forward(self, x):
        return F.interpolate(x, self._size, self._scale, self._mode,
                             self._align)


# -- containers ---------------------------------------------------------------

class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                layers[0] and isinstance(layers[0][0], (list, tuple)):
            layers = [(name, l) for name, l in layers[0]]
        for i, item in enumerate(layers):
            if isinstance(item, tuple):
                name, layer = item
            else:
                name, layer = str(i), item
            self.add_sublayer(name, layer)

    def forward(self, x):
        for layer in self._sub_layers.values():
            x = layer(x)
        return x

    def __getitem__(self, idx):
        return list(self._sub_layers.values())[idx]

    def __len__(self):
        return len(self._sub_layers)


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for i, l in enumerate(sublayers or []):
            self.add_sublayer(str(i), l)

    def append(self, layer):
        self.add_sublayer(str(len(self._sub_layers)), layer)
        return self

    def __getitem__(self, idx):
        return list(self._sub_layers.values())[idx]

    def __iter__(self):
        return iter(self._sub_layers.values())

    def __len__(self):
        return len(self._sub_layers)


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        for i, p in enumerate(parameters or []):
            self.add_parameter(str(i), p)

    def append(self, p):
        self.add_parameter(str(len(self._parameters)), p)
        return self

    def __getitem__(self, idx):
        return list(self._parameters.values())[idx]

    def __iter__(self):
        return iter(self._parameters.values())

    def __len__(self):
        return len(self._parameters)


# -- losses -------------------------------------------------------------------

class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, name=None):
        super().__init__()
        self._weight = weight
        self._ignore = ignore_index
        self._reduction = reduction
        self._soft = soft_label
        self._axis = axis

    def forward(self, input, label):
        return F.cross_entropy(input, label, weight=self._weight,
                               ignore_index=self._ignore,
                               reduction=self._reduction,
                               soft_label=self._soft, axis=self._axis)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self._reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self._reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self._weight = weight
        self._ignore = ignore_index
        self._reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, weight=self._weight,
                          ignore_index=self._ignore,
                          reduction=self._reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self._weight = weight
        self._pos_weight = pos_weight
        self._reduction = reduction

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, weight=self._weight, reduction=self._reduction,
            pos_weight=self._pos_weight)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self._reduction, self._delta = reduction, delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self._reduction, self._delta)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.kl_div(input, label, self._reduction)


class InstanceNorm2D(Layer):
    """reference: nn/layer/norm.py InstanceNorm2D (ops/extra_ops.py)."""

    def __init__(self, num_features, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self._eps = epsilon
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=Constant(1.0))
        self.bias = self.create_parameter([num_features], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        from .functional import _op

        return _op("instance_norm",
                   {"X": [x], "Scale": [self.weight], "Bias": [self.bias]},
                   {"epsilon": self._eps}, out_slot="Y")


class _RNNBase(Layer):
    def __init__(self, op_type, input_size, hidden_size, gate_mult,
                 weight_attr=None, bias_attr=None, is_reverse=False):
        super().__init__()
        self._op_type = op_type
        self.hidden_size = hidden_size
        self._is_reverse = is_reverse
        self.weight_x = self.create_parameter(
            [input_size, gate_mult * hidden_size], attr=weight_attr,
            default_initializer=Xavier())
        self.weight_h = self.create_parameter(
            [hidden_size, gate_mult * hidden_size],
            default_initializer=Xavier())
        self.bias = self.create_parameter([gate_mult * hidden_size],
                                          attr=bias_attr, is_bias=True)


class LSTM(_RNNBase):
    """Padded-batch LSTM over [B,S,D] (reference: nn/layer/rnn.py LSTM;
    the lstm op, ops/rnn_ops.py). Returns (out, (h, c))."""

    def __init__(self, input_size, hidden_size, weight_attr=None,
                 bias_attr=None, is_reverse=False, name=None):
        super().__init__("lstm", input_size, hidden_size, 4, weight_attr,
                         bias_attr, is_reverse)

    def forward(self, x, states=None, sequence_length=None):
        from .functional import _op, _static_op
        from ..core.ir import in_dygraph_mode

        ins = {"Input": [x], "WeightX": [self.weight_x],
               "WeightH": [self.weight_h], "Bias": [self.bias]}
        if states is not None:
            ins["H0"], ins["C0"] = [states[0]], [states[1]]
        if sequence_length is not None:
            ins["SequenceLength"] = [sequence_length]
        attrs = {"is_reverse": self._is_reverse}
        if in_dygraph_mode():
            from ..dygraph.tracer import trace_op

            outs = trace_op("lstm", ins, attrs)
            return outs["Out"][0], (outs["LastH"][0], outs["LastC"][0])
        out, h, c = _static_op("lstm", ins, attrs,
                               out_slots=("Out", "LastH", "LastC"))
        return out, (h, c)


class GRU(_RNNBase):
    """Padded-batch GRU over [B,S,D] (reference: nn/layer/rnn.py GRU)."""

    def __init__(self, input_size, hidden_size, weight_attr=None,
                 bias_attr=None, is_reverse=False, name=None):
        super().__init__("gru", input_size, hidden_size, 3, weight_attr,
                         bias_attr, is_reverse)

    def forward(self, x, states=None, sequence_length=None):
        from .functional import _static_op
        from ..core.ir import in_dygraph_mode

        ins = {"Input": [x], "WeightX": [self.weight_x],
               "WeightH": [self.weight_h], "Bias": [self.bias]}
        if states is not None:
            ins["H0"] = [states]
        if sequence_length is not None:
            ins["SequenceLength"] = [sequence_length]
        attrs = {"is_reverse": self._is_reverse}
        if in_dygraph_mode():
            from ..dygraph.tracer import trace_op

            outs = trace_op("gru", ins, attrs)
            return outs["Out"][0], outs["LastH"][0]
        out, h = _static_op("gru", ins, attrs, out_slots=("Out", "LastH"))
        return out, h


class MultiHeadAttention(Layer):
    """reference: nn/layer/transformer.py MultiHeadAttention — projections
    and the flash_attention op (ops/attention_ops.py)."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(
                f"num_heads ({num_heads}) must divide embed_dim "
                f"({embed_dim})")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        # the flash kernel never materialises attention probabilities, so
        # dropout applies to the attention OUTPUT, as in the reference
        self.dropout = Dropout(dropout)

    def _split(self, t):
        # [B,S,E] -> [B,H,S,hd] through registered ops, so the same code
        # builds a program in static mode
        from .functional import _op

        b, s = t.shape[0], t.shape[1]
        r = _op("reshape2", {"X": [t]},
                {"shape": [b, s, self.num_heads, self.head_dim]})
        return _op("transpose2", {"X": [r]}, {"axis": [0, 2, 1, 3]})

    def forward(self, query, key=None, value=None, attn_mask=None,
                causal=False):
        from .functional import _op

        key = query if key is None else key
        value = key if value is None else value
        q = self._split(self.q_proj(query))
        k = self._split(self.k_proj(key))
        v = self._split(self.v_proj(value))
        ins = {"Q": [q], "K": [k], "V": [v]}
        if attn_mask is not None:
            ins["Bias"] = [attn_mask]
        ctx = _op("flash_attention", ins,
                  {"causal": causal, "scale": 1.0 / float(self.head_dim) ** 0.5})
        b, s = query.shape[0], query.shape[1]
        ctx = _op("transpose2", {"X": [ctx]}, {"axis": [0, 2, 1, 3]})
        ctx = _op("reshape2", {"X": [ctx]},
                  {"shape": [b, s, self.embed_dim]})
        return self.out_proj(self.dropout(ctx))


class TransformerEncoderLayer(Layer):
    """reference: nn/layer/transformer.py TransformerEncoderLayer —
    pre/post-LN self-attention + FFN block."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="gelu", normalize_before=False, name=None):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self._act = activation
        self._pre = normalize_before

    def forward(self, src, src_mask=None):
        act = getattr(F, self._act)
        x = src
        attn_in = self.norm1(x) if self._pre else x
        attn = self.dropout1(self.self_attn(attn_in, attn_mask=src_mask))
        x = x + attn
        if not self._pre:
            x = self.norm1(x)
        ffn_in = self.norm2(x) if self._pre else x
        ffn = self.dropout2(self.linear2(act(self.linear1(ffn_in))))
        x = x + ffn
        if not self._pre:
            x = self.norm2(x)
        return x


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer_fn, num_layers):
        """encoder_layer_fn: zero-arg factory (layers must not share
        parameters)."""
        super().__init__()
        self.layers = LayerList([encoder_layer_fn() for _ in range(num_layers)])

    def forward(self, src, src_mask=None):
        x = src
        for layer in self.layers:
            x = layer(x, src_mask=src_mask)
        return x


# -- activations, misc layers, losses, cells and aliases (reference:
# python/paddle/nn/__init__.py 2.0 export list) ------------------------------

def _act_class(fn_name, **defaults):
    """Layer class over a functional activation (reference
    nn/layer/activation.py pattern)."""

    class _Act(Layer):
        def __init__(self, **kw):
            super().__init__()
            merged = dict(defaults)
            merged.update({k: v for k, v in kw.items() if k != "name"})
            self._kw = merged

        def forward(self, x):
            return getattr(F, fn_name)(x, **self._kw)

    _Act.__name__ = fn_name
    return _Act


ELU = _act_class("elu")
Hardshrink = _act_class("hardshrink")
Hardsigmoid = _act_class("hardsigmoid")
Hardtanh = _act_class("hardtanh")
LogSigmoid = _act_class("log_sigmoid")
ReLU6 = _act_class("relu6")
SELU = _act_class("selu")
Softplus = _act_class("softplus")
Softshrink = _act_class("softshrink")
Softsign = _act_class("softsign")
Swish = _act_class("swish")
Tanhshrink = _act_class("tanhshrink")
ThresholdedReLU = _act_class("thresholded_relu")


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.log_softmax(x, axis=self._axis)


class PReLU(Layer):
    """reference: nn/layer/activation.py PReLU — learnable negative
    slope ('all' one scalar, or per-channel)."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=Constant(init))
        self._mode = "all" if num_parameters == 1 else "channel"

    def forward(self, x):
        return F.prelu(x, self.weight, mode=self._mode)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, name=None):
        super().__init__()
        self._r = int(upscale_factor)

    def forward(self, x):
        return F.pixel_shuffle(x, self._r)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self._axis, self._eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self._axis, eps=self._eps)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self._p, self._eps, self._keep = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self._p, self._eps, self._keep)


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0, name=None):
        super().__init__()
        self._kw = dict(size=size, alpha=alpha, beta=beta, k=k)

    def forward(self, x):
        return F.local_response_norm(x, **self._kw)


class Dropout2D(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training)


class Dropout3D(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training)


class Bilinear(Layer):
    """reference: nn/layer/common.py Bilinear over
    bilinear_tensor_product."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr)
        self.bias = self.create_parameter([1, out_features], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


# -- losses -------------------------------------------------------------------

class BCELoss(Layer):
    """reference: nn/layer/loss.py BCELoss over bce_loss_op."""

    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self._weight = weight
        self._reduction = reduction

    def forward(self, input, label):
        from ..nn.functional import _op

        out = _op("bce_loss", {"X": input, "Label": label}, {})
        if self._weight is not None:
            out = out * self._weight
        if self._reduction == "mean":
            return _op("reduce_mean", {"X": out}, {"reduce_all": True})
        if self._reduction == "sum":
            return _op("reduce_sum", {"X": out}, {"reduce_all": True})
        return out


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self._margin, self._reduction = margin, reduction

    def forward(self, input, other, label):
        from ..nn.functional import _op

        out = _op("margin_rank_loss", {"X1": input, "X2": other,
                                       "Label": label},
                  {"margin": float(self._margin)})
        if self._reduction == "mean":
            return _op("reduce_mean", {"X": out}, {"reduce_all": True})
        if self._reduction == "sum":
            return _op("reduce_sum", {"X": out}, {"reduce_all": True})
        return out


class CTCLoss(Layer):
    """reference: nn/layer/loss.py CTCLoss over warpctc_op
    (ops/extra_ops2.py)."""

    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self._blank, self._reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths):
        from ..nn.functional import _op

        out = _op("warpctc",
                  {"Logits": log_probs, "Label": labels,
                   "LogitsLength": input_lengths,
                   "LabelLength": label_lengths},
                  {"blank": int(self._blank)}, out_slot="Loss")
        if self._reduction == "mean":
            # reference ctc_loss: mean of per-sample loss / label_length
            ll = _op("cast", {"X": label_lengths},
                     {"out_dtype": "float32"})
            ll = _op("reshape2", {"X": ll}, {"shape": [-1, 1]})
            flat = _op("reshape2", {"X": out}, {"shape": [-1, 1]})
            return _op("reduce_mean", {"X": flat / ll},
                       {"reduce_all": True})
        if self._reduction == "sum":
            return _op("reduce_sum", {"X": out}, {"reduce_all": True})
        return out


# -- RNN cells (reference: nn/layer/rnn.py) ----------------------------------

class SimpleRNNCell(Layer):
    """h' = act(x W^T + h U^T + b_ih + b_hh)."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, name=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.weight_ih = self.create_parameter([input_size, hidden_size],
                                               attr=weight_ih_attr)
        self.weight_hh = self.create_parameter([hidden_size, hidden_size],
                                               attr=weight_hh_attr)
        self.bias_ih = self.create_parameter([hidden_size], is_bias=True)
        self.bias_hh = self.create_parameter([hidden_size], is_bias=True)
        self._act = activation

    def forward(self, inputs, states=None):
        from ..nn.functional import _op

        if states is None:
            states = _op("fill_constant_batch_size_like",
                         {"Input": inputs},
                         {"shape": [-1, self.hidden_size], "value": 0.0,
                          "dtype": str(inputs.dtype)})
        pre = F.linear(inputs, self.weight_ih, self.bias_ih) + \
            F.linear(states, self.weight_hh, self.bias_hh)
        h = getattr(F, self._act)(pre)
        return h, h


class LSTMCell(Layer):
    """One lstm_unit step (reference nn/layer/rnn.py LSTMCell; gate
    order i,f,c,o per math/lstm_compute)."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, name=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.weight_ih = self.create_parameter(
            [input_size, 4 * hidden_size], attr=weight_ih_attr)
        self.weight_hh = self.create_parameter(
            [hidden_size, 4 * hidden_size], attr=weight_hh_attr)
        self.bias = self.create_parameter([4 * hidden_size], is_bias=True)

    def forward(self, inputs, states=None):
        from ..nn.functional import _op

        if states is None:
            z = _op("fill_constant_batch_size_like", {"Input": inputs},
                    {"shape": [-1, self.hidden_size], "value": 0.0,
                     "dtype": str(inputs.dtype)})
            states = (z, z)
        h_prev, c_prev = states
        gates = F.linear(inputs, self.weight_ih, self.bias) + \
            F.linear(h_prev, self.weight_hh)
        from ..core.ir import in_dygraph_mode

        if in_dygraph_mode():
            from ..dygraph.tracer import trace_op

            outs = trace_op("lstm_unit", {"X": gates, "C_prev": c_prev},
                            {"forget_bias": 0.0})
            h, c = outs["H"][0], outs["C"][0]
        else:
            from ..nn.functional import _static_op

            h, c = _static_op("lstm_unit",
                              {"X": [gates], "C_prev": [c_prev]},
                              {"forget_bias": 0.0}, out_slots=("H", "C"))
        return h, (h, c)


class GRUCell(Layer):
    """One gru_unit step (reference nn/layer/rnn.py GRUCell)."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, name=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.weight_ih = self.create_parameter(
            [input_size, 3 * hidden_size], attr=weight_ih_attr)
        self.weight_hh = self.create_parameter(
            [hidden_size, 3 * hidden_size], attr=weight_hh_attr)
        self.bias = self.create_parameter([3 * hidden_size], is_bias=True)

    def forward(self, inputs, states=None):
        from ..core.ir import in_dygraph_mode
        from ..nn.functional import _op, _static_op

        if states is None:
            states = _op("fill_constant_batch_size_like",
                         {"Input": inputs},
                         {"shape": [-1, self.hidden_size], "value": 0.0,
                          "dtype": str(inputs.dtype)})
        xp = F.linear(inputs, self.weight_ih, self.bias)
        if in_dygraph_mode():
            from ..dygraph.tracer import trace_op

            outs = trace_op("gru_unit",
                            {"Input": [xp], "HiddenPrev": [states],
                             "Weight": [self.weight_hh], "Bias": [None]},
                            {})
            h = outs["Hidden"][0]
        else:
            h = _static_op("gru_unit",
                           {"Input": [xp], "HiddenPrev": [states],
                            "Weight": [self.weight_hh]},
                           {}, out_slots=("Hidden",))
        return h, h


# -- 2.0rc lowercase / naming aliases (reference exported both) --------------

Conv2d = Conv2D
ConvTranspose2d = Conv2DTranspose
BatchNorm1d = BatchNorm1D
BatchNorm2d = BatchNorm2D
InstanceNorm2d = InstanceNorm2D
MaxPool2d = MaxPool2D
AvgPool2d = AvgPool2D
AdaptiveAvgPool2d = AdaptiveAvgPool2D
AdaptiveMaxPool2d = AdaptiveMaxPool2D
Dropout2d = Dropout2D
Dropout3d = Dropout3D


class HSigmoidLoss(Layer):
    """reference: nn/layer/loss.py HSigmoidLoss over
    hierarchical_sigmoid_op."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.num_classes = num_classes
        self.weight = self.create_parameter(
            [num_classes - 1, feature_size], attr=weight_attr)
        self.bias = self.create_parameter([num_classes - 1, 1],
                                          attr=bias_attr, is_bias=True)

    def forward(self, input, label):
        from ..core.ir import in_dygraph_mode
        from ..nn.functional import _op, _static_op

        ins = {"X": [input], "W": [self.weight], "Bias": [self.bias],
               "Label": [label]}
        if in_dygraph_mode():
            from ..dygraph.tracer import trace_op

            ins = dict(ins, PathTable=[None], PathCode=[None])
            return trace_op("hierarchical_sigmoid", ins,
                            {"num_classes": self.num_classes})["Out"][0]
        return _static_op("hierarchical_sigmoid", ins,
                          {"num_classes": self.num_classes},
                          out_slots=("Out",))


class ZeroPad2d(Layer):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__()
        self._pad = Pad2D(padding, mode="constant", value=0.0,
                          data_format=data_format)

    def forward(self, x):
        return self._pad(x)


class ConstantPad2d(Layer):
    def __init__(self, padding, value=0.0, data_format="NCHW", name=None):
        super().__init__()
        self._pad = Pad2D(padding, mode="constant", value=value,
                          data_format=data_format)

    def forward(self, x):
        return self._pad(x)


class UpsamplingNearest2d(Layer):
    def __init__(self, size=None, scale_factor=None, name=None):
        super().__init__()
        self._up = Upsample(size=size, scale_factor=scale_factor,
                            mode="nearest")

    def forward(self, x):
        return self._up(x)


class UpsamplingBilinear2d(Layer):
    def __init__(self, size=None, scale_factor=None, name=None):
        super().__init__()
        self._up = Upsample(size=size, scale_factor=scale_factor,
                            mode="bilinear", align_corners=True)

    def forward(self, x):
        return self._up(x)


__all__ += [
    "ELU", "Hardshrink", "Hardsigmoid", "Hardtanh", "LogSigmoid",
    "LogSoftmax", "PReLU", "ReLU6", "SELU", "Softplus", "Softshrink",
    "Softsign", "Swish", "Tanhshrink", "ThresholdedReLU", "PixelShuffle",
    "CosineSimilarity", "PairwiseDistance", "LocalResponseNorm",
    "Dropout2D", "Dropout3D", "Bilinear", "BCELoss", "MarginRankingLoss",
    "CTCLoss", "HSigmoidLoss", "SimpleRNNCell", "LSTMCell", "GRUCell",
    "ZeroPad2d", "UpsamplingNearest2d", "UpsamplingBilinear2d",
]
