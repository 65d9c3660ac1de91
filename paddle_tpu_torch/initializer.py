"""Parameter initializers: each appends a creation op (fill_constant,
uniform_random, gaussian_random, truncated_gaussian_random, assign_value)
to the var's startup block (port of ``paddle_tpu/initializer.py``:
Constant, Uniform, Normal, TruncatedNormal, Xavier, MSRA,
Bilinear :118, NumpyArrayInitializer :147 and the two defaults).
"""

from __future__ import annotations

import math

import numpy as np

from .core.types import dtype_name


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, var, block):
        block.append_op("fill_constant", {}, {"Out": [var.name]},
                        {"shape": list(var.shape), "value": float(self.value),
                         "dtype": dtype_name(var.dtype)})


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0, seed: int = 0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op("uniform_random", {}, {"Out": [var.name]},
                        {"shape": list(var.shape), "min": self.low,
                         "max": self.high,
                         "seed": self.seed or block.program.next_op_seed(),
                         "dtype": dtype_name(var.dtype)})


class Normal(Initializer):
    def __init__(self, loc: float = 0.0, scale: float = 1.0, seed: int = 0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op("gaussian_random", {}, {"Out": [var.name]},
                        {"shape": list(var.shape), "mean": self.loc,
                         "std": self.scale,
                         "seed": self.seed or block.program.next_op_seed(),
                         "dtype": dtype_name(var.dtype)})


class TruncatedNormal(Initializer):
    def __init__(self, loc: float = 0.0, scale: float = 1.0, seed: int = 0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op("truncated_gaussian_random", {}, {"Out": [var.name]},
                        {"shape": list(var.shape), "mean": self.loc,
                         "std": self.scale,
                         "seed": self.seed or block.program.next_op_seed(),
                         "dtype": dtype_name(var.dtype)})


def _fan_in_out(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))   # conv filters are OIHW
    return shape[1] * receptive, shape[0] * receptive


class Xavier(Initializer):
    """Glorot initializer (reference: initializer.py XavierInitializer)."""

    def __init__(self, uniform: bool = True, fan_in=None, fan_out=None,
                 seed: int = 0):
        self.uniform, self.fan_in, self.fan_out, self.seed = \
            uniform, fan_in, fan_out, seed

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var.shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            Uniform(-limit, limit, self.seed)(var, block)
        else:
            Normal(0.0, math.sqrt(2.0 / (fi + fo)), self.seed)(var, block)


class MSRA(Initializer):
    """Kaiming/He initializer (reference: initializer.py
    MSRAInitializer), the conv2d default: Uniform(+-sqrt(6 / fan_in)) or
    Normal(0, sqrt(2 / fan_in))."""

    def __init__(self, uniform: bool = True, fan_in=None, seed: int = 0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fi = self.fan_in or _fan_in_out(var.shape)[0]
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            Uniform(-limit, limit, self.seed)(var, block)
        else:
            Normal(0.0, math.sqrt(2.0 / fi), self.seed)(var, block)


class Bilinear(Initializer):
    """The bilinear upsampling kernel for a transposed-conv weight
    [C_out, C_in, H, W] (reference: initializer.py Bilinear :118): every
    channel pair gets the separable (1 - |x/f - c|)(1 - |y/f - c|); the
    [H, W] kernel is one ``assign_value`` broadcast by ``broadcast_to``."""

    def __call__(self, var, block):
        shape = var.shape
        if len(shape) != 4:
            raise ValueError(
                f"Bilinear initializer needs a 4-D conv weight, got "
                f"shape {tuple(shape)}")
        h, w = int(shape[2]), int(shape[3])
        f = math.ceil(w / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        kernel = ((1 - np.abs(xx / f - c)) * (1 - np.abs(yy / f - c))
                  ).astype(dtype_name(var.dtype))
        tmp = block.create_var(name=f"{var.name}@bilinear_kernel",
                               shape=(1, 1, h, w), dtype=str(kernel.dtype))
        NumpyArrayInitializer(kernel.reshape(1, 1, h, w))(tmp, block)
        block.append_op("broadcast_to", {"X": [tmp.name]},
                        {"Out": [var.name]},
                        {"shape": [int(d) for d in shape]})


class NumpyArrayInitializer(Initializer):
    """The var takes the given array's values: one ``assign_value`` op
    holding them as a flat list."""

    def __init__(self, value: np.ndarray):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        block.append_op("assign_value", {}, {"Out": [var.name]},
                        {"shape": list(self.value.shape),
                         "values": self.value.flatten().tolist(),
                         "dtype": str(self.value.dtype)})


def _default_weight_initializer():
    return Xavier()


def _default_bias_initializer():
    return Constant(0.0)
