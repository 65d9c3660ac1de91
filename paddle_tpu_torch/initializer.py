"""Parameter initializers: each appends a creation op (fill_constant,
uniform_random, gaussian_random, truncated_gaussian_random) to the var's
startup block (port of ``paddle_tpu/initializer.py``: Constant, Uniform,
Normal, TruncatedNormal, Xavier and the two defaults).
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


def _default_weight_initializer():
    return Xavier()


def _default_bias_initializer():
    return Constant(0.0)
