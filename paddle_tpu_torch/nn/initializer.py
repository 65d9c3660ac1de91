"""paddle.nn.initializer: the 2.0 initializer names over the fluid
initializers (port of ``paddle_tpu/nn/initializer.py``)."""

from __future__ import annotations

from ..initializer import (Bilinear, Constant,  # noqa: F401
                           NumpyArrayInitializer, Uniform, Xavier, MSRA)
from ..initializer import Normal as _FluidNormal
from ..initializer import TruncatedNormal as _FluidTruncatedNormal

Assign = NumpyArrayInitializer


class Normal(_FluidNormal):
    """2.0 signature (reference nn/initializer/normal.py): mean/std."""

    def __init__(self, mean=0.0, std=1.0, name=None):
        super().__init__(loc=mean, scale=std)


class TruncatedNormal(_FluidTruncatedNormal):
    def __init__(self, mean=0.0, std=1.0, name=None):
        super().__init__(loc=mean, scale=std)


class XavierNormal(Xavier):
    """reference: nn/initializer/xavier.py XavierNormal."""

    def __init__(self, fan_in=None, fan_out=None, name=None):
        super().__init__(uniform=False, fan_in=fan_in, fan_out=fan_out)


class XavierUniform(Xavier):
    def __init__(self, fan_in=None, fan_out=None, name=None):
        super().__init__(uniform=True, fan_in=fan_in, fan_out=fan_out)


class KaimingNormal(MSRA):
    """reference: nn/initializer/kaiming.py KaimingNormal."""

    def __init__(self, fan_in=None, name=None):
        super().__init__(uniform=False, fan_in=fan_in)


class KaimingUniform(MSRA):
    def __init__(self, fan_in=None, name=None):
        super().__init__(uniform=True, fan_in=fan_in)


__all__ = ["Assign", "Bilinear", "Constant", "KaimingNormal",
           "KaimingUniform", "Normal", "NumpyArrayInitializer",
           "TruncatedNormal", "Uniform", "XavierNormal", "XavierUniform"]
