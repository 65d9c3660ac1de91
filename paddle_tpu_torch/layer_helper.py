"""LayerHelper: shared machinery for op-emitting layer functions
(reference: python/paddle/fluid/layer_helper.py)."""

from __future__ import annotations

from typing import Optional

from .core import unique_name
from .core.ir import (Parameter, Variable, default_main_program,
                      default_startup_program)
from .initializer import Xavier, _default_bias_initializer
from .param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type: str, name: Optional[str] = None):
        self.name = name or unique_name.generate(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    def create_parameter(self, attr, shape, dtype="float32",
                         is_bias: bool = False,
                         default_initializer=None) -> Optional[Parameter]:
        """Main-program Parameter plus its init op in the startup
        program. Biases default to Constant(0), weights to Xavier."""
        attr = ParamAttr._to_attr(attr)
        if attr is None:
            return None
        name = attr.name or unique_name.generate(
            f"{self.name}.b" if is_bias else f"{self.name}.w")
        init = attr.initializer or default_initializer or (
            _default_bias_initializer() if is_bias else Xavier())
        block = self.main_program.global_block()
        if name in block.vars:
            return block.vars[name]
        param = block.create_parameter(name=name, shape=shape, dtype=dtype,
                                       trainable=attr.trainable)
        sblock = self.startup_program.global_block()
        svar = sblock.create_parameter(name=name, shape=shape, dtype=dtype,
                                       trainable=attr.trainable)
        init(svar, sblock)
        return param

    def create_variable_for_type_inference(self, dtype="float32",
                                           stop_gradient: bool = False
                                           ) -> Variable:
        return self.main_program.current_block().create_var(
            name=unique_name.generate(f"{self.name}.tmp"), dtype=dtype,
            stop_gradient=stop_gradient)

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        return self.main_program.current_block().append_op(
            type, inputs, outputs, attrs)

    def append_activation(self, out: Variable, act: Optional[str]
                          ) -> Variable:
        if act is None:
            return out
        act_out = self.create_variable_for_type_inference(out.dtype)
        self.append_op(act, {"X": [out]}, {"Out": [act_out]}, {})
        return act_out
