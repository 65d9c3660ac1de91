"""Optimizer classes: emit optimizer ops into the program.

The port of ``paddle_tpu/optimizer/__init__.py``: ``Optimizer`` (:33),
``AdamOptimizer`` (:393) and ``AdamWOptimizer`` (:433). ``minimize(loss)``
is ``append_backward`` plus one update op per parameter; the update ops
name the parameter and its moments as both input and output, and the
port's lowerings update them in place.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..core import unique_name
from ..core.backward import append_backward
from ..core.ir import OpRole, Parameter, Variable, default_main_program


class Optimizer:
    def __init__(self, learning_rate=0.001, parameter_list=None,
                 name: Optional[str] = None, parameters=None):
        self._learning_rate = learning_rate
        self._parameter_list = parameter_list if parameter_list is not None \
            else parameters
        self._name = name or unique_name.generate(type(self).__name__)
        self._accumulators: Dict[str, Dict[str, Variable]] = {}
        self._lr_var: Optional[Variable] = None

    # -- learning rate ------------------------------------------------------
    def _create_global_learning_rate(self):
        if self._lr_var is not None:
            return
        from ..layers import nn as layers_nn

        lr = self._learning_rate
        if isinstance(lr, Variable):
            self._lr_var = lr
            return
        self._lr_var = layers_nn.create_global_var(
            [1], float(lr), "float32", persistable=True,
            name=unique_name.generate("learning_rate"))

    @property
    def learning_rate_var(self) -> Variable:
        return self._lr_var

    # -- accumulators -------------------------------------------------------
    def _add_accumulator(self, name: str, param: Variable,
                         fill_value: float = 0.0, shape=None,
                         dtype="float32") -> Variable:
        from ..layers import nn as layers_nn
        from ..parallel.api import (get_logical_axes, get_sharding_spec,
                                    set_logical_axes, shard_tensor)

        acc = self._accumulators.setdefault(name, {})
        if param.name in acc:
            return acc[param.name]
        var = layers_nn.create_global_var(
            shape or list(param.shape), fill_value, dtype, persistable=True,
            name=unique_name.generate(f"{param.name}_{name}"))
        # a moment carries its parameter's sharding annotations
        if shape is None or list(shape) == list(param.shape):
            spec = get_sharding_spec(param)
            if spec is not None:
                shard_tensor(var, spec)
            axes = get_logical_axes(param)
            if axes is not None:
                set_logical_axes(var, axes)
        acc[param.name] = var
        return var

    def _get_accumulator(self, name: str, param: Variable) -> Variable:
        return self._accumulators[name][param.name]

    # -- hooks subclasses implement -----------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    # -- public API ----------------------------------------------------------
    def backward(self, loss: Variable, startup_program=None,
                 parameter_list=None, no_grad_set=None
                 ) -> List[Tuple[Parameter, Variable]]:
        return append_backward(loss, parameter_list or self._parameter_list,
                               no_grad_set)

    def apply_gradients(self, params_grads) -> List:
        block = default_main_program().current_block()
        with block.program._role_guard(OpRole.Optimize):
            self._create_global_learning_rate()
            self._create_accumulators(block, [p for p, _ in params_grads])
            return [self._append_optimize_op(block, pg)
                    for pg in params_grads]

    def minimize(self, loss: Variable, startup_program=None,
                 parameter_list=None, no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        return self.apply_gradients(params_grads), params_grads


class AdamOptimizer(Optimizer):
    type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lazy_mode = bool(lazy_mode)

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow", p, self._beta1, shape=[1])
            self._add_accumulator("beta2_pow", p, self._beta2, shape=[1])

    def _op_type(self):
        return "adam", {}

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow", p)
        b2p = self._get_accumulator("beta2_pow", p)
        op_type, extra = self._op_type()
        return block.append_op(
            op_type,
            {"Param": [p], "Grad": [g], "LearningRate": [self._lr_var],
             "Moment1": [m1], "Moment2": [m2], "Beta1Pow": [b1p],
             "Beta2Pow": [b2p]},
            {"ParamOut": [p], "Moment1Out": [m1], "Moment2Out": [m2],
             "Beta1PowOut": [b1p], "Beta2PowOut": [b2p]},
            {"beta1": self._beta1, "beta2": self._beta2,
             "epsilon": self._epsilon, "lazy_mode": self._lazy_mode,
             **extra})


class AdamWOptimizer(AdamOptimizer):
    type = "adamw"

    def __init__(self, learning_rate=0.001, weight_decay=0.01, **kw):
        super().__init__(learning_rate, **kw)
        self._coeff = weight_decay

    def _op_type(self):
        return "adamw", {"coeff": self._coeff, "with_decay": True}
