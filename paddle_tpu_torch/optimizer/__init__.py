"""Optimizer classes: emit optimizer ops into the program.

The port of ``paddle_tpu/optimizer/__init__.py``: ``Optimizer`` (:33),
``SGDOptimizer`` (:311), ``MomentumOptimizer`` (:321),
``LarsMomentumOptimizer`` (:344), ``AdamOptimizer`` (:393),
``AdamWOptimizer`` (:433) and ``LambOptimizer`` (:444). ``minimize(loss)``
is ``append_backward`` plus, in ``apply_gradients``, the gradient clip
(``grad_clip``, ``clip.py``), the regularization ops (``regularization``,
or ``weight_decay`` as an L2 decay; ``regularizer.py``) and one update op
per parameter; the update ops name the parameter and its moments as both
input and output, and the port's lowerings update them in place.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..core import unique_name
from ..core.backward import append_backward
from ..core.ir import OpRole, Parameter, Variable, default_main_program
from ..regularizer import append_regularization_ops


class Optimizer:
    def __init__(self, learning_rate=0.001, parameter_list=None,
                 regularization=None, grad_clip=None,
                 name: Optional[str] = None, parameters=None,
                 weight_decay=None):
        self._learning_rate = learning_rate
        self._parameter_list = parameter_list if parameter_list is not None \
            else parameters
        self.regularization = regularization
        if weight_decay is not None and regularization is None \
                and not isinstance(self, AdamWOptimizer):
            from ..regularizer import L2Decay

            self.regularization = L2Decay(weight_decay)
        self._grad_clip = grad_clip
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
        """The clip, the regularization and the update ops of every
        (param, grad), in the current block."""
        block = default_main_program().current_block()
        with block.program._role_guard(OpRole.Optimize):
            self._create_global_learning_rate()
            if self._grad_clip is not None:
                params_grads = self._grad_clip(params_grads)
            params_grads = append_regularization_ops(params_grads,
                                                     self.regularization)
            self._create_accumulators(block, [p for p, _ in params_grads])
            return [self._append_optimize_op(block, pg)
                    for pg in params_grads]

    def minimize(self, loss: Variable, startup_program=None,
                 parameter_list=None, no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        return self.apply_gradients(params_grads), params_grads


class SGDOptimizer(Optimizer):
    type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "sgd", {"Param": [p], "Grad": [g], "LearningRate": [self._lr_var]},
            {"ParamOut": [p]}, {})


class MomentumOptimizer(Optimizer):
    type = "momentum"

    def __init__(self, learning_rate, momentum=0.9, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            "momentum",
            {"Param": [p], "Grad": [g], "Velocity": [v],
             "LearningRate": [self._lr_var]},
            {"ParamOut": [p], "VelocityOut": [v]},
            {"mu": self._momentum, "use_nesterov": self._use_nesterov})


class LarsMomentumOptimizer(Optimizer):
    type = "lars_momentum"

    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            "lars_momentum",
            {"Param": [p], "Grad": [g], "Velocity": [v],
             "LearningRate": [self._lr_var]},
            {"ParamOut": [p], "VelocityOut": [v]},
            {"mu": self._momentum, "lars_coeff": self._lars_coeff,
             "lars_weight_decay": self._lars_weight_decay})


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


class LambOptimizer(AdamOptimizer):
    type = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, **kw):
        super().__init__(learning_rate, beta1=beta1, beta2=beta2,
                         epsilon=epsilon, **kw)
        self._weight_decay = lamb_weight_decay

    def _op_type(self):
        return "lamb", {"weight_decay": self._weight_decay}
