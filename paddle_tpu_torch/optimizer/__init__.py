"""Optimizer classes: emit optimizer ops into the program.

The port of ``paddle_tpu/optimizer/__init__.py``: ``Optimizer`` (:33),
``SGDOptimizer``, ``MomentumOptimizer``, ``LarsMomentumOptimizer``,
``AdagradOptimizer`` (:370), ``AdamOptimizer``, ``AdamWOptimizer``,
``LambOptimizer``, ``AdamaxOptimizer`` (:457), ``AdadeltaOptimizer``
(:486), ``RMSPropOptimizer`` (:511), ``DecayedAdagradOptimizer`` (:544),
``FtrlOptimizer`` (:566) and the 2.0 names (``SGD``, ``AdamW``, ...).
``minimize(loss)`` is ``append_backward`` plus, in ``apply_gradients``,
the gradient clip (``grad_clip``, ``clip.py``), the regularization ops
(``regularization``, or ``weight_decay`` as an L2 decay;
``regularizer.py``) and one update op per parameter; the update ops name
the parameter and its moments as both input and output, and the port's
lowerings update them in place.

The imperative path (:164-300): under a dygraph guard ``minimize`` /
``step`` apply the gradients ``backward()`` left on the parameters
through a micro-Program of the same update ops, built once per set of
parameters and run by the Executor on the parameters' device over one
scope shared by every such program. The scope holds the parameters'
own tensors, so the in-place updates land in them; its second run
captures a CUDA graph that later steps replay. ``state_dict`` keys the
accumulators by parameter position. ``learning_rate`` may be an
``lr.LRScheduler``, in either mode: its ``step()`` writes the new rate
into the bound scopes' tensor in place.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import unique_name
from ..core.backward import append_backward
from ..core.ir import OpRole, Parameter, Variable, default_main_program
from ..regularizer import append_regularization_ops


class _OptimizerStateDict(dict):
    """Marks a dict as optimizer state, so save_dygraph picks '.pdopt'."""

    _is_optimizer_state = True


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
        # dygraph: parameter names -> (micro-program, executor)
        self._dy_cache: Dict[tuple, tuple] = {}

    # -- learning rate ------------------------------------------------------
    def _create_global_learning_rate(self):
        if self._lr_var is not None:
            return
        from ..layers import nn as layers_nn

        lr = self._learning_rate
        if isinstance(lr, Variable):
            self._lr_var = lr
            return
        if callable(lr):  # an lr.LRScheduler
            self._lr_var = lr._create_var()
            lr._bind(self._lr_scope, self._lr_var.name)
            return
        self._lr_var = layers_nn.create_global_var(
            [1], float(lr), "float32", persistable=True,
            name=unique_name.generate("learning_rate"))

    @property
    def learning_rate_var(self) -> Variable:
        return self._lr_var

    def _lr_scope(self):
        scope = getattr(self, "_dy_scope", None)
        if scope is not None:
            return scope
        from ..core.scope import global_scope

        return global_scope()

    def current_step_lr(self) -> float:
        if self._lr_var is None:
            lr = self._learning_rate
            return float(lr() if callable(lr) else lr)
        v = self._lr_scope().find_var(self._lr_var.name)
        return float(v.reshape(-1)[0]) if v is not None \
            else float(self._learning_rate)

    def set_lr(self, value: float):
        if self._lr_var is None:
            self._learning_rate = float(value)
            return
        from .lr import write_lr

        write_lr(self._lr_scope(), self._lr_var.name, float(value))

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
        from ..core.ir import in_dygraph_mode

        if in_dygraph_mode():
            params_grads = self._dygraph_params_grads(parameter_list)
            self._dygraph_apply(params_grads)
            return None, params_grads
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        return self.apply_gradients(params_grads), params_grads

    # -- the imperative path ------------------------------------------------
    def _dygraph_params_grads(self, parameter_list=None):
        params = parameter_list or self._parameter_list
        if params is None:
            raise ValueError(
                "dygraph optimizers need the parameter list — construct "
                "with parameters=model.parameters()")
        return [(p, p.grad) for p in params
                if getattr(p, "trainable", True)
                and p._tensor.grad is not None]

    def step(self):
        """2.0 style: apply the gradients backward() left."""
        self._dygraph_apply(self._dygraph_params_grads())

    def clear_grad(self):
        for p in (self._parameter_list or []):
            p.clear_gradient()

    clear_gradients = clear_grad

    def _dygraph_apply(self, params_grads):
        """Run the cached micro-Program of update ops for these
        parameters: the gradients are its feeds, the parameters its
        scope's own tensors (updated in place)."""
        if not params_grads:
            return
        from ..core.executor import Executor
        from ..core.ir import Program, program_guard
        from ..core.scope import Scope
        from ..core.types import dtype_name

        scope = getattr(self, "_dy_scope", None)
        if scope is None:
            scope = self._dy_scope = Scope()
        key = tuple(p.name for p, _ in params_grads)
        cached = self._dy_cache.get(key)
        if cached is None:
            prog, startup = Program(), Program()
            with program_guard(prog, startup):
                blk = prog.global_block()
                pg_vars = []
                for p, g in params_grads:
                    pv = blk.create_parameter(name=p.name,
                                              shape=list(p.shape),
                                              dtype=dtype_name(p.dtype))
                    pv.regularizer = getattr(p, "regularizer", None)
                    gv = blk.create_var(name=p.name + "@GRAD",
                                        shape=list(g.shape),
                                        dtype=dtype_name(g.dtype))
                    pg_vars.append((pv, gv))
                self.apply_gradients(pg_vars)
            exe = Executor(params_grads[0][0]._tensor.device)
            exe.run(startup, scope=scope, use_compiled=False)
            pending = getattr(self, "_pending_state", None)
            if pending:
                self._write_state(pending)
                self._pending_state = None
            cached = self._dy_cache[key] = (prog, exe)
        prog, exe = cached
        for p, _ in params_grads:
            if scope.find_var(p.name) is not p._tensor:
                scope.set(p.name, p._tensor)
        feed = {p.name + "@GRAD": g._tensor for p, g in params_grads}
        with torch.no_grad():
            exe.run(prog, feed=feed, fetch_list=[], scope=scope,
                    return_numpy=False)
            for p, _ in params_grads:
                t = scope.find_var(p.name)
                if t is not p._tensor:
                    p._tensor.copy_(t)
                    scope.set(p.name, p._tensor)

    def _param_index(self) -> Dict[str, int]:
        """Parameter name -> position (positions survive a new process,
        where unique_name counters do not)."""
        return {p.name: i for i, p in enumerate(self._parameter_list or [])}

    def state_dict(self) -> Dict[str, Any]:
        """Dygraph optimizer state keyed '<accumulator>#<parameter
        position>' (and 'LR#'), as numpy arrays."""
        from ..core.executor import _to_numpy

        out = _OptimizerStateDict()
        scope = getattr(self, "_dy_scope", None)
        if scope is None:
            return out
        idx = self._param_index()
        for name, per_param in self._accumulators.items():
            for pname, var in per_param.items():
                v = scope.find_var(var.name)
                if v is not None and pname in idx:
                    out[f"{name}#{idx[pname]}"] = _to_numpy(v)
        if self._lr_var is not None:
            v = scope.find_var(self._lr_var.name)
            if v is not None:
                out["LR#"] = _to_numpy(v)
        return out

    def set_state_dict(self, state: Dict[str, Any]):
        if getattr(self, "_dy_scope", None) is None or \
                not self._accumulators:
            # no scope before the first step: applied once it is built
            self._pending_state = dict(state)
            return
        self._write_state(state)

    def _write_state(self, state: Dict[str, Any]):
        """Copy saved values into the scope's tensors in place (a captured
        step keeps reading the same tensors)."""
        by_pos = {i: p for p, i in self._param_index().items()}
        restored = 0

        def put(name, value):
            t = self._dy_scope.find_var(name)
            v = torch.as_tensor(np.asarray(value))
            if isinstance(t, torch.Tensor):
                t.copy_(v.reshape(t.shape).to(t.dtype))
            else:
                self._dy_scope.set(name, v)

        for k, v in state.items():
            if k == "LR#" or k.startswith("LR_"):
                if self._lr_var is not None:
                    put(self._lr_var.name, v)
                    restored += 1
                continue
            if "#" in k:
                acc_name, pos = k.rsplit("#", 1)
                pname = by_pos.get(int(pos))
                var = self._accumulators.get(acc_name, {}).get(pname) \
                    if pname else None
                if var is None:
                    continue
                put(var.name, v)
                restored += 1
            else:  # a raw var name
                put(k, v)
                restored += 1
        if state and restored == 0:
            raise ValueError(
                "optimizer set_state_dict restored 0 entries — checkpoint "
                f"keys {sorted(state)[:5]} match no accumulator of this "
                "optimizer (was it saved by a different optimizer type?)")

    set_dict = set_state_dict


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


class AdagradOptimizer(Optimizer):
    type = "adagrad"

    def __init__(self, learning_rate, epsilon=1e-6,
                 initial_accumulator_value=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p, self._initial)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            "adagrad",
            {"Param": [p], "Grad": [g], "Moment": [m],
             "LearningRate": [self._lr_var]},
            {"ParamOut": [p], "MomentOut": [m]}, {"epsilon": self._epsilon})


class AdamaxOptimizer(Optimizer):
    type = "adamax"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow", p, self._beta1, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        inf = self._get_accumulator("inf_norm", p)
        return block.append_op(
            "adamax",
            {"Param": [p], "Grad": [g], "LearningRate": [self._lr_var],
             "Moment": [m], "InfNorm": [inf],
             "Beta1Pow": [self._get_accumulator("beta1_pow", p)]},
            {"ParamOut": [p], "MomentOut": [m], "InfNormOut": [inf]},
            {"beta1": self._beta1, "beta2": self._beta2,
             "epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    type = "adadelta"

    def __init__(self, learning_rate=1.0, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("avg_squared_grad", p)
            self._add_accumulator("avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sq = self._get_accumulator("avg_squared_grad", p)
        upd = self._get_accumulator("avg_squared_update", p)
        return block.append_op(
            "adadelta",
            {"Param": [p], "Grad": [g], "AvgSquaredGrad": [sq],
             "AvgSquaredUpdate": [upd]},
            {"ParamOut": [p], "AvgSquaredGradOut": [sq],
             "AvgSquaredUpdateOut": [upd]},
            {"epsilon": self._epsilon, "rho": self._rho})


class RMSPropOptimizer(Optimizer):
    type = "rmsprop"

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("mean_square", p)
            self._add_accumulator("moment", p)
            if self._centered:
                self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        ms = self._get_accumulator("mean_square", p)
        mom = self._get_accumulator("moment", p)
        ins = {"Param": [p], "Grad": [g], "LearningRate": [self._lr_var],
               "MeanSquare": [ms], "Moment": [mom]}
        outs = {"ParamOut": [p], "MeanSquareOut": [ms], "MomentOut": [mom]}
        if self._centered:
            mg = self._get_accumulator("mean_grad", p)
            ins["MeanGrad"] = [mg]
            outs["MeanGradOut"] = [mg]
        return block.append_op(
            "rmsprop", ins, outs,
            {"decay": self._rho, "epsilon": self._epsilon,
             "momentum": self._momentum, "centered": self._centered})


class DecayedAdagradOptimizer(Optimizer):
    type = "decayed_adagrad"

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            "decayed_adagrad",
            {"Param": [p], "Grad": [g], "Moment": [m],
             "LearningRate": [self._lr_var]},
            {"ParamOut": [p], "MomentOut": [m]},
            {"decay": self._decay, "epsilon": self._epsilon})


class FtrlOptimizer(Optimizer):
    type = "ftrl"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sq = self._get_accumulator("squared", p)
        lin = self._get_accumulator("linear", p)
        return block.append_op(
            "ftrl",
            {"Param": [p], "Grad": [g], "LearningRate": [self._lr_var],
             "SquaredAccumulator": [sq], "LinearAccumulator": [lin]},
            {"ParamOut": [p], "SquaredAccumOut": [sq],
             "LinearAccumOut": [lin]},
            {"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power})


# the 2.0 names (paddle.optimizer)
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
AdamW = AdamWOptimizer
Adamax = AdamaxOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Lamb = LambOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Ftrl = FtrlOptimizer

from . import lr  # noqa: E402,F401  (the 2.0 LR schedulers)
