"""The 2.0 LR schedulers (port of ``paddle_tpu/optimizer/lr.py``:
``LRScheduler`` and its 12 schedulers, :25-310).

Host-driven: the caller runs ``scheduler.step()`` (per epoch or per
iteration); the scheduler computes the rate and writes it into every
bound learning-rate variable, IN PLACE (``write_lr``), so a compiled
step that captured the tensor reads the new rate on its next replay.
``Optimizer(learning_rate=scheduler)`` binds it, in a static program
(the global scope) or in a dygraph optimizer's micro-program scope.
The fluid path, ``layers.learning_rate_scheduler``, is an op in the
program instead.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["LRScheduler", "NoamDecay", "PiecewiseDecay", "NaturalExpDecay",
           "InverseTimeDecay", "PolynomialDecay", "LinearWarmup",
           "ExponentialDecay", "MultiStepDecay", "StepDecay", "LambdaDecay",
           "ReduceOnPlateau", "CosineAnnealingDecay"]


class LRScheduler:
    """Base: subclasses implement ``get_lr()`` from ``self.last_epoch``."""

    def __init__(self, learning_rate: float = 0.1, last_epoch: int = -1,
                 verbose: bool = False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        # (scope, var_name) pairs to refresh on step(); bound by optimizers
        self._bindings: List[Tuple[object, str]] = []
        self.last_lr = self.base_lr
        if self.last_epoch < 0:
            self.last_epoch = 0
        # initialise last_lr at epoch 0 WITHOUT dispatching to subclass
        # step() overrides (ReduceOnPlateau.step takes a metric, not an epoch)
        self.last_lr = float(self.get_lr())

    def __call__(self) -> float:
        return self.last_lr

    def get_lr(self) -> float:
        raise NotImplementedError

    def step(self, epoch: Optional[int] = None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = int(epoch)
        self.last_lr = float(self.get_lr())
        self._push()
        if self.verbose:
            print(f"Epoch {self.last_epoch}: set learning rate to "
                  f"{self.last_lr:.8f}")

    def _push(self):
        for scope_fn, name in self._bindings:
            write_lr(scope_fn(), name, self.last_lr)

    # Optimizer integration ---------------------------------------------------
    def _create_var(self):
        """Called by Optimizer._create_global_learning_rate: materialise a
        persistable [1] var in the current program holding the current LR."""
        from ..core import unique_name
        from ..layers import nn as layers_nn

        return layers_nn.create_global_var(
            [1], self.last_lr, "float32", persistable=True,
            name=unique_name.generate("learning_rate"))

    def _bind(self, scope, var_name: str):
        """`scope` may be a Scope or a zero-arg callable returning one (so a
        reset/replaced global scope is still reached)."""
        scope_fn = scope if callable(scope) else (lambda: scope)
        self._bindings.append((scope_fn, var_name))
        write_lr(scope_fn(), var_name, self.last_lr)

    def state_dict(self) -> dict:
        return {"last_epoch": self.last_epoch, "last_lr": self.last_lr}

    def set_state_dict(self, state: dict):
        self.last_epoch = int(state.get("last_epoch", self.last_epoch))
        self.last_lr = float(state.get("last_lr", self.last_lr))
        self._push()


def write_lr(scope, name: str, value: float):
    """The rate into ``scope``'s [1] tensor ``name``: in place where it
    exists, else a new float32 tensor on the CPU (a startup program's
    fill replaces it on its device)."""
    t = scope.find_var(name)
    if isinstance(t, torch.Tensor):
        t.fill_(float(value))
    else:
        scope.set(name, torch.full((1,), float(value), dtype=torch.float32))


class NoamDecay(LRScheduler):
    def __init__(self, d_model: int, warmup_steps: int, learning_rate=1.0,
                 last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        s = max(self.last_epoch, 1)
        return (self.base_lr * self.d_model ** -0.5 *
                min(s ** -0.5, s * self.warmup_steps ** -1.5))


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries: Sequence[int], values: Sequence[float],
                 last_epoch=-1, verbose=False):
        if len(values) != len(boundaries) + 1:
            raise ValueError("len(values) must be len(boundaries) + 1")
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for b, v in zip(self.boundaries, self.values):
            if self.last_epoch < b:
                return v
        return self.values[-1]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma: float, last_epoch=-1,
                 verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma: float, last_epoch=-1,
                 verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1.0 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps: int, end_lr: float = 1e-4,
                 power: float = 1.0, cycle: bool = False, last_epoch=-1,
                 verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        if self.cycle:
            div = max(math.ceil(step / self.decay_steps), 1)
            horizon = self.decay_steps * div
        else:
            horizon = self.decay_steps
            step = min(step, self.decay_steps)
        return ((self.base_lr - self.end_lr) *
                (1 - step / horizon) ** self.power + self.end_lr)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma: float, last_epoch=-1,
                 verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** self.last_epoch


class LinearWarmup(LRScheduler):
    """Ramp start_lr→end_lr over warmup_steps, then follow the wrapped
    schedule (or constant)."""

    def __init__(self, learning_rate, warmup_steps: int, start_lr: float,
                 end_lr: float, last_epoch=-1, verbose=False):
        self.wrapped = learning_rate if isinstance(learning_rate, LRScheduler) \
            else None
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        base = learning_rate.base_lr if self.wrapped else float(learning_rate)
        super().__init__(base, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.start_lr + (self.end_lr - self.start_lr) *
                    self.last_epoch / self.warmup_steps)
        if self.wrapped is not None:
            self.wrapped.last_epoch = self.last_epoch - self.warmup_steps
            return self.wrapped.get_lr()
        return self.base_lr


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones: Sequence[int],
                 gamma: float = 0.1, last_epoch=-1, verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * self.gamma ** n


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size: int, gamma: float = 0.1,
                 last_epoch=-1, verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** (self.last_epoch // self.step_size)


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda: Callable[[int], float],
                 last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max: int, eta_min: float = 0.0,
                 last_epoch=-1, verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return (self.eta_min + (self.base_lr - self.eta_min) *
                (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2)


class ReduceOnPlateau(LRScheduler):
    """Multiply LR by `factor` after `patience` steps without metric
    improvement (reference: optimizer/lr.py ReduceOnPlateau)."""

    def __init__(self, learning_rate, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4,
                 threshold_mode: str = "rel", cooldown: int = 0,
                 min_lr: float = 0.0, epsilon: float = 1e-8, verbose=False):
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.epsilon = epsilon
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        super().__init__(learning_rate, -1, verbose)

    def get_lr(self):
        return self.last_lr if self.last_epoch > 0 else self.base_lr

    def step(self, metrics=None, epoch=None):  # type: ignore[override]
        self.last_epoch += 1 if epoch is None else 0
        if epoch is not None:
            self.last_epoch = int(epoch)
        if metrics is None:
            return  # nothing to react to
        m = float(np.asarray(metrics).reshape(-1)[0])
        if self.best is None or self._better(m, self.best):
            self.best = m
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        elif self.num_bad > self.patience:
            new_lr = max(self.last_lr * self.factor, self.min_lr)
            if self.last_lr - new_lr > self.epsilon:
                self.last_lr = new_lr
                if self.verbose:
                    print(f"Epoch {self.last_epoch}: reduce lr to {new_lr:.8f}")
            self.cooldown_counter = self.cooldown
            self.num_bad = 0
        self._push()

    def state_dict(self) -> dict:
        return {"last_epoch": self.last_epoch, "last_lr": self.last_lr,
                "best": self.best, "num_bad": self.num_bad,
                "cooldown_counter": self.cooldown_counter}

    def set_state_dict(self, state: dict):
        super().set_state_dict(state)
        self.best = state.get("best", self.best)
        self.num_bad = int(state.get("num_bad", self.num_bad))
        self.cooldown_counter = int(state.get("cooldown_counter",
                                              self.cooldown_counter))

    def _better(self, a, b):
        if self.mode == "min":
            thr = (b * (1 - self.threshold) if self.threshold_mode == "rel"
                   else b - self.threshold)
            return a < thr
        thr = (b * (1 + self.threshold) if self.threshold_mode == "rel"
               else b + self.threshold)
        return a > thr
