"""fluid-style learning-rate schedules (port of
``paddle_tpu/layers/learning_rate_scheduler.py``: noam_decay,
exponential_decay, natural_exp_decay, inverse_time_decay,
polynomial_decay, piecewise_decay, cosine_decay, linear_lr_warmup).

Each returns a [1] float32 persistable Variable written by one
``lr_schedule`` op (``ops/lr_ops.py``); pass it as ``learning_rate=`` to
an optimizer. The op reads the step from ``@LR_DECAY_COUNTER@``, a
persistable float32 counter that starts at -1 and that an ``increment``
op at the head of the schedule's ops advances once a run of the main
program. The counter is a device tensor, so a compiled step's graph
advances it and reads it on every replay.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..core import unique_name
from ..core.ir import OpRole, Variable, default_main_program

__all__ = ["noam_decay", "exponential_decay", "natural_exp_decay",
           "inverse_time_decay", "polynomial_decay", "piecewise_decay",
           "cosine_decay", "linear_lr_warmup"]

_COUNTER_NAME = "@LR_DECAY_COUNTER@"


def _decay_step_counter() -> Variable:
    """The program's one step counter: made at its first use, with its
    ``increment`` op under the LRSched role; the first run reads 0."""
    from .nn import create_global_var

    prog = default_main_program()
    block = prog.global_block()
    if _COUNTER_NAME in block.vars:
        return block.vars[_COUNTER_NAME]
    counter = create_global_var([1], -1.0, "float32", persistable=True,
                                name=_COUNTER_NAME)
    with prog._role_guard(OpRole.LRSched):
        block.append_op("increment", {"X": [counter]}, {"Out": [counter]},
                        {"step": 1.0}, infer_shape=False)
    return counter


def _lr_op(schedule: str, attrs: dict, base_lr: Optional[Variable] = None,
           name: str = "learning_rate") -> Variable:
    prog = default_main_program()
    block = prog.current_block()
    step = _decay_step_counter()
    out = block.create_var(name=unique_name.generate(name), shape=(1,),
                           dtype="float32", persistable=True)
    ins = {"Step": [step]}
    if base_lr is not None:
        ins["BaseLR"] = [base_lr]
    with prog._role_guard(OpRole.LRSched):
        block.append_op("lr_schedule", ins, {"Out": [out]},
                        {"schedule": schedule, **attrs}, infer_shape=False)
    return out


def noam_decay(d_model: int, warmup_steps: int, learning_rate: float = 1.0):
    """lr * d_model^-0.5 * min(s^-0.5, s * warmup^-1.5) at s = step + 1."""
    return _lr_op("noam", {"d_model": d_model, "warmup_steps": warmup_steps,
                           "learning_rate": learning_rate})


def exponential_decay(learning_rate: float, decay_steps: int,
                      decay_rate: float, staircase: bool = False):
    return _lr_op("exponential", {"learning_rate": learning_rate,
                                  "decay_steps": decay_steps,
                                  "decay_rate": decay_rate,
                                  "staircase": staircase})


def natural_exp_decay(learning_rate: float, decay_steps: int,
                      decay_rate: float, staircase: bool = False):
    return _lr_op("natural_exp", {"learning_rate": learning_rate,
                                  "decay_steps": decay_steps,
                                  "decay_rate": decay_rate,
                                  "staircase": staircase})


def inverse_time_decay(learning_rate: float, decay_steps: int,
                       decay_rate: float, staircase: bool = False):
    return _lr_op("inverse_time", {"learning_rate": learning_rate,
                                   "decay_steps": decay_steps,
                                   "decay_rate": decay_rate,
                                   "staircase": staircase})


def polynomial_decay(learning_rate: float, decay_steps: int,
                     end_learning_rate: float = 1e-4, power: float = 1.0,
                     cycle: bool = False):
    return _lr_op("polynomial", {"learning_rate": learning_rate,
                                 "decay_steps": decay_steps,
                                 "end_learning_rate": end_learning_rate,
                                 "power": power, "cycle": cycle})


def piecewise_decay(boundaries: Sequence[int], values: Sequence[float]):
    if len(values) != len(boundaries) + 1:
        raise ValueError("len(values) must be len(boundaries) + 1")
    return _lr_op("piecewise", {"boundaries": [float(b) for b in boundaries],
                                "values": [float(v) for v in values]})


def cosine_decay(learning_rate: float, step_each_epoch: int, epochs: int):
    return _lr_op("cosine", {"learning_rate": learning_rate,
                             "step_each_epoch": step_each_epoch,
                             "epochs": epochs})


def linear_lr_warmup(learning_rate, warmup_steps: int, start_lr: float,
                     end_lr: float):
    """A linear ramp from start_lr to end_lr over warmup_steps, then the
    base rate (a float or another schedule's Variable)."""
    attrs = {"warmup_steps": warmup_steps, "start_lr": start_lr,
             "end_lr": end_lr}
    if isinstance(learning_rate, Variable):
        return _lr_op("linear_warmup", attrs, base_lr=learning_rate)
    return _lr_op("linear_warmup", {**attrs, "base_lr": float(learning_rate)})
