"""The learning-rate schedule op (port of ``paddle_tpu/ops/lr_ops.py``:
lr_schedule :18, every branch: noam, exponential, natural_exp,
inverse_time, polynomial, piecewise, cosine, linear_warmup).

One ``lr_schedule`` op computes the rate from the step it reads. The
step comes from the ``Step`` input, the persistable counter that an
``increment`` op in the same program advances
(``layers/learning_rate_scheduler.py``), so it lives on the device and a
CUDA graph replay reads the counter's new value every step: the whole
schedule is tensor arithmetic on it with Python-float constants, with no
host read and no host-to-device copy. Without a ``Step`` input the
reference falls back on the executor's host step (``__step__``); a
captured step would freeze that integer at its capture, so the port
takes it only op by op and raises in a compiled step, which passes no
``__step__``.
"""

from __future__ import annotations

import math

import torch

from ..core.registry import creation_device, register_op


def _step(ins, attrs) -> torch.Tensor:
    step_in = ins.get("Step", [None])[0]
    if step_in is not None:
        return step_in.reshape(()).to(torch.float32)
    if "__step__" not in attrs:
        raise RuntimeError(
            "lr_schedule has no Step input and no host step: the "
            "executor's host step counter cannot drive a compiled step "
            "(a CUDA graph would replay the rate of its capture); build "
            "the schedule through layers.learning_rate_scheduler, whose "
            "Step is a device counter, or run with use_compiled=False")
    return torch.tensor(float(attrs["__step__"]), dtype=torch.float32,
                        device=creation_device())


@register_op("lr_schedule", non_diff_inputs=("BaseLR", "Step"))
def lr_schedule(ins, attrs):
    step = _step(ins, attrs)
    sched = attrs["schedule"]
    lr0 = float(attrs.get("learning_rate", 1.0))

    if sched == "noam":
        d_model = float(attrs["d_model"])
        warmup = float(attrs["warmup_steps"])
        s = step + 1.0
        lr = lr0 * d_model ** -0.5 * torch.minimum(s ** -0.5,
                                                   s * warmup ** -1.5)
    elif sched in ("exponential", "natural_exp", "inverse_time"):
        ds = float(attrs["decay_steps"])
        dr = float(attrs["decay_rate"])
        p = step / ds
        if attrs.get("staircase", False):
            p = torch.floor(p)
        if sched == "exponential":
            lr = lr0 * torch.pow(dr, p)
        elif sched == "natural_exp":
            lr = lr0 * torch.exp(-dr * p)
        else:
            lr = lr0 / (1.0 + dr * p)
    elif sched == "polynomial":
        ds = float(attrs["decay_steps"])
        end_lr = float(attrs.get("end_learning_rate", 1e-4))
        power = float(attrs.get("power", 1.0))
        if attrs.get("cycle", False):
            horizon = ds * torch.clamp(torch.ceil(step / ds), min=1.0)
            s = step
        else:
            horizon = ds
            s = torch.clamp(step, max=ds)
        lr = (lr0 - end_lr) * (1.0 - s / horizon) ** power + end_lr
    elif sched == "piecewise":
        # values[number of boundaries at or below the step], as a chain of
        # selects on Python floats: nothing is copied from the host
        idx = sum((step >= float(b)).to(torch.int32)
                  for b in attrs["boundaries"])
        values = [float(v) for v in attrs["values"]]
        lr = torch.full_like(step, values[0])
        for i, v in enumerate(values[1:], 1):
            lr = torch.where(idx == i, v, lr)
    elif sched == "cosine":
        spe = float(attrs["step_each_epoch"])
        epochs = float(attrs["epochs"])
        epoch = torch.floor(step / spe)
        lr = 0.5 * lr0 * (torch.cos(epoch * math.pi / epochs) + 1.0)
    elif sched == "linear_warmup":
        warmup = float(attrs["warmup_steps"])
        start_lr = float(attrs["start_lr"])
        end_lr = float(attrs["end_lr"])
        base = ins.get("BaseLR", [None])[0]
        base = (base.reshape(()).to(torch.float32) if base is not None
                else torch.full_like(step, float(attrs["base_lr"])))
        warm = start_lr + (end_lr - start_lr) * torch.clamp(
            step, max=warmup) / warmup
        lr = torch.where(step < warmup, warm, base)
    else:
        raise ValueError(f"unknown lr schedule '{sched}'")
    return {"Out": lr.reshape(1).to(torch.float32)}
