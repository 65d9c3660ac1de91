"""AMP loss-scaling ops (port of ``paddle_tpu/ops/amp_ops.py`` :19-61;
reference operators/amp/check_finite_and_unscale_op and
update_loss_scaling_op).

Everything stays on the device: ``FoundInfinite`` is a device bool, the
step counters are int32 tensors and ``torch.where`` picks each new value,
with no ``.item()`` and no host branch, so both ops are captured in a
compiled step and a replay handles an overflow as an op by op run does.
Both are functional, as in the reference: new tensors come out, and the
executor writes the persistable ones back into the scope."""

from __future__ import annotations

import torch

from ..core.registry import register_op

_NON_DIFF = dict(non_diff_inputs=("X", "Scale", "FoundInfinite",
                                  "PrevLossScaling", "InGoodSteps",
                                  "InBadSteps"))


@register_op("check_finite_and_unscale", **_NON_DIFF)
def check_finite_and_unscale(ins, attrs):
    """Out = X * (1 / Scale) for every X; FoundInfinite [1] is true iff an
    element of any X is inf or nan (false for an empty X list)."""
    inv = 1.0 / ins["Scale"][0]
    xs = ins["X"]
    if not xs:
        return {"Out": [], "FoundInfinite": torch.zeros(
            1, dtype=torch.bool, device=inv.device)}
    finite = torch.stack([torch.isfinite(x).all() for x in xs])
    return {"Out": [x * inv.to(x.dtype) for x in xs],
            "FoundInfinite": (~finite.all()).reshape(1)}


@register_op("update_loss_scaling", **_NON_DIFF)
def update_loss_scaling(ins, attrs):
    """One step of dynamic loss scaling: on an overflow the bad-step count
    goes up and the good one to 0, else the reverse; the scale is
    multiplied by ``decr_ratio`` once ``decr_every_n_nan_or_inf`` bad
    steps are counted and by ``incr_ratio`` once ``incr_every_n_steps``
    good ones are (that count then starts again at 0), and never falls
    below 1. On an overflow every X comes out zero."""
    found = ins["FoundInfinite"][0].reshape(())
    scale = ins["PrevLossScaling"][0]
    good, bad = ins["InGoodSteps"][0], ins["InBadSteps"][0]
    incr_every = int(attrs.get("incr_every_n_steps", 1000))
    decr_every = int(attrs.get("decr_every_n_nan_or_inf", 2))
    incr_ratio = float(attrs.get("incr_ratio", 2.0))
    decr_ratio = float(attrs.get("decr_ratio", 0.5))
    zero_bad, zero_good = torch.zeros_like(bad), torch.zeros_like(good)
    new_bad = torch.where(found, bad + 1, zero_bad)
    new_good = torch.where(found, zero_good, good + 1)
    do_decr = new_bad >= decr_every
    do_incr = new_good >= incr_every
    new_scale = torch.where(do_decr, scale * decr_ratio,
                            torch.where(do_incr, scale * incr_ratio, scale))
    new_scale = torch.maximum(new_scale, torch.ones_like(new_scale))
    zero = torch.zeros((), dtype=torch.float32, device=scale.device)
    return {"Out": [torch.where(found, zero.to(x.dtype), x)
                    for x in ins["X"]],
            "LossScaling": new_scale,
            "OutGoodSteps": torch.where(do_incr, zero_good, new_good),
            "OutBadSteps": torch.where(do_decr, zero_bad, new_bad)}
