"""AMP user API: ``auto_cast`` and ``GradScaler`` (port of
``paddle_tpu/amp.py`` :20-165).

Under ``auto_cast`` the tracer (``dygraph/tracer._maybe_autocast``)
casts a white-list op's fp32 inputs to the AMP dtype (bf16 by default)
and a black-list op's AMP-dtype inputs to fp32; other ops run in the
dtypes they get. ``GradScaler`` has the reference's dynamic loss-scaling
arithmetic; with bf16 (fp32's exponent range) it rarely sees an
overflow.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch

__all__ = ["auto_cast", "amp_guard", "GradScaler", "AmpScaler",
           "WHITE_LIST", "BLACK_LIST"]

WHITE_LIST = frozenset({"matmul", "matmul_v2", "mul", "bmm", "conv2d",
                        "depthwise_conv2d", "conv2d_transpose"})
BLACK_LIST = frozenset({"softmax", "log_softmax", "softmax_with_cross_entropy",
                        "cross_entropy", "layer_norm", "batch_norm",
                        "sync_batch_norm",
                        "group_norm", "mean", "reduce_mean", "reduce_sum",
                        "exp", "log", "sum"})

# the autocast state the tracer reads
_state = {"enable": False, "dtype": "bfloat16",
          "white": set(WHITE_LIST), "black": set(BLACK_LIST)}


def amp_state() -> Optional[dict]:
    return _state if _state["enable"] else None


@contextlib.contextmanager
def auto_cast(enable: bool = True, custom_white_list: Sequence[str] = None,
              custom_black_list: Sequence[str] = None,
              level: str = "O1", dtype: str = "bfloat16"):
    """Dygraph autocast region (reference: amp/auto_cast.py auto_cast)."""
    old = dict(_state)
    white = set(WHITE_LIST) | set(custom_white_list or [])
    black = (set(BLACK_LIST) | set(custom_black_list or [])) - white
    _state.update(enable=enable, dtype=dtype, white=white, black=black)
    try:
        yield
    finally:
        _state.update(old)


amp_guard = auto_cast  # the fluid name


class GradScaler:
    """Dynamic loss scaling for dygraph training (reference:
    fluid/dygraph/amp/loss_scaler.py AmpScaler, paddle.amp.GradScaler):
    ``scale(loss)``, ``backward()``, then ``minimize(opt, scaled)`` or
    ``step(opt)`` + ``update()``. The overflow check reads one flag per
    step from the device."""

    def __init__(self, enable: bool = True,
                 init_loss_scaling: float = 2.0 ** 15,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 2,
                 use_dynamic_loss_scaling: bool = True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good = 0
        self._bad = 0
        self._found_inf = False
        self._unscaled = False

    def is_enable(self) -> bool:
        return self._enable

    def get_loss_scaling(self) -> float:
        return self._scale

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def _params_with_grads(self, optimizer) -> List:
        return [p for p in (optimizer._parameter_list or [])
                if p._tensor.grad is not None]

    def unscale_(self, optimizer):
        """Divide the gradients by the scale in place and record whether
        any is not finite (reference: AmpScaler._unscale)."""
        if not self._enable or self._unscaled:
            return
        inv = 1.0 / self._scale
        finite = []
        with torch.no_grad():
            for p in self._params_with_grads(optimizer):
                g = p._tensor.grad
                finite.append(torch.isfinite(g).all())
                g.mul_(torch.tensor(inv, dtype=g.dtype))
        self._found_inf = bool(finite) and \
            not bool(torch.stack(finite).all().item())
        self._unscaled = True

    def minimize(self, optimizer, scaled_loss=None, *args, **kwargs):
        if not self._enable:
            return optimizer.minimize(scaled_loss, *args, **kwargs)
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.minimize(scaled_loss, *args, **kwargs)
        self.update()

    def step(self, optimizer):
        """2.0 style: unscale, then step unless a gradient overflowed."""
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()

    def update(self):
        if not self._enable:
            return
        if self._dynamic:
            if self._found_inf:
                self._bad += 1
                self._good = 0
                if self._bad >= self._decr_every:
                    self._scale = max(self._scale * self._decr_ratio, 1.0)
                    self._bad = 0
            else:
                self._good += 1
                self._bad = 0
                if self._good >= self._incr_every:
                    self._scale *= self._incr_ratio
                    self._good = 0
        self._found_inf = False
        self._unscaled = False

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio, "good": self._good,
                "bad": self._bad}

    def set_state_dict(self, state):
        self._scale = float(state.get("scale", self._scale))
        self._good = int(state.get("good", self._good))
        self._bad = int(state.get("bad", self._bad))


AmpScaler = GradScaler  # the fluid name
