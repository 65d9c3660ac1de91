"""Weight-decay regularizers (port of ``paddle_tpu/regularizer.py``;
reference python/paddle/fluid/regularizer.py).

``append_regularization_ops`` adds ``grad += coeff * param`` (L2) or
``grad += coeff * sign(param)`` (L1) ops before the optimizer ops: the
same program rewrite as the reference, op for op."""

from __future__ import annotations

__all__ = ["L2Decay", "L1Decay", "L2DecayRegularizer", "L1DecayRegularizer",
           "append_regularization_ops"]


class WeightDecayRegularizer:
    def __init__(self, regularization_coeff: float = 0.0):
        self._coeff = regularization_coeff


class L2Decay(WeightDecayRegularizer):
    def append(self, block, param, grad):
        scaled = block.create_var(stop_gradient=True, dtype=grad.dtype)
        block.append_op("scale", {"X": [param]}, {"Out": [scaled]},
                        {"scale": self._coeff})
        out = block.create_var(stop_gradient=True, dtype=grad.dtype)
        block.append_op("sum", {"X": [grad, scaled]}, {"Out": [out]}, {})
        return out


class L1Decay(WeightDecayRegularizer):
    def append(self, block, param, grad):
        sign = block.create_var(stop_gradient=True, dtype=grad.dtype)
        block.append_op("sign", {"X": [param]}, {"Out": [sign]}, {})
        scaled = block.create_var(stop_gradient=True, dtype=grad.dtype)
        block.append_op("scale", {"X": [sign]}, {"Out": [scaled]},
                        {"scale": self._coeff})
        out = block.create_var(stop_gradient=True, dtype=grad.dtype)
        block.append_op("sum", {"X": [grad, scaled]}, {"Out": [out]}, {})
        return out


L2DecayRegularizer = L2Decay
L1DecayRegularizer = L1Decay


def append_regularization_ops(params_grads, global_regularizer=None):
    """Each (param, grad) with the param's own ``regularizer`` or the
    global one applied to its grad; the others as they are."""
    out = []
    for p, g in params_grads:
        reg = getattr(p, "regularizer", None) or global_regularizer
        if reg is None or g is None:
            out.append((p, g))
            continue
        # the current block, where the optimizer ops go
        block = p.block.program.current_block()
        out.append((p, reg.append(block, p, g)))
    return out
