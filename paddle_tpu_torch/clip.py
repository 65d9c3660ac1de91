"""Gradient clipping (port of ``paddle_tpu/clip.py``; reference
python/paddle/fluid/clip.py GradientClipByValue:186, GradientClipByNorm:261
and GradientClipByGlobalNorm:341; 2.0 names them nn.ClipGradBy*).

Each class is a callable over params_grads that the Optimizer calls
between ``backward`` and the update ops (``optimizer/__init__.py``); it
appends its ops to the current program, op for op as the reference
does."""

from __future__ import annotations

__all__ = ["GradientClipBase", "GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]


class GradientClipBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class GradientClipByValue(GradientClipBase):
    """g <- clamp(g, min, max); min defaults to -max."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, params_grads):
        from . import layers

        return [(p, g if g is None else layers.clip(g, self.min, self.max))
                for p, g in params_grads]


class GradientClipByNorm(GradientClipBase):
    """Each gradient on its own: g <- g * clip_norm / max(||g||,
    clip_norm)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        from . import layers

        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            norm = layers.sqrt(layers.reduce_sum(layers.square(g)))
            denom = layers.elementwise_max(
                norm, layers.fill_constant([1], "float32", self.clip_norm))
            out.append((p, g * (self.clip_norm / denom)))
        return out


class GradientClipByGlobalNorm(GradientClipBase):
    """Every gradient by one factor: clip_norm / max(global_norm,
    clip_norm), global_norm = sqrt(sum_i ||g_i||^2)."""

    def __init__(self, clip_norm, group_name: str = "default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def __call__(self, params_grads):
        from . import layers

        sq_sums = [layers.reduce_sum(layers.square(g))
                   for _, g in params_grads if g is not None]
        if not sq_sums:
            return list(params_grads)
        total = sq_sums[0]
        for s in sq_sums[1:]:
            total = total + s
        denom = layers.elementwise_max(
            layers.sqrt(total),
            layers.fill_constant([1], "float32", self.clip_norm))
        scale = self.clip_norm / denom
        return [(p, g if g is None else g * scale) for p, g in params_grads]


ClipGradByValue = GradientClipByValue
ClipGradByNorm = GradientClipByNorm
ClipGradByGlobalNorm = GradientClipByGlobalNorm
