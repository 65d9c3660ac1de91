"""Static-graph AMP (port of ``paddle_tpu/contrib/mixed_precision.py``):
``decorate(optimizer)`` wraps an optimizer so that ``minimize`` rewrites
the program with bf16 casts on white-list ops and, with dynamic loss
scaling, scales the loss and unscales the gradients
(``distributed/fleet/meta_optimizers.py``)."""

from __future__ import annotations

from typing import Optional, Sequence

from ..distributed.fleet.meta_optimizers import (AMP_BLACK_LIST,
                                                 AMP_WHITE_LIST, AMPOptimizer)

__all__ = ["decorate", "AutoMixedPrecisionLists", "CustomOpLists"]


class AutoMixedPrecisionLists:
    """reference: fp16_lists.py AutoMixedPrecisionLists."""

    def __init__(self, custom_white_list: Sequence[str] = None,
                 custom_black_list: Sequence[str] = None,
                 custom_black_varnames: Sequence[str] = None):
        self.white_list = set(AMP_WHITE_LIST) | set(custom_white_list or [])
        self.black_list = (set(AMP_BLACK_LIST) | set(custom_black_list or [])) \
            - set(custom_white_list or [])
        self.black_varnames = set(custom_black_varnames or [])


CustomOpLists = AutoMixedPrecisionLists


def decorate(optimizer, amp_lists: Optional[AutoMixedPrecisionLists] = None,
             init_loss_scaling: float = 2.0 ** 15,
             incr_every_n_steps: int = 1000,
             decr_every_n_nan_or_inf: int = 2, incr_ratio: float = 2.0,
             decr_ratio: float = 0.8, use_dynamic_loss_scaling: bool = True,
             use_pure_fp16: bool = False, use_fp16_guard=None):
    """An AMPOptimizer around ``optimizer`` (reference: decorator.py
    decorate), whose ``minimize`` runs the bf16 rewrite and, with
    ``use_dynamic_loss_scaling``, the loss-scaling ops. As in the
    reference, the scaling ops take their defaults for the incr/decr
    settings, which are recorded here but not read (ROADMAP C)."""
    lists = amp_lists or AutoMixedPrecisionLists()
    return AMPOptimizer(optimizer, {
        "custom_white_list": sorted(lists.white_list - set(AMP_WHITE_LIST)),
        "custom_black_list": sorted(lists.black_list - set(AMP_BLACK_LIST)),
        "init_loss_scaling": init_loss_scaling,
        "incr_every_n_steps": incr_every_n_steps,
        "decr_every_n_nan_or_inf": decr_every_n_nan_or_inf,
        "incr_ratio": incr_ratio, "decr_ratio": decr_ratio,
        "use_dynamic_loss_scaling": use_dynamic_loss_scaling,
    })
