"""Static-graph AMP (port of ``paddle_tpu/contrib/mixed_precision.py``):
``decorate(optimizer)`` wraps an optimizer so that ``minimize`` rewrites
the program with bf16 casts on white-list ops
(``distributed/fleet/meta_optimizers.py``)."""

from __future__ import annotations

from typing import Optional, Sequence

from ..distributed.fleet.meta_optimizers import (AMP_BLACK_LIST,
                                                 AMP_WHITE_LIST, AMPOptimizer)

__all__ = ["decorate", "AutoMixedPrecisionLists"]


class AutoMixedPrecisionLists:
    """reference: fp16_lists.py AutoMixedPrecisionLists."""

    def __init__(self, custom_white_list: Sequence[str] = None,
                 custom_black_list: Sequence[str] = None,
                 custom_black_varnames: Sequence[str] = None):
        self.white_list = set(AMP_WHITE_LIST) | set(custom_white_list or [])
        self.black_list = (set(AMP_BLACK_LIST) | set(custom_black_list or [])) \
            - set(custom_white_list or [])
        self.black_varnames = set(custom_black_varnames or [])


def decorate(optimizer, amp_lists: Optional[AutoMixedPrecisionLists] = None,
             use_dynamic_loss_scaling: bool = True):
    """An AMPOptimizer around ``optimizer`` (reference: decorator.py
    decorate). The loss-scaling settings of the reference are not in the
    port: ``use_dynamic_loss_scaling=True`` raises NotImplementedError."""
    lists = amp_lists or AutoMixedPrecisionLists()
    return AMPOptimizer(optimizer, {
        "custom_white_list": sorted(lists.white_list - set(AMP_WHITE_LIST)),
        "use_dynamic_loss_scaling": use_dynamic_loss_scaling,
    })
