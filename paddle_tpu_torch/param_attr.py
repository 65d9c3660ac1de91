"""ParamAttr (reference: python/paddle/fluid/param_attr.py)."""

from __future__ import annotations

from typing import Optional


class ParamAttr:
    def __init__(self, name: Optional[str] = None, initializer=None,
                 trainable: bool = True):
        self.name = name
        self.initializer = initializer
        self.trainable = trainable

    @staticmethod
    def _to_attr(arg) -> Optional["ParamAttr"]:
        """None -> default, False -> no parameter, str -> named,
        Initializer -> initializer, ParamAttr -> itself."""
        if arg is None:
            return ParamAttr()
        if arg is False:
            return None
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        from .initializer import Initializer

        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        raise TypeError(f"cannot convert {type(arg)} to ParamAttr")
