"""Var kinds and dtype names.

VarDescs keep numpy dtypes (the JSON form names them as numpy does, so a
program exported by ``paddle_tpu`` loads here unchanged); lowerings work
on ``torch.dtype``. This module maps between the two."""

from __future__ import annotations

import enum
from typing import Any

import numpy as np
import torch


class VarType(enum.Enum):
    """Variable kinds (reference: framework.proto VarType::Type)."""

    DENSE_TENSOR = "dense_tensor"
    SELECTED_ROWS = "selected_rows"
    TENSOR_ARRAY = "tensor_array"
    STEP_SCOPES = "step_scopes"
    READER = "reader"
    RAW = "raw"

    LOD_TENSOR = "dense_tensor"


_DTYPE_ALIASES = {
    "fp32": "float32", "fp64": "float64", "fp16": "float16",
    "bf16": "bfloat16",
}

class _BFloat16:
    """Stand-in for the bfloat16 dtype of a VarDesc: numpy has none, and
    the port does not depend on ``ml_dtypes``. A singleton, named as
    ``ml_dtypes.bfloat16`` names itself, so both packages write the same
    JSON."""

    name = "bfloat16"
    itemsize = 2

    def __repr__(self):
        return "bfloat16"

    __str__ = __repr__


BFLOAT16 = _BFloat16()

_NP_TO_TORCH = {
    np.dtype("float32"): torch.float32,
    np.dtype("float64"): torch.float64,
    np.dtype("float16"): torch.float16,
    np.dtype("int8"): torch.int8,
    np.dtype("uint8"): torch.uint8,
    np.dtype("int16"): torch.int16,
    np.dtype("int32"): torch.int32,
    np.dtype("int64"): torch.int64,
    np.dtype("bool"): torch.bool,
}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


def convert_dtype(dtype: Any):
    """Canonicalise a dtype spec (string alias, numpy or torch dtype) to
    the dtype a VarDesc stores: a numpy dtype, or ``BFLOAT16``."""
    if dtype is None:
        return np.dtype("float32")
    if dtype is BFLOAT16 or dtype is torch.bfloat16:
        return BFLOAT16
    if isinstance(dtype, torch.dtype):
        if dtype not in _TORCH_TO_NP:
            raise TypeError(f"dtype {dtype} has no VarDesc form in the port")
        return _TORCH_TO_NP[dtype]
    if isinstance(dtype, str):
        dtype = _DTYPE_ALIASES.get(dtype, dtype)
    if getattr(dtype, "name", dtype) == "bfloat16" or \
            getattr(dtype, "__name__", None) == "bfloat16":
        return BFLOAT16          # the string, or an ml_dtypes dtype
    return np.dtype(dtype)


def dtype_name(dtype: Any) -> str:
    """The JSON name of a VarDesc dtype."""
    dtype = convert_dtype(dtype)
    return "bfloat16" if dtype is BFLOAT16 else str(dtype)


def to_torch_dtype(dtype: Any) -> torch.dtype:
    """VarDesc dtype (or any spec convert_dtype takes) -> torch.dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    dtype = convert_dtype(dtype)
    return torch.bfloat16 if dtype is BFLOAT16 else _NP_TO_TORCH[dtype]


def x64_off(dtype: torch.dtype) -> torch.dtype:
    """The reference runs with 64-bit types disabled: an int64 or float64
    array becomes int32 or float32 the moment it reaches the device. The
    port's shape inference and feeds follow the same rule, so that both
    packages record the same dtypes."""
    return {torch.int64: torch.int32,
            torch.float64: torch.float32}.get(dtype, dtype)
