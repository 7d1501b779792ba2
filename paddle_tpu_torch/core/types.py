"""Core type system: named dtypes and variable kinds, mapped onto numpy
and torch dtypes.

The port runs in 32 bits at the feed boundary, as the JAX package does with
x64 off: int64/float64 declarations narrow to int32/float32 (`np_feed_dtype`,
`torch_feed_dtype`).
"""
from __future__ import annotations

import enum

import numpy as np
import torch


class VarKind(enum.Enum):
    """What a Variable holds."""

    DENSE_TENSOR = "dense_tensor"
    SELECTED_ROWS = "selected_rows"
    READER = "reader"
    STEP_SCOPES = "step_scopes"
    RAW = "raw"


class DType(enum.Enum):
    """Named dtypes; values are the canonical string spelling."""

    FP64 = "float64"
    FP32 = "float32"
    FP16 = "float16"
    BF16 = "bfloat16"
    INT64 = "int64"
    INT32 = "int32"
    INT16 = "int16"
    INT8 = "int8"
    UINT8 = "uint8"
    BOOL = "bool"

    @property
    def torch(self) -> torch.dtype:
        return _TORCH_MAP[self]

    @staticmethod
    def parse(x) -> "DType":
        if isinstance(x, DType):
            return x
        if isinstance(x, str):
            return DType(_STR_ALIASES.get(x, x))
        if isinstance(x, torch.dtype):
            return _FROM_TORCH[x]
        return DType(np.dtype(x).name)


_TORCH_MAP = {
    DType.FP64: torch.float64,
    DType.FP32: torch.float32,
    DType.FP16: torch.float16,
    DType.BF16: torch.bfloat16,
    DType.INT64: torch.int64,
    DType.INT32: torch.int32,
    DType.INT16: torch.int16,
    DType.INT8: torch.int8,
    DType.UINT8: torch.uint8,
    DType.BOOL: torch.bool,
}
_FROM_TORCH = {v: k for k, v in _TORCH_MAP.items()}

_STR_ALIASES = {
    "float": "float32",
    "double": "float64",
    "int": "int32",
    "long": "int64",
    "bf16": "bfloat16",
    "fp16": "float16",
    "fp32": "float32",
    "fp64": "float64",
}

_NARROW = {DType.INT64: DType.INT32, DType.FP64: DType.FP32}


def np_dtype(dtype) -> np.dtype:
    """Resolve a dtype spelling to numpy (numpy has no bfloat16)."""
    d = DType.parse(dtype)
    if d is DType.BF16:
        raise TypeError("numpy has no bfloat16; use torch_dtype()")
    return np.dtype(d.value)


def torch_dtype(dtype) -> torch.dtype:
    return DType.parse(dtype).torch


def np_feed_dtype(dtype) -> np.dtype:
    """The dtype a FEED array is cast to: int64/float64 narrow to 32 bits."""
    d = DType.parse(dtype)
    return np_dtype(_NARROW.get(d, d))


def is_floating(dtype) -> bool:
    return DType.parse(dtype) in (DType.FP64, DType.FP32, DType.FP16, DType.BF16)


def torch_feed_dtype(dtype) -> torch.dtype:
    d = DType.parse(dtype)
    return _NARROW.get(d, d).torch

