"""The dtype names as torch dtypes, and the default dtype.

Counterpart of ``paddle_tpu/framework/dtype.py``. The reference's names
(``paddle.float32``, ``paddle.bfloat16``, ...) are numpy dtypes there and
torch dtypes here, so ``paddle.float32`` goes straight into a torch
call. The reference is 32-bit-first (``paddle_tpu/framework/core.py``:
int64 input lands as int32, float64 as float32), so token ids and block
tables are int32 and activations float32 or bfloat16 here too.

:func:`set_default_dtype` chooses the floating dtype that an initializer
called on a shape (``nn.initializer.Normal()([2, 3])``) draws in, as
the reference's initializers read it.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

__all__ = ["to_torch_dtype", "convert_dtype", "dtype_name",
           "is_floating_point", "is_integer", "is_complex",
           "set_default_dtype", "get_default_dtype", "bool", "uint8", "int8",
           "int16", "int32", "int64", "float16", "bfloat16", "float32",
           "float64", "complex64", "complex128"]

bool = torch.bool  # noqa: A001 - Paddle's public name
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_BY_NAME = {
    "bool": bool,
    "uint8": uint8,
    "int8": int8,
    "int16": int16,
    "int32": int32,
    "int64": int64,
    "float16": float16,
    "bfloat16": bfloat16,
    "float32": float32,
    "float64": float64,
    "complex64": complex64,
    "complex128": complex128,
}
# the reference's VarDesc-style names (``dtype.py:38-48``)
_ALIASES = dict(_BY_NAME, FP16=float16, FP32=float32, FP64=float64,
                BF16=bfloat16, INT8=int8, INT16=int16, INT32=int32,
                INT64=int64, BOOL=bool, UINT8=uint8)
_NAMES = {d: n for n, d in _BY_NAME.items()}

_FLOATING = {float16, bfloat16, float32, float64}
_INTEGER = {uint8, int8, int16, int32, int64}
_COMPLEX = {complex64, complex128}

_default_dtype = [float32]


def to_torch_dtype(dtype) -> torch.dtype:
    """A dtype name (``"bfloat16"``), a numpy dtype or a torch dtype as a
    ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _ALIASES[dtype if isinstance(dtype, str)
                        else np.dtype(dtype).name]
    except (KeyError, TypeError):
        raise ValueError(f"unsupported dtype {dtype!r}") from None


def convert_dtype(dtype):
    """A dtype in any accepted form as a torch dtype; None stays None
    (``dtype.py:64``)."""
    return None if dtype is None else to_torch_dtype(dtype)


def dtype_name(dtype) -> str:
    """The reference's name of ``dtype`` (``"float32"``, ``"bfloat16"``)."""
    return _NAMES[to_torch_dtype(dtype)]


def is_floating_point(dtype) -> builtins.bool:
    return convert_dtype(dtype) in _FLOATING


def is_integer(dtype) -> builtins.bool:
    return convert_dtype(dtype) in _INTEGER


def is_complex(dtype) -> builtins.bool:
    return convert_dtype(dtype) in _COMPLEX


def set_default_dtype(dtype):
    """Make ``dtype`` (floating point) the default; raises ``TypeError``
    for any other."""
    d = convert_dtype(dtype)
    if d not in _FLOATING:
        raise TypeError(f"default dtype must be floating point, got {dtype}")
    _default_dtype[0] = d


def get_default_dtype() -> torch.dtype:
    return _default_dtype[0]
