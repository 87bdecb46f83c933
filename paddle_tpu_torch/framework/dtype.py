"""Dtype names to torch dtypes.

Counterpart of ``paddle_tpu/framework/dtype.py``. The reference is
32-bit-first (``paddle_tpu/framework/core.py``: int64 input lands as
int32, float64 as float32), so token ids and block tables are int32 and
activations float32 or bfloat16 here too.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["to_torch_dtype"]

_BY_NAME = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
}


def to_torch_dtype(dtype) -> torch.dtype:
    """A dtype name (``"bfloat16"``), a numpy dtype or a torch dtype as a
    ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _BY_NAME[dtype if isinstance(dtype, str)
                        else np.dtype(dtype).name]
    except (KeyError, TypeError):
        raise ValueError(f"unsupported dtype {dtype!r}") from None
