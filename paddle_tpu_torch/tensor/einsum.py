"""Einsum (counterpart of ``paddle_tpu/tensor/einsum.py``): a white op
under ``auto_cast``."""
from __future__ import annotations

import torch

from ..amp.auto_cast import cast_inputs
from ._common import canon, tensors


def einsum(equation, *operands, name=None):
    return canon(torch.einsum(equation,
                              *cast_inputs("einsum", *tensors(*operands))))
