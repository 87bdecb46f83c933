"""Layers' functional ops, ``Linear`` and gradient clipping
(``paddle_tpu/nn``)."""
from . import functional  # noqa: F401
from .clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
)
from .layer import Linear  # noqa: F401

__all__ = ["functional", "Linear", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue"]
