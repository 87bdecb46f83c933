"""Layers, their functional ops, initializers and gradient clipping
(``paddle_tpu/nn``)."""
from . import functional, initializer  # noqa: F401
from .clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
)
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layers

__all__ = ["functional", "initializer", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", *_layers]
