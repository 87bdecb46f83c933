"""Optimizers and learning-rate schedulers (``paddle_tpu/optimizer``)."""
from . import lr  # noqa: F401
from .lbfgs import LBFGS  # noqa: F401
from .optimizer import (  # noqa: F401
    SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, L1Decay, L2Decay, Lamb,
    Momentum, Optimizer, RMSProp,
)

__all__ = ["lr", "Optimizer", "LBFGS", "SGD", "Momentum", "Adagrad", "Adam", "AdamW",
           "Adamax", "RMSProp", "Lamb", "Adadelta", "L2Decay", "L1Decay"]
