"""hapi: the high-level ``Model`` and its callbacks (``paddle_tpu/hapi``).
Not ported: ``summary.py`` (ROADMAP queue A.7)."""
from .callbacks import (  # noqa: F401
    Callback, CallbackList, EarlyStopping, LRSchedulerCallback,
    ModelCheckpoint, ProgBarLogger, ReduceLROnPlateau, config_callbacks,
)
from .model import Model  # noqa: F401

__all__ = ["Model", "Callback", "CallbackList", "ProgBarLogger",
           "ModelCheckpoint", "EarlyStopping", "LRSchedulerCallback",
           "ReduceLROnPlateau", "config_callbacks"]
