"""hapi: the high-level ``Model``, its callbacks, ``summary`` and
``flops`` (``paddle_tpu/hapi``)."""
from .callbacks import (  # noqa: F401
    Callback, CallbackList, EarlyStopping, LRSchedulerCallback,
    ModelCheckpoint, ProgBarLogger, ReduceLROnPlateau, config_callbacks,
)
from .model import Model  # noqa: F401
from .summary import flops, summary  # noqa: F401

__all__ = ["Model", "Callback", "CallbackList", "ProgBarLogger",
           "ModelCheckpoint", "EarlyStopping", "LRSchedulerCallback",
           "ReduceLROnPlateau", "config_callbacks", "summary", "flops"]
