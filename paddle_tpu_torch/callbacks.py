"""``paddle.callbacks`` (counterpart of ``paddle_tpu/callbacks.py``): the
hapi training callbacks at the top level, the LR callback as
``LRScheduler``. ``VisualDL`` is not ported (ROADMAP A.7): the name
raises ``AttributeError`` naming that item."""
from .hapi.callbacks import (  # noqa: F401
    Callback, EarlyStopping, LRSchedulerCallback, ModelCheckpoint,
    ProgBarLogger, ReduceLROnPlateau,
)

# the reference exports the LR callback as `LRScheduler`
LRScheduler = LRSchedulerCallback

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "LRScheduler",
           "EarlyStopping", "ReduceLROnPlateau"]


def __getattr__(name):
    if name == "VisualDL":
        raise AttributeError(
            "paddle_tpu_torch.callbacks.VisualDL is not ported yet "
            "(ROADMAP A.7)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
