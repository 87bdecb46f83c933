"""The train step and the captured-graph cache (``paddle_tpu/jit``)."""
from . import exec_cache  # noqa: F401
from .train_step import AsyncStepper, TrainStep  # noqa: F401

__all__ = ["TrainStep", "AsyncStepper", "exec_cache"]
