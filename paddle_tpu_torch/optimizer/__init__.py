"""Optimizers (``paddle_tpu/optimizer``)."""
from .optimizer import SGD, Adam, AdamW, Optimizer  # noqa: F401

__all__ = ["Optimizer", "SGD", "Adam", "AdamW"]
