"""Functional ops of the training path (``paddle_tpu/nn/functional``)."""
from .activation import silu  # noqa: F401
from .attention import (  # noqa: F401
    scaled_dot_product_attention, sliding_window_attention,
)
from .loss import cross_entropy  # noqa: F401
from .norm import rms_norm  # noqa: F401

__all__ = ["silu", "scaled_dot_product_attention",
           "sliding_window_attention", "cross_entropy", "rms_norm"]
