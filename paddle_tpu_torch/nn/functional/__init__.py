"""Functional ops of the training paths (``paddle_tpu/nn/functional``)."""
from .activation import gelu, silu, tanh  # noqa: F401
from .attention import (  # noqa: F401
    scaled_dot_product_attention, sliding_window_attention,
)
from .common import dropout  # noqa: F401
from .loss import cross_entropy  # noqa: F401
from .norm import layer_norm, rms_norm  # noqa: F401

__all__ = ["silu", "gelu", "tanh", "scaled_dot_product_attention",
           "sliding_window_attention", "dropout", "cross_entropy",
           "rms_norm", "layer_norm"]
