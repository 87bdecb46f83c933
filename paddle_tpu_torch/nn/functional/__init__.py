"""Functional ops of the training paths (``paddle_tpu/nn/functional``)."""
from .activation import gelu, silu, softmax, tanh  # noqa: F401
from .attention import (  # noqa: F401
    ring_flash_attention, scaled_dot_product_attention,
    sliding_window_attention, ulysses_attention,
)
from .common import dropout, linear  # noqa: F401
from .loss import (  # noqa: F401
    chunked_softmax_cross_entropy, cross_entropy,
)
from .norm import layer_norm, rms_norm  # noqa: F401

__all__ = ["silu", "gelu", "tanh", "softmax",
           "scaled_dot_product_attention", "sliding_window_attention",
           "ring_flash_attention", "ulysses_attention",
           "linear", "dropout", "cross_entropy",
           "chunked_softmax_cross_entropy", "rms_norm", "layer_norm"]
