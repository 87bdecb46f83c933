"""Functional ops of the training paths (``paddle_tpu/nn/functional``)."""
from .activation import (  # noqa: F401
    gelu, leaky_relu, relu, relu6, sigmoid, silu, softmax, tanh,
)
from .attention import (  # noqa: F401
    ring_flash_attention, scaled_dot_product_attention,
    sliding_window_attention, ulysses_attention,
)
from .common import dropout, linear  # noqa: F401
from .conv import conv1d, conv2d, conv3d  # noqa: F401
from .loss import (  # noqa: F401
    chunked_softmax_cross_entropy, cross_entropy,
)
from .norm import batch_norm, layer_norm, rms_norm  # noqa: F401
from .pooling import (  # noqa: F401
    adaptive_avg_pool1d, adaptive_avg_pool2d, adaptive_avg_pool3d,
    adaptive_max_pool2d, avg_pool1d, avg_pool2d, avg_pool3d, max_pool1d,
    max_pool2d, max_pool3d,
)

__all__ = ["silu", "gelu", "tanh", "softmax", "relu", "relu6", "sigmoid",
           "leaky_relu",
           "scaled_dot_product_attention", "sliding_window_attention",
           "ring_flash_attention", "ulysses_attention",
           "linear", "dropout", "cross_entropy",
           "chunked_softmax_cross_entropy", "rms_norm", "layer_norm",
           "batch_norm", "conv1d", "conv2d", "conv3d",
           "max_pool1d", "max_pool2d", "max_pool3d",
           "avg_pool1d", "avg_pool2d", "avg_pool3d",
           "adaptive_avg_pool1d", "adaptive_avg_pool2d",
           "adaptive_avg_pool3d", "adaptive_max_pool2d"]
