"""Layers (counterpart of ``paddle_tpu/nn/layer``)."""
from .activation import LeakyReLU, ReLU, ReLU6, Sigmoid  # noqa: F401
from .common import Dropout, Flatten, Linear  # noqa: F401
from .conv import Conv1D, Conv2D, Conv3D  # noqa: F401
from .layers import (  # noqa: F401
    Identity, Layer, LayerList, ParamAttr, Sequential,
)
from .loss import CrossEntropyLoss  # noqa: F401
from .norm import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
)
from .pooling import (  # noqa: F401
    AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
    AdaptiveMaxPool2D, AvgPool1D, AvgPool2D, AvgPool3D, MaxPool1D,
    MaxPool2D, MaxPool3D,
)

__all__ = ["Layer", "Sequential", "LayerList", "Identity", "ParamAttr",
           "Linear", "Flatten", "Dropout", "ReLU", "ReLU6", "Sigmoid",
           "LeakyReLU", "Conv1D", "Conv2D", "Conv3D", "BatchNorm",
           "BatchNorm1D", "BatchNorm2D", "BatchNorm3D", "MaxPool1D",
           "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool2D", "CrossEntropyLoss"]
