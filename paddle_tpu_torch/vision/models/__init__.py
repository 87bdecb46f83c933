"""The vision model zoo's ported part: LeNet and the ResNet family
(``paddle_tpu/vision/models``), with ``load_jax_weights``."""
from ...nn.layer.layers import load_jax_weights  # noqa: F401
from .lenet import LeNet  # noqa: F401
from .resnet import (  # noqa: F401
    BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34, resnet50,
    resnet101, resnet152, resnext50_32x4d, wide_resnet50_2,
    wide_resnet101_2,
)

__all__ = ["LeNet", "ResNet", "BasicBlock", "BottleneckBlock",
           "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
           "wide_resnet50_2", "wide_resnet101_2", "resnext50_32x4d",
           "load_jax_weights"]
