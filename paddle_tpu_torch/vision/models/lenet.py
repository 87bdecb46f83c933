"""LeNet (counterpart of ``paddle_tpu/vision/models/lenet.py``), on
``[N, 1, 28, 28]`` images. Weights are drawn from ``generator`` (on
``device``; a fresh one seeded with 0 when None)."""
from __future__ import annotations

import torch

from ...framework.device import current_device, resolve_device
from ...nn import functional as F
from ...nn.layer.common import Linear
from ...nn.layer.conv import Conv2D
from ...nn.layer.layers import Layer
from ...nn.layer.pooling import MaxPool2D

__all__ = ["LeNet"]


class LeNet(Layer):
    def __init__(self, num_classes=10, *, device=None, generator=None):
        super().__init__()
        dev = current_device() if device is None \
            else resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        at = dict(device=dev, generator=generator)
        self.num_classes = num_classes
        self.conv1 = Conv2D(1, 6, 3, stride=1, padding=1, **at)
        self.pool1 = MaxPool2D(2, 2)
        self.conv2 = Conv2D(6, 16, 5, stride=1, padding=0, **at)
        self.pool2 = MaxPool2D(2, 2)
        if num_classes > 0:
            self.fc1 = Linear(400, 120, **at)
            self.fc2 = Linear(120, 84, **at)
            self.fc3 = Linear(84, num_classes, **at)

    def forward(self, x):
        x = self.pool1(F.relu(self.conv1(x)))
        x = self.pool2(F.relu(self.conv2(x)))
        if self.num_classes > 0:
            x = x.flatten(1)
            x = F.relu(self.fc1(x))
            x = F.relu(self.fc2(x))
            x = self.fc3(x)
        return x
