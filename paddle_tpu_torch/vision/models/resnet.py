"""The ResNet family (counterpart of
``paddle_tpu/vision/models/resnet.py``): BASELINE config 2's model.

``data_format="NHWC"`` runs every conv, batch norm and pool channel-last
(inputs ``[N, H, W, C]``): each layer moves its input to a
``channels_last`` view and back, so no activation is copied for its
layout; the FC head is layout-free after the pool. The weights and the
``state_dict`` are the same in both layouts.

Weights are drawn from ``generator`` (a ``torch.Generator`` on
``device``; a fresh one seeded with 0 when None), every layer from the
one generator in construction order.
"""
from __future__ import annotations

import torch

from ...framework.device import current_device, resolve_device
from ...nn import functional as F
from ...nn.layer.common import Linear
from ...nn.layer.conv import Conv2D
from ...nn.layer.layers import Layer, Sequential
from ...nn.layer.norm import BatchNorm2D
from ...nn.layer.pooling import AdaptiveAvgPool2D, MaxPool2D
from ._pretrained import require_no_pretrained

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "wide_resnet50_2", "wide_resnet101_2", "resnext50_32x4d"]


class BasicBlock(Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", *, device=None, generator=None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        at = dict(data_format=data_format, device=device,
                  generator=generator)
        self.conv1 = Conv2D(inplanes, planes, 3, padding=1, stride=stride,
                            bias_attr=False, **at)
        self.bn1 = norm_layer(planes, **at)
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                            **at)
        self.bn2 = norm_layer(planes, **at)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return F.relu(out + identity)


class BottleneckBlock(Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", *, device=None, generator=None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        at = dict(data_format=data_format, device=device,
                  generator=generator)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False, **at)
        self.bn1 = norm_layer(width, **at)
        self.conv2 = Conv2D(width, width, 3, padding=dilation, stride=stride,
                            groups=groups, dilation=dilation,
                            bias_attr=False, **at)
        self.bn2 = norm_layer(width, **at)
        self.conv3 = Conv2D(width, planes * self.expansion, 1,
                            bias_attr=False, **at)
        self.bn3 = norm_layer(planes * self.expansion, **at)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return F.relu(out + identity)


class ResNet(Layer):
    """``paddle.vision.models.ResNet``: ``depth`` 18, 34, 50, 101 or 152;
    ``width`` the bottleneck's base width, ``groups`` its conv groups;
    ``with_pool`` the global average pool; ``num_classes`` 0: no FC
    head."""

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, data_format="NCHW", *,
                 device=None, generator=None):
        super().__init__()
        if data_format not in ("NCHW", "NHWC"):
            raise ValueError(f"data_format must be NCHW or NHWC, got "
                             f"{data_format!r}")
        dev = current_device() if device is None \
            else resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        layers = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                  101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]
        self.data_format = data_format
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.inplanes = 64
        self.dilation = 1
        at = dict(device=dev, generator=generator, data_format=data_format)
        self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                            bias_attr=False, **at)
        self.bn1 = BatchNorm2D(self.inplanes, **at)
        self.maxpool = MaxPool2D(kernel_size=3, stride=2, padding=1,
                                 data_format=data_format)
        self.layer1 = self._make_layer(block, 64, layers[0], 1, at)
        self.layer2 = self._make_layer(block, 128, layers[1], 2, at)
        self.layer3 = self._make_layer(block, 256, layers[2], 2, at)
        self.layer4 = self._make_layer(block, 512, layers[3], 2, at)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1), data_format=data_format)
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes, device=dev,
                             generator=generator)

    def _make_layer(self, block, planes, blocks, stride, at):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, **at),
                BatchNorm2D(planes * block.expansion, **at),
            )
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, **at)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, **at))
        return Sequential(*layers)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.fc(x)
        return x


def _resnet(name, pretrained, block, depth, **kwargs):
    require_no_pretrained(name, pretrained)
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet("resnet18", pretrained, BasicBlock, 18, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet("resnet34", pretrained, BasicBlock, 34, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet("resnet50", pretrained, BottleneckBlock, 50, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet("resnet101", pretrained, BottleneckBlock, 101, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet("resnet152", pretrained, BottleneckBlock, 152, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return _resnet("wide_resnet50_2", pretrained, BottleneckBlock, 50,
                   width=128, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    return _resnet("wide_resnet101_2", pretrained, BottleneckBlock, 101,
                   width=128, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnet("resnext50_32x4d", pretrained, BottleneckBlock, 50,
                   groups=32, width=4, **kwargs)
