"""``paddle.summary`` and ``paddle.flops`` (counterpart of
``paddle_tpu/hapi/summary.py``).

Both run one forward of the network in eval mode on zeros of
``input_size`` (a dim that is not a positive int counts as 1), on the
device of the network's first parameter (else the current device), with
a forward post-hook on every sublayer. :func:`summary` prints the
reference's table (name, type, output shape and own parameters of each
sublayer that ran) and returns ``{"total_params", "trainable_params"}``;
:func:`flops` counts with the reference's rules: a ``Linear`` adds its
output's elements times its input features, a ``Conv2D`` its output's
elements times a filter's (``in / groups x kh x kw``), a type in
``custom_ops`` what its function returns, any other layer nothing.
"""
from __future__ import annotations

import math

import torch

from ..framework.device import current_device
from ..framework.dtype import to_torch_dtype

__all__ = ["summary", "flops"]


def _device(net):
    for p in net.parameters():
        return p.device
    return current_device()


def _make_input(input_size, dtype, device):
    if isinstance(input_size, (list, tuple)) and input_size and \
            isinstance(input_size[0], (list, tuple)):
        return [_make_input(s, dtype, device) for s in input_size]
    shape = [d if isinstance(d, int) and d > 0 else 1 for d in input_size]
    return torch.zeros(shape, dtype=to_torch_dtype(dtype), device=device)


def _numel(t):
    return math.prod(t.shape)


def summary(net, input_size=None, dtypes=None, input=None):  # noqa: A002
    """Print a table of the sublayers a forward runs; returns
    ``{"total_params": ..., "trainable_params": ...}``."""
    rows, hooks = [], []

    def register(layer, name):
        def hook(layer, inputs, outputs):
            n = sum(_numel(p) for _, p in
                    layer.named_parameters(include_sublayers=False))
            shape = (list(outputs.shape)
                     if isinstance(outputs, torch.Tensor) else "-")
            rows.append((name or type(layer).__name__,
                         type(layer).__name__, shape, n))

        hooks.append(layer.register_forward_post_hook(hook))

    for name, sub in net.named_sublayers():
        register(sub, name)
    dtype = dtypes[0] if isinstance(dtypes, (list, tuple)) else dtypes
    x = input if input is not None else _make_input(
        input_size, dtype or "float32", _device(net))
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(*x) if isinstance(x, list) else net(x)
    finally:
        if was_training:
            net.train()
        for h in hooks:
            h.remove()

    total = sum(_numel(p) for p in net.parameters())
    trainable = sum(_numel(p) for p in net.parameters() if p.requires_grad)
    width = 76
    print("-" * width)
    print(f"{'Layer (type)':<34}{'Output Shape':<26}{'Param #':<12}")
    print("=" * width)
    for name, cls, shape, n in rows:
        print(f"{name + ' (' + cls + ')':<34}{str(shape):<26}{n:<12}")
    print("=" * width)
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    print(f"Non-trainable params: {total - trainable:,}")
    print("-" * width)
    return {"total_params": total, "trainable_params": trainable}


def flops(net, input_size, custom_ops=None, print_detail=False):
    """The multiply-accumulates of one forward on zeros of
    ``input_size``, by the reference's rules."""
    from ..nn.layer.common import Linear
    from ..nn.layer.conv import Conv2D

    total = [0]
    hooks = []

    def hook(layer, inputs, outputs):
        if custom_ops and type(layer) in custom_ops:
            total[0] += int(custom_ops[type(layer)](layer, inputs, outputs))
        elif isinstance(layer, Linear):
            total[0] += _numel(outputs) * layer.weight.shape[0]
        elif isinstance(layer, Conv2D):
            total[0] += _numel(outputs) * _numel(layer.weight[0])

    for _, sub in net.named_sublayers():
        hooks.append(sub.register_forward_post_hook(hook))
    try:
        with torch.no_grad():
            net(_make_input(input_size, "float32", _device(net)))
    finally:
        for h in hooks:
            h.remove()
    if print_detail:
        print(f"Total Flops: {total[0]:,}")
    return total[0]
