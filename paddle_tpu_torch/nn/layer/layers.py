"""``Layer``, its containers and ``ParamAttr`` (counterpart of
``paddle_tpu/nn/layer/layers.py``).

``Layer`` is a ``torch.nn.Module``: parameters, buffers, sublayers,
``state_dict``, ``train``/``eval`` and hooks are torch's. It adds the
Paddle names the vision layers and their users call where they differ
from torch's: ``create_parameter``, ``register_buffer(...,
persistable=)``, ``set_state_dict`` and ``clear_gradients``. A
``state_dict`` key is the attribute path, as in the reference, so the
two packages' keys are the same.

A layer that creates parameters takes ``device`` (default ``"cuda"``:
raises without a GPU) and ``generator`` (a ``torch.Generator`` on that
device; when None, the device's generator of ``framework.random``,
which ``random.seed`` resets).
"""
from __future__ import annotations

import numpy as np
import torch

from ...framework import random
from ...framework.device import resolve_device
from ...framework.dtype import to_torch_dtype
from ...framework.io import to_tensor
from .. import initializer as I

__all__ = ["Layer", "Sequential", "LayerList", "Identity", "ParamAttr"]


class ParamAttr:
    """A parameter's ``initializer`` and ``trainable`` flag. ``name`` is
    accepted and not applied: a port parameter is named by its path in
    the model, as ``state_dict`` gives it."""

    def __init__(self, name=None, initializer=None, trainable=True):
        self.name = name
        self.initializer = initializer
        self.trainable = trainable

    @staticmethod
    def _to_attr(attr):
        """None, a ``ParamAttr``, a name, an initializer or False (no
        parameter) as a ``ParamAttr`` or False."""
        if attr is None:
            return ParamAttr()
        if attr is False or isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        raise TypeError(f"cannot convert {attr!r} to ParamAttr")


class Layer(torch.nn.Module):
    """``paddle.nn.Layer`` over ``torch.nn.Module``."""

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, *, device="cuda",
                         generator=None):
        """A parameter of ``shape`` on ``device`` filled by ``attr``'s
        initializer, else ``default_initializer``, else zeros for a bias
        and ``XavierNormal`` for a weight (the reference's defaults);
        None when ``attr`` is False. Not registered: assign it to an
        attribute."""
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dev = resolve_device(device)
        init = attr.initializer or default_initializer or (
            I.Constant(0.0) if is_bias else I.XavierNormal())
        t = torch.empty(tuple(shape), device=dev,
                        dtype=to_torch_dtype(dtype or self._dtype))
        init(t, generator if generator is not None
             else random.generator(dev))
        return torch.nn.Parameter(t, requires_grad=attr.trainable)

    def register_buffer(self, name, tensor, persistable=True):
        """Paddle's spelling of torch's ``register_buffer(...,
        persistent=)``: a buffer that is not persistable stays out of
        ``state_dict``."""
        super().register_buffer(name, tensor, persistent=persistable)
        return tensor

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Load ``state_dict`` (numpy arrays or tensors, by
        ``state_dict()``'s keys) into the parameters and persistable
        buffers. Each value is converted to its target's dtype and
        device and becomes the target's new storage, as the reference
        rebinds each array (a captured ``TrainStep`` sees the new
        addresses and captures again). Raises ``ValueError`` on a shape
        mismatch, before anything is written. Returns ``(missing_keys,
        unexpected_keys)``."""
        own = self.state_dict(keep_vars=True)
        missing = [k for k in own if k not in state_dict]
        unexpected = [k for k in state_dict if k not in own]
        values = {}
        for name, target in own.items():
            if name not in state_dict:
                continue
            v = state_dict[name]
            v = v.detach() if isinstance(v, torch.Tensor) \
                else to_tensor(np.asarray(v))
            if tuple(v.shape) != tuple(target.shape):
                raise ValueError(
                    f"shape mismatch for {name}: loaded {tuple(v.shape)} "
                    f"vs expected {tuple(target.shape)}")
            values[name] = v
        with torch.no_grad():
            for name, v in values.items():
                target = own[name]
                target.data = v.to(device=target.device, dtype=target.dtype,
                                   copy=True)
        return missing, unexpected

    def clear_gradients(self):
        """Drop every parameter's gradient."""
        for p in self.parameters():
            p.grad = None


class Sequential(Layer):
    """``Sequential(l0, l1, ...)`` or ``Sequential(("name", layer),
    ...)``: the layers called in order, keyed ``"0"``, ``"1"``, ... or
    by their names."""

    def __init__(self, *layers):
        super().__init__()
        for i, item in enumerate(layers):
            name, layer = item if isinstance(item, tuple) else (i, item)
            self.add_module(str(name), layer)

    def __getitem__(self, idx):
        layers = list(self._modules.values())
        if isinstance(idx, slice):
            return Sequential(*layers[idx])
        return layers[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class LayerList(Layer):
    """A list of layers, keyed ``"0"``, ``"1"``, ..."""

    def __init__(self, sublayers=None):
        super().__init__()
        for layer in sublayers or ():
            self.append(layer)

    def __getitem__(self, idx):
        layers = list(self._modules.values())
        if isinstance(idx, slice):
            return LayerList(layers[idx])
        return layers[int(idx)]

    def __setitem__(self, idx, layer):
        self.add_module(str(int(idx) % len(self)), layer)

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_module(str(len(self._modules)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._modules.clear()
        for layer in layers:
            self.append(layer)

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self


class Identity(Layer):
    """Returns its input; takes and ignores any arguments."""

    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x
