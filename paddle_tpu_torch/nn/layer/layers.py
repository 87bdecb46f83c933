"""``Layer``, its containers and ``ParamAttr`` (counterpart of
``paddle_tpu/nn/layer/layers.py``).

``Layer`` is a ``torch.nn.Module`` with Paddle's API where the two
differ (``layers.py:64-350``): ``parameters()`` and ``buffers()`` return
lists and take ``include_sublayers`` (torch's ``recurse`` still works,
for torch's own internals), ``sublayers``/``named_sublayers``,
``add_sublayer``/``add_parameter``, ``create_parameter``,
``register_buffer(..., persistable=)``, ``set_state_dict``,
``clear_gradients``, ``astype``, ``full_name``, Paddle's ``to(device,
dtype, blocking)`` (``"gpu"``, ``"gpu:0"``, ``"cpu"``, dtype names) and
``register_forward_pre_hook``/``register_forward_post_hook``, whose
non-None result replaces the inputs or the output (torch's hooks have
that rule). Parameters, buffers, ``state_dict`` and ``train``/``eval``
are torch's; a ``state_dict`` key is the attribute path, as in the
reference, so the two packages' keys are the same.

A layer that creates parameters takes ``device`` (default
``framework.device.current_device()``: the card until
``set_device("cpu")``, so a host without a GPU raises unless the caller
asks for the CPU) and ``generator`` (a ``torch.Generator`` on that
device; when None, the device's generator of ``framework.random``,
which ``random.seed`` resets), both keyword-only.
"""
from __future__ import annotations

import collections
import copy

import numpy as np
import torch

from ...framework import random
from ...framework.device import _as_torch_name, current_device, resolve_device
from ...framework.dtype import _BY_NAME, to_torch_dtype
from ...framework.io import to_tensor
from .. import initializer as I

__all__ = ["Layer", "Sequential", "LayerList", "ParameterList", "LayerDict",
           "Identity", "ParamAttr", "HookRemoveHelper", "load_jax_weights"]


class ParamAttr:
    """A parameter's settings (``layers.py:25-39``): ``initializer``, the
    ``learning_rate`` factor (``optimize_attr``), a ``regularizer`` that
    overrides the optimizer's, ``trainable`` and ``need_clip`` (False:
    gradient clipping skips it). ``name`` is accepted and not applied: a
    port parameter is named by its path in the model."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

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


class ParamBase(torch.nn.Parameter):
    """A parameter that keeps its Paddle attributes (``optimize_attr``,
    ``regularizer``, ``need_clip``) through ``copy.deepcopy``, as the
    reference's parameters do (``TransformerEncoder`` copies its
    layer)."""

    def __deepcopy__(self, memo):
        result = super().__deepcopy__(memo)
        result.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return result


class HookRemoveHelper:
    """Removes the hook ``idx`` from ``hooks`` (``layers.py:55-60``)."""

    def __init__(self, hooks, idx):
        self._hooks, self._idx = hooks, idx

    def remove(self):
        self._hooks.pop(self._idx, None)


def _torch_to_arg(a):
    """A Paddle ``to`` argument as torch's: a dtype name as a torch
    dtype, a device name (``"gpu"``, ``"gpu:1"``, ``"cpu"``) as a
    resolved ``torch.device``."""
    if isinstance(a, str):
        if a in _BY_NAME:
            return _BY_NAME[a]
        return resolve_device(_as_torch_name(a))
    return a


class Layer(torch.nn.Module):
    """``paddle.nn.Layer`` over ``torch.nn.Module``."""

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtype
        self._full_name = name_scope or type(self).__name__.lower()

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, *, device=None,
                         generator=None):
        """A parameter of ``shape`` on ``device`` (default: the current
        device) filled by ``attr``'s initializer, else
        ``default_initializer``, else the global initializer
        (``initializer.set_global_initializer``), else zeros for a bias
        and ``XavierNormal`` for a weight (``layers.py:76-99``); it
        carries ``attr``'s ``optimize_attr``, ``regularizer`` and
        ``need_clip``. None when ``attr`` is False. Not registered:
        assign it to an attribute."""
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dev = current_device() if device is None else resolve_device(device)
        init = attr.initializer or default_initializer or (
            I.Constant(0.0) if is_bias else I.XavierNormal())
        if I._GLOBAL[0] is not None and attr.initializer is None \
                and default_initializer is None:
            init = I._GLOBAL[1 if is_bias else 0] or init
        t = torch.empty(tuple(shape), device=dev,
                        dtype=to_torch_dtype(dtype or self._dtype))
        init(t, generator if generator is not None
             else random.generator(dev))
        p = ParamBase(t, requires_grad=attr.trainable)
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def add_parameter(self, name, parameter):
        """Register ``parameter`` (a tensor, or None) under ``name``."""
        if parameter is not None and not isinstance(parameter,
                                                    torch.Tensor):
            raise TypeError("parameter must be a Tensor/Parameter")
        if parameter is not None and not isinstance(parameter,
                                                    torch.nn.Parameter):
            parameter = ParamBase(parameter, parameter.requires_grad)
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        """Register ``sublayer`` under ``name``; returns it."""
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True):
        """Paddle's spelling of torch's ``register_buffer(...,
        persistent=)``: a buffer that is not persistable stays out of
        ``state_dict``."""
        super().register_buffer(name, tensor, persistent=persistable)
        return tensor

    # -- iteration: lists and include_sublayers, torch's recurse kept ---

    def parameters(self, include_sublayers=True, recurse=None):
        return list(super().parameters(
            include_sublayers if recurse is None else recurse))

    def named_parameters(self, prefix="", include_sublayers=True,
                         recurse=None, remove_duplicate=True):
        return super().named_parameters(
            prefix, include_sublayers if recurse is None else recurse,
            remove_duplicate)

    def buffers(self, include_sublayers=True, recurse=None):
        return list(super().buffers(
            include_sublayers if recurse is None else recurse))

    def named_buffers(self, prefix="", include_sublayers=True, recurse=None,
                      remove_duplicate=True):
        return super().named_buffers(
            prefix, include_sublayers if recurse is None else recurse,
            remove_duplicate)

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False):
        for name, m in self.named_modules(prefix=prefix):
            if m is not self or include_self:
                yield name, m

    # -- Paddle's to / astype / hooks / names --------------------------------

    def to(self, *args, **kwargs):
        """torch's ``to``, or Paddle's ``to(device=None, dtype=None,
        blocking=None)`` with device names ``"gpu"``, ``"gpu:i"``,
        ``"cpu"`` and dtype names (floating parameters and buffers are
        cast)."""
        blocking = kwargs.pop("blocking", None)
        if blocking is not None:
            kwargs.setdefault("non_blocking", not blocking)
        args = [_torch_to_arg(a) for a in args if a is not None]
        kwargs = {k: _torch_to_arg(v) for k, v in kwargs.items()
                  if v is not None or k not in ("device", "dtype")}
        return super().to(*args, **kwargs)

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def full_name(self):
        return self._full_name

    def register_forward_pre_hook(self, hook, **kwargs):
        """``hook(layer, inputs)``; a non-None result replaces the inputs
        (a single value becomes a one-tuple). Returns a
        ``HookRemoveHelper``."""
        handle = super().register_forward_pre_hook(hook, **kwargs)
        if kwargs:  # torch's own form
            return handle
        return HookRemoveHelper(self._forward_pre_hooks, handle.id)

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)``; a non-None result replaces
        the outputs. Returns a ``HookRemoveHelper``."""
        handle = self.register_forward_hook(hook)
        return HookRemoveHelper(self._forward_hooks, handle.id)

    # -- state ---------------------------------------------------------------

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

    load_dict = set_state_dict

    def clear_gradients(self):
        """Drop every parameter's gradient."""
        for p in self.parameters():
            p.grad = None


def load_jax_weights(model, arrays) -> None:
    """Fill a port ``Layer`` (any layer of ``nn``, ``resnet50()``,
    ``LeNet()``) with the reference layer's ``state_dict()``: ``arrays``
    maps each name to a numpy array (or tensor), as ``{n: np.asarray(
    t._data) for n, t in jax_layer.state_dict().items()}`` gives them,
    parameters and buffers (BatchNorm's ``_mean`` and ``_variance``)
    alike. The port's names are the reference's (RNN weights included:
    ``weight_ih_l0``, ``..._reverse``), so each entry is copied by name,
    in place. Raises ``KeyError`` on a missing or unexpected name and
    ``ValueError`` on a shape or dtype mismatch, before anything is
    written."""
    own = model.state_dict(keep_vars=True)
    missing = sorted(set(own) - set(arrays))
    unexpected = sorted(set(arrays) - set(own))
    if missing or unexpected:
        raise KeyError(f"load_jax_weights: missing {missing}, "
                       f"unexpected {unexpected}")
    values = {}
    for name, target in own.items():
        a = arrays[name]
        v = a.detach() if isinstance(a, torch.Tensor) else to_tensor(a)
        if tuple(v.shape) != tuple(target.shape) or v.dtype != target.dtype:
            raise ValueError(
                f"load_jax_weights: {name} is {tuple(v.shape)} {v.dtype}, "
                f"the model holds {tuple(target.shape)} {target.dtype}")
        values[name] = v
    with torch.no_grad():
        for name, v in values.items():
            own[name].copy_(v)


class Sequential(Layer):
    """``Sequential(l0, l1, ...)``, ``Sequential(("name", layer), ...)``
    or ``Sequential(OrderedDict)``: the layers called in order, keyed
    ``"0"``, ``"1"``, ... or by their names."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            layers = tuple(layers[0].items())
        for i, item in enumerate(layers):
            name, layer = item if isinstance(item, tuple) else (i, item)
            self.add_sublayer(name, layer)

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
        self.add_sublayer(str(int(idx) % len(self)), layer)

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_sublayer(str(len(self._modules)), layer)
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


class ParameterList(Layer):
    """A list of parameters, keyed ``"0"``, ``"1"``, ...
    (``layers.py:422-440``)."""

    def __init__(self, parameters=None):
        super().__init__()
        for p in parameters or ():
            self.append(p)

    def __getitem__(self, idx):
        return list(self._parameters.values())[idx]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self


class LayerDict(Layer):
    """Layers by name, in insertion order (``layers.py:443-493``)."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def __contains__(self, key):
        return key in self._modules

    def keys(self):
        return self._modules.keys()

    def items(self):
        return self._modules.items()

    def values(self):
        return self._modules.values()

    def update(self, sublayers):
        items = sublayers.items() if isinstance(sublayers, (dict, LayerDict)) \
            else sublayers
        for key, layer in items:
            self.add_sublayer(key, layer)
        return self

    def pop(self, key):
        return self._modules.pop(key)

    def clear(self):
        self._modules.clear()


class Identity(Layer):
    """Returns its input; takes and ignores any arguments."""

    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x
