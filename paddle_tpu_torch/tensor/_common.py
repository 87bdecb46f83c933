"""What the tensor modules share: the reference's dtype rules, argument
forms and placement.

The reference is 32-bit-first (``paddle_tpu/framework/core.py:60``):
no array of it is int64 or float64, so its index ops give int32 and an
int64 or float64 input lands as int32 or float32. Torch's index ops
give int64 and its integer reductions promote to int64, so every op of
the port passes its outputs through :func:`canon`, which narrows them
as the reference does. Inputs that are Python numbers, lists or numpy
arrays become tensors by the same rule (:func:`as_tensor`), on the
device of the op's tensor input, or else on the current device
(``framework.device.current_device``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework.device import current_device
from ..framework.dtype import get_default_dtype, to_torch_dtype

_NARROW = {torch.int64: torch.int32, torch.float64: torch.float32,
           torch.complex128: torch.complex64}


def canon(out):
    """``out`` (a tensor, or a tuple or list of them) with every int64,
    float64 and complex128 tensor narrowed to the reference's dtype."""
    if isinstance(out, torch.Tensor):
        d = _NARROW.get(out.dtype)
        return out if d is None else out.to(d)
    if isinstance(out, tuple):
        return tuple(canon(o) for o in out)
    if isinstance(out, list):
        return [canon(o) for o in out]
    return out


def dtype_of(dtype, default=None):
    """A dtype name, numpy or torch dtype as the reference's torch dtype
    (int64 as int32, float64 as float32); for None ``default``, else the
    default dtype (``framework.dtype.set_default_dtype``, float32 unless
    set), narrowed alike, as the reference's ops read it."""
    if dtype is None:
        if default is not None:
            return default
        dtype = get_default_dtype()
    d = to_torch_dtype(dtype)
    return _NARROW.get(d, d)


def device_of(*args):
    """The device of the first tensor among ``args``, else the current
    device."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return current_device()


def as_tensor(x, device=None, dtype=None):
    """``x`` as a tensor: a tensor as it is (cast to ``dtype`` if given),
    anything else through numpy with the reference's 32-bit rule, on
    ``device`` (default: the current device)."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype_of(dtype))
    arr = np.asarray(x)
    t = torch.from_numpy(np.array(arr, copy=True)) if arr.dtype != object \
        else torch.tensor(x)
    t = t.to(_NARROW.get(t.dtype, t.dtype))
    if dtype is not None:
        t = t.to(dtype_of(dtype))
    return t.to(device if device is not None else current_device())


def tensors(*xs):
    """Each of ``xs`` as a tensor on the device of the first tensor
    among them (Python numbers as 0-d tensors: torch promotes them as
    JAX promotes weak types)."""
    dev = device_of(*xs)
    return tuple(x if isinstance(x, torch.Tensor) or x is None
                 else as_tensor(x, dev) for x in xs)


def shape_list(shape):
    """An int, a list of ints or 0-d tensors, or a 1-D tensor as a list of
    ints (a tensor is read on the host)."""
    if isinstance(shape, torch.Tensor):
        return [int(s) for s in shape.reshape(-1).tolist()]
    if isinstance(shape, (int, np.integer)):
        return [int(shape)]
    return [int(s) for s in shape]


def scalar(v):
    """A 0-d tensor as a Python number (read on the host); anything else
    as it is."""
    return v.item() if isinstance(v, torch.Tensor) else v


def axes(axis, ndim):
    """``axis`` (None, an int, a list or a tensor) as a tuple of
    non-negative dims; None is every dim."""
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) % max(ndim, 1) for a in axis)
    return (int(axis) % max(ndim, 1),)


def promote(a, b):
    """``a`` and ``b`` cast to their common dtype (for torch ops that
    refuse mixed dtypes)."""
    d = torch.result_type(a, b)
    return a.to(d), b.to(d)


def float_of(a):
    """``a`` as a float tensor: integer and bool inputs as float32 (what
    ``jnp.mean`` and the like give them)."""
    return a if a.is_floating_point() or a.is_complex() \
        else a.to(torch.float32)
