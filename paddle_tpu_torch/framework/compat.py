"""The reference's top-level long tail: places, the static-mode flag,
dtype and tensor introspection, printing options, ``create_parameter``.

Counterpart of ``paddle_tpu/framework/compat.py``. A place stringifies to
the device it names (``CUDAPlace(1)`` is ``"gpu:1"``), so
:func:`framework.device.set_device` takes one; ``TPUPlace`` names no
device of the port and raises when used as one. ``enable_static`` only
sets the flag that ``in_dynamic_mode`` reads, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from . import dtype as dtype_mod

__all__ = [
    "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "TPUPlace", "LazyGuard",
    "enable_static", "disable_static", "in_dynamic_mode", "in_static_mode",
    "set_printoptions", "finfo", "iinfo", "shape", "rank", "tolist",
    "is_floating_point", "is_integer", "is_complex", "create_parameter",
    "check_shape", "disable_signal_handler",
]


class _Place:
    _dev = "cpu"

    def __init__(self, device_id=0):
        self._id = int(device_id)

    def __repr__(self):
        return f"{type(self).__name__}({self._id})"

    def __eq__(self, other):
        return (type(self) is type(other)
                and self._id == getattr(other, "_id", None))

    def __hash__(self):
        return hash((type(self).__name__, self._id))

    def __str__(self):
        return self._dev if self._dev == "cpu" else f"{self._dev}:{self._id}"


class CPUPlace(_Place):
    _dev = "cpu"


class CUDAPlace(_Place):
    """The card ``device_id`` (``"gpu:<id>"``)."""
    _dev = "gpu"


class CUDAPinnedPlace(_Place):
    """Pinned host memory: the CPU as a device."""
    _dev = "cpu"


class TPUPlace(_Place):
    """Accepted for the reference's scripts; the port has no TPU, so a
    ``TPUPlace`` given as a device raises."""
    _dev = "tpu"


_static_mode = [False]


def enable_static():
    _static_mode[0] = True


def disable_static():
    _static_mode[0] = False


def in_dynamic_mode():
    return not _static_mode[0]


def in_static_mode():
    return _static_mode[0]


class LazyGuard:
    """The reference defers parameter initialization under this guard;
    its parameters are made on first touch, so the guard does nothing
    there and nothing here."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Printing options for tensors (torch's) and numpy arrays, as the
    reference sets numpy's."""
    kw = {k: v for k, v in dict(precision=precision, threshold=threshold,
                                edgeitems=edgeitems,
                                linewidth=linewidth).items()
          if v is not None}
    torch.set_printoptions(sci_mode=sci_mode, **kw)
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    np.set_printoptions(**kw)


def finfo(dtype):
    """``torch.finfo`` of a dtype in any accepted form (bfloat16 too)."""
    return torch.finfo(dtype_mod.to_torch_dtype(dtype))


def iinfo(dtype):
    return torch.iinfo(dtype_mod.to_torch_dtype(dtype))


def _dt(x):
    return x.dtype if isinstance(x, torch.Tensor) else x


def is_floating_point(x):
    return dtype_mod.is_floating_point(_dt(x))


def is_integer(x):
    return dtype_mod.is_integer(_dt(x))


def is_complex(x):
    return dtype_mod.is_complex(_dt(x))


def shape(input):  # noqa: A002
    """The shape as an int32 tensor on ``input``'s device."""
    return torch.tensor(list(input.shape), dtype=torch.int32,
                        device=input.device)


def rank(input):  # noqa: A002
    """``ndim`` as a 0-d int32 tensor on ``input``'s device."""
    return torch.tensor(input.ndim, dtype=torch.int32, device=input.device)


def tolist(x):
    return x.tolist()


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """A parameter on the current device made as a layer's
    ``create_parameter`` makes one (``paddle.create_parameter``)."""
    from ..nn.layer.layers import Layer, ParamAttr

    attr = ParamAttr._to_attr(attr)
    if attr is not False and name is not None and attr.name is None:
        attr.name = name
    return Layer().create_parameter(shape, attr, dtype, is_bias,
                                    default_initializer)


def check_shape(shape):
    """Raise ``TypeError`` unless ``shape`` is a tensor or a sequence of
    ints and tensors."""
    if isinstance(shape, torch.Tensor):
        return
    for s in shape:
        if not isinstance(s, (int, np.integer, torch.Tensor)):
            raise TypeError(f"shape entries must be int, got {type(s)}")


def disable_signal_handler():
    """The reference unhooks its crash-signal handlers; the port
    installs none."""
    return None
