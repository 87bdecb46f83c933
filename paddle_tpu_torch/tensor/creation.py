"""Tensor creation (counterpart of ``paddle_tpu/tensor/creation.py``).

An op without a tensor input places its output on the current device
(``framework.device.set_device``); a ``*_like`` op follows its input.
Dtypes follow the reference: ``full`` takes bool or int32 from a bool
or int fill, ``arange`` float32 only from a float bound, and int64
requests give int32 (``_common.canon``).
"""
from __future__ import annotations

import torch

from ..amp.auto_cast import cast_inputs
from ._common import (
    as_tensor, canon, device_of, dtype_of, scalar, shape_list, tensors,
)

__all__ = [
    "to_tensor", "zeros", "ones", "full", "empty", "zeros_like", "ones_like",
    "full_like", "empty_like", "arange", "linspace", "logspace", "eye",
    "tril", "triu", "diag", "diagflat", "meshgrid", "assign", "clone",
    "tril_indices", "triu_indices", "complex", "polar",
]


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """``data`` (a number, list, numpy array or tensor) as a tensor on
    ``place`` (default: the current device), int64 as int32 and float64
    as float32 as the reference lands them; ``stop_gradient=False``
    makes it a leaf that requires grad."""
    t = as_tensor(data, None if place is None else torch.device(place),
                  dtype)
    if isinstance(data, torch.Tensor):
        t = canon(t)
        if place is not None:
            t = t.to(place)
    if not stop_gradient:
        t = t.detach().requires_grad_()
    return t


def _new(fn, shape, dtype, *args):
    return fn(shape_list(shape), *args, dtype=dtype_of(dtype),
              device=device_of())


def zeros(shape, dtype=None, name=None):
    return _new(torch.zeros, shape, dtype)


def ones(shape, dtype=None, name=None):
    return _new(torch.ones, shape, dtype)


def full(shape, fill_value, dtype=None, name=None):
    """``fill_value`` everywhere; without ``dtype``, bool for a bool fill,
    int32 for an int fill, the default dtype otherwise
    (``creation.py:47-56``)."""
    fill_value = scalar(fill_value)
    if dtype is None:
        dtype = ("bool" if isinstance(fill_value, bool)
                 else "int32" if isinstance(fill_value, int) else None)
    return torch.full(shape_list(shape), fill_value, dtype=dtype_of(dtype),
                      device=device_of())


def empty(shape, dtype=None, name=None):
    """Zeros, as the reference gives (it has no uninitialised buffers)."""
    return zeros(shape, dtype)


def zeros_like(x, dtype=None, name=None):
    (x,) = tensors(x)
    return canon(torch.zeros_like(x, dtype=dtype_of(dtype, x.dtype)))


def ones_like(x, dtype=None, name=None):
    (x,) = tensors(x)
    return canon(torch.ones_like(x, dtype=dtype_of(dtype, x.dtype)))


def full_like(x, fill_value, dtype=None, name=None):
    (x,) = tensors(x)
    return canon(torch.full_like(x, scalar(fill_value),
                                 dtype=dtype_of(dtype, x.dtype)))


def empty_like(x, dtype=None, name=None):
    """Zeros, as :func:`empty`."""
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    """``[start, end)`` by ``step``; without ``dtype``, float32 when a
    bound or the step is a float and int32 otherwise
    (``creation.py:82-94``)."""
    start, end, step = scalar(start), scalar(end), scalar(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = ("float32" if any(isinstance(v, float)
                                  for v in (start, end, step)) else "int32")
    return torch.arange(start, end, step, dtype=dtype_of(dtype),
                        device=device_of())


def linspace(start, stop, num, dtype=None, name=None):
    return torch.linspace(scalar(start), scalar(stop), int(scalar(num)),
                          dtype=dtype_of(dtype), device=device_of())


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return torch.logspace(scalar(start), scalar(stop), int(scalar(num)),
                          base=scalar(base), dtype=dtype_of(dtype),
                          device=device_of())


def eye(num_rows, num_columns=None, dtype=None, name=None):
    return torch.eye(int(num_rows), int(num_columns or num_rows),
                     dtype=dtype_of(dtype), device=device_of())


def tril(x, diagonal=0, name=None):
    (x,) = cast_inputs("tril", *tensors(x))
    return canon(torch.tril(x, diagonal))


def triu(x, diagonal=0, name=None):
    (x,) = cast_inputs("triu", *tensors(x))
    return canon(torch.triu(x, diagonal))


def diag(x, offset=0, padding_value=0, name=None):
    """A 1-D ``x`` on the ``offset`` diagonal of a square matrix filled
    with ``padding_value``; of a matrix, its ``offset`` diagonal."""
    (x,) = cast_inputs("diag", *tensors(x))
    if x.dim() == 1:
        out = torch.diag(x, offset)
        if padding_value != 0:
            n = x.shape[0] + abs(offset)
            mask = torch.ones(n, n, dtype=torch.bool,
                              device=x.device).diagonal(offset)
            keep = torch.zeros(n, n, dtype=torch.bool, device=x.device)
            keep.diagonal(offset).copy_(mask)
            out = torch.where(keep, out, torch.full(
                (), padding_value, dtype=x.dtype, device=x.device))
        return canon(out)
    return canon(torch.diagonal(x, offset, 0, 1))


def diagflat(x, offset=0, name=None):
    (x,) = cast_inputs("diagflat", *tensors(x))
    return canon(torch.diagflat(x, offset))


def meshgrid(*args, name=None):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    args = cast_inputs("meshgrid", *tensors(*args))
    return canon(list(torch.meshgrid(*args, indexing="ij")))


def assign(x, output=None):
    """A copy of ``x`` (a tensor, number, list or numpy array); with
    ``output``, written into it and returned."""
    val = as_tensor(x, device_of(x, output))
    if output is None:
        (val,) = cast_inputs("assign", val)
        return canon(val.clone())
    with torch.no_grad():
        output.copy_(val)
    return output


def clone(x, name=None):
    return x.clone()


def _indices(fn, row, col, offset, dtype):
    col = row if col is None else col
    return fn(int(row), int(col), int(offset), device=device_of()) \
        .to(dtype_of(dtype))


def tril_indices(row, col=None, offset=0, dtype="int64"):
    """The ``[2, n]`` coordinates of the lower triangle (int32 for
    int64, as the reference)."""
    return _indices(torch.tril_indices, row, col, offset, dtype)


def triu_indices(row, col=None, offset=0, dtype="int64"):
    return _indices(torch.triu_indices, row, col, offset, dtype)


def complex(real, imag, name=None):  # noqa: A001
    real, imag = cast_inputs("complex", *tensors(real, imag))
    return canon(torch.complex(real, imag))


def polar(abs_, angle, name=None):
    abs_, angle = cast_inputs("polar", *tensors(abs_, angle))
    return canon(torch.polar(abs_, angle))
