"""Comparison and logical ops (counterpart of
``paddle_tpu/tensor/logic.py``): bool outputs, no gradient, never cast
by ``auto_cast``."""
from __future__ import annotations

import torch

from ._common import axes, promote, tensors


def _cmp(name, fn):
    def f(x, y, name=None):
        return fn(*tensors(x, y))
    f.__name__ = f.__qualname__ = name
    f.__doc__ = f"Elementwise {name} with broadcasting (``paddle.{name}``)."
    return f


equal = _cmp("equal", torch.eq)
not_equal = _cmp("not_equal", torch.ne)
greater_than = _cmp("greater_than", torch.gt)
greater_equal = _cmp("greater_equal", torch.ge)
less_than = _cmp("less_than", torch.lt)
less_equal = _cmp("less_equal", torch.le)
logical_and = _cmp("logical_and", torch.logical_and)
logical_or = _cmp("logical_or", torch.logical_or)
logical_xor = _cmp("logical_xor", torch.logical_xor)


def logical_not(x, name=None):
    return torch.logical_not(tensors(x)[0])


def equal_all(x, y, name=None):
    """A 0-d bool: same shape and every entry equal."""
    a, b = tensors(x, y)
    same = a.shape == b.shape and bool(torch.equal(*promote(a, b)))
    return torch.tensor(same, device=a.device)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    """A 0-d bool: :func:`isclose` everywhere."""
    return isclose(x, y, rtol, atol, equal_nan).all()


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    a, b = promote(*tensors(x, y))
    return torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


def is_empty(x, name=None):
    """A 0-d bool: ``x`` has no entries."""
    (a,) = tensors(x)
    return torch.tensor(a.numel() == 0, device=a.device)


def is_tensor(x):
    return isinstance(x, torch.Tensor)


def isin(x, test_x, assume_unique=False, invert=False, name=None):
    a, b = tensors(x, test_x)
    return torch.isin(a, b, assume_unique=assume_unique, invert=invert)


def all(x, axis=None, keepdim=False, name=None):  # noqa: A001
    """Logical-and over ``axis`` (every dim by default)."""
    (a,) = tensors(x)
    return torch.all(a.bool(), axes(axis, a.dim()), keepdim=keepdim) \
        if a.dim() else a.bool()


def any(x, axis=None, keepdim=False, name=None):  # noqa: A001
    """Logical-or over ``axis`` (every dim by default)."""
    (a,) = tensors(x)
    return torch.any(a.bool(), axes(axis, a.dim()), keepdim=keepdim) \
        if a.dim() else a.bool()
