"""Random sampling (counterpart of ``paddle_tpu/tensor/random.py``).

Every draw comes from the device's generator of
``framework.random.generator`` and counts itself with ``note_draw()``,
so ``jit.TrainStep`` runs a step that draws eagerly (a CUDA graph would
replay the same numbers); :func:`seed` resets the generators, as
``paddle.seed`` does. An op without a tensor input draws on the current
device (``framework.device.set_device``); a ``*_like`` op on its
input's. The streams are torch's, not JAX's: the same seed gives the
same numbers on one device, not the reference's numbers.
"""
from __future__ import annotations

import torch

from ..framework import random as _random
from ._common import canon, device_of, dtype_of, shape_list, tensors


def _gen(device):
    _random.note_draw()
    return _random.generator(device)


def seed(value):
    """Reset every generator (``paddle.seed``)."""
    _random.seed(value)


def _uniform_on(shape, dtype, lo, hi, dev):
    u = torch.rand(shape_list(shape), generator=_gen(dev), device=dev)
    return (u * (hi - lo) + lo).to(dtype_of(dtype))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):  # noqa: A002
    """Uniform in ``[min, max)``, drawn in fp32 and cast to ``dtype``."""
    return _uniform_on(shape, dtype, min, max, device_of())


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype, 0.0, 1.0)


def _randn_on(shape, dtype, dev):
    return torch.randn(shape_list(shape), generator=_gen(dev), device=dev,
                       dtype=dtype_of(dtype))


def randn(shape, dtype=None, name=None):
    return _randn_on(shape, dtype, device_of())


standard_normal = randn


def normal(mean=0.0, std=1.0, shape=None, name=None):
    """``mean + std * N(0, 1)`` of ``shape`` (by default the broadcast
    shape of tensor ``mean`` and ``std``), fp32."""
    m, s = tensors(mean, std)
    dev = device_of(m, s)
    if shape is None:
        shape = torch.broadcast_shapes(
            *[t.shape for t in (m, s) if isinstance(t, torch.Tensor)]) \
            if isinstance(m, torch.Tensor) or isinstance(s, torch.Tensor) \
            else ()
    z = torch.randn(shape_list(shape) if shape != () else [],
                    generator=_gen(dev), device=dev)
    return canon(z * s + m)


gaussian = normal


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    """Ints in ``[low, high)`` (``[0, low)`` without ``high``), int32 for
    int64."""
    if high is None:
        low, high = 0, low
    dev = device_of()
    return torch.randint(int(low), int(high), shape_list(shape),
                         generator=_gen(dev), device=dev) \
        .to(dtype_of(dtype))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    (x,) = tensors(x)
    if high is None:
        low, high = 0, low
    return torch.randint(int(low), int(high), tuple(x.shape),
                         generator=_gen(x.device), device=x.device) \
        .to(dtype_of(dtype, x.dtype))


def randperm(n, dtype="int64", name=None):
    dev = device_of()
    return torch.randperm(int(n), generator=_gen(dev), device=dev) \
        .to(dtype_of(dtype))


def shuffle(x, axis=0, name=None):
    """``x`` with its slices along ``axis`` in a random order."""
    (x,) = tensors(x)
    perm = torch.randperm(x.shape[axis], generator=_gen(x.device),
                          device=x.device)
    return torch.index_select(x, axis, perm)


def multinomial(x, num_samples=1, replacement=False, name=None):
    """``num_samples`` int32 category draws per row of the weights
    ``x``."""
    (x,) = tensors(x)
    return torch.multinomial(x, num_samples, replacement,
                             generator=_gen(x.device)).to(torch.int32)


def bernoulli(x, name=None):
    (x,) = tensors(x)
    return torch.bernoulli(x, generator=_gen(x.device))


def bernoulli_(x, p=0.5, name=None):
    return x.bernoulli_(p, generator=_gen(x.device))


def poisson(x, name=None):
    (x,) = tensors(x)
    return torch.poisson(x, generator=_gen(x.device))


def binomial(count, prob, name=None):
    """Binomial draws of ``count`` trials at ``prob``, int32."""
    n, p = tensors(count, prob)
    n, p = torch.broadcast_tensors(n.to(torch.float32), p.to(torch.float32))
    return torch.binomial(n, p, generator=_gen(n.device)).to(torch.int32)


def exponential_(x, lam=1.0, name=None):
    return x.exponential_(lam, generator=_gen(x.device))


def uniform_(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    return x.uniform_(min, max, generator=_gen(x.device))


def normal_(x, mean=0.0, std=1.0, name=None):
    return x.normal_(mean, std, generator=_gen(x.device))


def rand_like(x, dtype=None, name=None):
    (x,) = tensors(x)
    return _uniform_on(x.shape, dtype or x.dtype, 0.0, 1.0, x.device)


def randn_like(x, dtype=None, name=None):
    (x,) = tensors(x)
    return _randn_on(x.shape, dtype or x.dtype, x.device)
