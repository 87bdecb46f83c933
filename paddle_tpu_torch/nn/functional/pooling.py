"""Pooling (counterpart of ``paddle_tpu/nn/functional/pooling.py``).

The reference pools through ``lax.reduce_window``, which XLA lowers
itself: no Pallas kernel. Here each pool is torch's pooling op on the
channel-first view of its input (channel-last input is moved with
``movedim``, a view in ``channels_last`` memory), with the reference's
window rules, which are not torch's:

- ``padding`` is an int, ``nd`` ints, ``'SAME'`` (XLA's, the larger half
  high) or ``'VALID'``; padding torch cannot say (asymmetric, or more
  than half the window) is applied with ``F.pad`` first, ``-inf`` for a
  max and 0 for an average;
- ``ceil_mode`` extends the high-side padding by ``(s - rem) % s``
  (``pooling.py:36-52``). Torch's ``ceil_mode`` also drops a last window
  that starts in the padding, which the reference keeps (its max is
  ``-inf``, its exclusive average 0 / 0), so the port pads explicitly
  and pools without ``ceil_mode``;
- an average sums each window (``divisor_override=1``) and divides by
  the window's size, or with ``exclusive`` by its count of real
  elements, padding of both kinds excluded (``pooling.py:72-88``);
- adaptive windows run from ``floor(i * in / out)`` to
  ``ceil((i + 1) * in / out)`` (``pooling.py:138-142``), which is
  torch's own rule, so the adaptive pools are torch's.

``return_mask`` is not ported (ROADMAP queue A.8) and raises.
"""
from __future__ import annotations

import math

import torch

from .conv import _ntuple, _same_pads, pad_spatial

__all__ = ["max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool2d"]

_F = torch.nn.functional
_MAX = {1: _F.max_pool1d, 2: _F.max_pool2d, 3: _F.max_pool3d}


def _no_mask(return_mask, op):
    if return_mask:
        raise NotImplementedError(
            f"{op}(return_mask=True) is not ported (ROADMAP queue A.8)")


def _pool_pads(padding, nd, in_sizes, k, s, ceil_mode):
    """The reference's (low, high) pads of each spatial dim."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0)] * nd
        if mode == "SAME":
            return _same_pads(in_sizes, k, s, (1,) * nd)
        raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    pads = [(p, p) for p in _ntuple(padding, nd)]
    if not ceil_mode:
        return pads
    out = []
    for n, (lo, hi), kk, ss in zip(in_sizes, pads, k, s):
        rem = (n + lo + hi - kk) % ss
        out.append((lo, hi + ((ss - rem) % ss if rem else 0)))
    return out


def _window(nd, kernel_size, stride):
    k = _ntuple(kernel_size, nd)
    return k, _ntuple(stride if stride is not None else kernel_size, nd)


def _channel_first(x, channel_last):
    return x.movedim(-1, 1) if channel_last else x


def _back(out, channel_last):
    return out.movedim(1, -1) if channel_last else out


def _max_pool(x, nd, kernel_size, stride, padding, ceil_mode, channel_last):
    k, s = _window(nd, kernel_size, stride)
    x = _channel_first(x, channel_last)
    pads = _pool_pads(padding, nd, x.shape[2:], k, s, ceil_mode)
    if all(lo == hi <= kk // 2 for (lo, hi), kk in zip(pads, k)):
        out = _MAX[nd](x, k, s, tuple(lo for lo, _ in pads))
    else:
        out = _MAX[nd](pad_spatial(x, pads, float("-inf")), k, s)
    return _back(out, channel_last)


def _window_sums(x, k, s):
    """The sum of each window of ``x`` (already padded), as an average
    pool with divisor 1; 1-D runs as 2-D over a unit dim."""
    if len(k) == 1:
        return _F.avg_pool2d(x.unsqueeze(-2), (1,) + k, (1,) + s,
                             divisor_override=1).squeeze(-2)
    pool = _F.avg_pool2d if len(k) == 2 else _F.avg_pool3d
    return pool(x, k, s, divisor_override=1)


def _avg_pool(x, nd, kernel_size, stride, padding, exclusive, ceil_mode,
              channel_last):
    k, s = _window(nd, kernel_size, stride)
    x = _channel_first(x, channel_last)
    in_sizes = tuple(x.shape[2:])
    pads = _pool_pads(padding, nd, in_sizes, k, s, ceil_mode)
    sums = _window_sums(pad_spatial(x, pads), k, s)
    valid = isinstance(padding, str) and padding.upper() == "VALID"
    if exclusive and not valid:
        ones = torch.ones((1, 1) + in_sizes, dtype=x.dtype, device=x.device)
        out = sums / _window_sums(pad_spatial(ones, pads), k, s)
    else:
        out = sums / math.prod(k)
    return _back(out, channel_last)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    _no_mask(return_mask, "max_pool1d")
    return _max_pool(x, 1, kernel_size, stride, padding, ceil_mode,
                     data_format not in ("NCL", "NCW"))


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    _no_mask(return_mask, "max_pool2d")
    return _max_pool(x, 2, kernel_size, stride, padding, ceil_mode,
                     not data_format.startswith("NC"))


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    _no_mask(return_mask, "max_pool3d")
    return _max_pool(x, 3, kernel_size, stride, padding, ceil_mode,
                     not data_format.startswith("NC"))


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _avg_pool(x, 1, kernel_size, stride, padding, exclusive,
                     ceil_mode, data_format not in ("NCL", "NCW"))


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _avg_pool(x, 2, kernel_size, stride, padding, exclusive,
                     ceil_mode, not data_format.startswith("NC"))


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _avg_pool(x, 3, kernel_size, stride, padding, exclusive,
                     ceil_mode, not data_format.startswith("NC"))


def _adaptive(fn, x, output_size, nd, channel_last):
    size = (output_size,) * nd if output_size is None \
        else _ntuple(output_size, nd)
    return _back(fn(_channel_first(x, channel_last), size), channel_last)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(_F.adaptive_avg_pool1d, x, output_size, 1, False)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(_F.adaptive_avg_pool2d, x, output_size, 2,
                     not data_format.startswith("NC"))


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(_F.adaptive_avg_pool3d, x, output_size, 3,
                     not data_format.startswith("NC"))


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    _no_mask(return_mask, "adaptive_max_pool2d")
    return _adaptive(_F.adaptive_max_pool2d, x, output_size, 2, False)
