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

With ``return_mask`` the max pools (channel-first only, as in the
reference) also return each maximum's flat int32 index in its input's
spatial plane (``_max_pool_with_index``, ``pooling.py:257-287``): the
first maximum in window order wins, as ``jnp.argmax`` picks it, decided
here by an explicit first-index rule, not torch's ``return_indices``,
whose order among ties is not specified on CUDA. The adaptive max pools
take ``return_mask`` by the same rule; the reference ignores it there
and returns the pooled tensor alone. ``max_unpool1d/2d/3d`` scatter
pooled values back to those indices.
"""
from __future__ import annotations

import math

import torch

from ...amp.auto_cast import cast_inputs
from ...tensor._common import shape_list, tensors
from .conv import _ntuple, _same_pads, pad_spatial

__all__ = ["max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d", "lp_pool2d", "max_unpool1d",
           "max_unpool2d", "max_unpool3d"]

_F = torch.nn.functional
_MAX = {1: _F.max_pool1d, 2: _F.max_pool2d, 3: _F.max_pool3d}


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
    channel_last = data_format not in ("NCL", "NCW")
    if return_mask:
        return _max_pool_with_index(x, 1, kernel_size, stride, padding,
                                    ceil_mode, channel_last)
    return _max_pool(x, 1, kernel_size, stride, padding, ceil_mode,
                     channel_last)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    channel_last = not data_format.startswith("NC")
    if return_mask:
        return _max_pool_with_index(x, 2, kernel_size, stride, padding,
                                    ceil_mode, channel_last)
    return _max_pool(x, 2, kernel_size, stride, padding, ceil_mode,
                     channel_last)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    channel_last = not data_format.startswith("NC")
    if return_mask:
        return _max_pool_with_index(x, 3, kernel_size, stride, padding,
                                    ceil_mode, channel_last)
    return _max_pool(x, 3, kernel_size, stride, padding, ceil_mode,
                     channel_last)


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


def _sizes(output_size, nd, in_sizes):
    size = (output_size,) * nd if output_size is None \
        else _ntuple(output_size, nd)
    return tuple(n if o is None else int(o) for o, n in zip(size, in_sizes))


def _adaptive(fn, x, output_size, nd, channel_last):
    x = _channel_first(x, channel_last)
    return _back(fn(x, _sizes(output_size, nd, x.shape[2:])), channel_last)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(_F.adaptive_avg_pool1d, x, output_size, 1, False)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(_F.adaptive_avg_pool2d, x, output_size, 2,
                     not data_format.startswith("NC"))


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(_F.adaptive_avg_pool3d, x, output_size, 3,
                     not data_format.startswith("NC"))


_ADAPTIVE_MAX = {1: _F.adaptive_max_pool1d, 2: _F.adaptive_max_pool2d,
                 3: _F.adaptive_max_pool3d}


def _adaptive_max(x, output_size, nd, return_mask):
    if return_mask:
        return _adaptive_max_with_index(x, output_size, nd)
    return _adaptive(_ADAPTIVE_MAX[nd], x, output_size, nd, False)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive_max(x, output_size, 1, return_mask)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive_max(x, output_size, 2, return_mask)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive_max(x, output_size, 3, return_mask)


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW", name=None):
    """``(sum |x|^p over the window)^(1/p)`` (``pooling.py:198``), with
    the average pools' padding and ``ceil_mode`` rules (padding adds
    zeros)."""
    (x,) = cast_inputs("lp_pool2d", x)
    k, s = _window(2, kernel_size, stride)
    channel_last = not data_format.startswith("NC")
    x = _channel_first(x, channel_last)
    pads = _pool_pads(padding, 2, x.shape[2:], k, s, ceil_mode)
    p = float(norm_type)
    sums = _window_sums(pad_spatial(x.abs() ** p, pads), k, s)
    return _back(sums ** (1.0 / p), channel_last)


# -- max-pool indices and unpooling -------------------------------------------


def _lowest(dtype):
    return float("-inf") if dtype.is_floating_point \
        else torch.iinfo(dtype).min


def _first_max(win):
    """The maximum along the last dim of ``win`` and the first index
    holding it (a NaN counts as the maximum, as in ``jnp.argmax``); the
    value is gathered there, so its gradient reaches that element
    alone."""
    top = win.amax(-1, keepdim=True)
    hit = (win == top) | (win != win)
    k = win.shape[-1]
    pos = torch.arange(k, device=win.device)
    first = torch.where(hit, pos, k).amin(-1, keepdim=True)
    return torch.gather(win, -1, first).squeeze(-1), first.squeeze(-1)


def _window_coords(first, kdims):
    """``first`` (an index into row-major windows of ``kdims``) as one
    offset per window dim."""
    coords = []
    for k in reversed(kdims):
        coords.insert(0, first % k)
        first = first // k
    return coords


def _flat_index(coords, spatial):
    """Row-major flat indices in the ``spatial`` plane of per-dim
    coordinates, -1 where any lies outside it."""
    flat = torch.zeros_like(coords[0])
    ok = torch.ones_like(coords[0], dtype=torch.bool)
    for c, n in zip(coords, spatial):
        ok &= (c >= 0) & (c < n)
        flat = flat * n + c
    return torch.where(ok, flat, -1).to(torch.int32)


def _out_grid(outs, d):
    """The output positions of dim ``d`` shaped to broadcast over the
    output grid."""
    shape = [1] * len(outs)
    shape[d] = outs[d]
    return shape


def _max_pool_with_index(x, nd, kernel_size, stride, padding, ceil_mode,
                         channel_last):
    """(pooled, int32 flat indices) of a channel-first max pool: windows
    cut from the padded input by ``unfold`` (padding at the dtype's
    lowest value), the first maximum in window order, its index in the
    unpadded spatial plane (-1 if it is padding)."""
    if channel_last:
        raise ValueError("return_mask requires a channel-first layout "
                         "(NCL, NCHW, NCDHW), as in the reference")
    if isinstance(padding, str) and padding.upper() != "VALID":
        raise ValueError(f"return_mask does not support padding={padding!r}")
    k, s = _window(nd, kernel_size, stride)
    spatial = tuple(x.shape[2:])
    pads = _pool_pads(padding, nd, spatial, k, s, ceil_mode)
    win = pad_spatial(x, pads, _lowest(x.dtype))
    for d in range(nd):
        win = win.unfold(2 + d, k[d], s[d])
    outs = win.shape[2:2 + nd]
    val, first = _first_max(win.reshape(win.shape[:2 + nd] + (-1,)))
    offs = _window_coords(first, k)
    coords = [torch.arange(outs[d], device=x.device).reshape(
        _out_grid(outs, d)) * s[d] + offs[d] - pads[d][0]
        for d in range(nd)]
    return val, _flat_index(coords, spatial)


def _adaptive_max_with_index(x, output_size, nd):
    """(pooled, int32 flat indices) of an adaptive max pool: each dim's
    windows ``[floor(i n / o), ceil((i + 1) n / o))`` gathered to the
    longest one's width (the rest filled with the lowest value), then
    the first maximum in window order."""
    spatial = tuple(x.shape[2:])
    outs = _sizes(output_size, nd, spatial)
    win, keep, starts = x, None, []
    for d, (n, o) in enumerate(zip(spatial, outs)):
        bounds = [(i * n // o, -(-(i + 1) * n // o)) for i in range(o)]
        kmax = max(b - a for a, b in bounds)
        lo, hi = (torch.tensor(v, device=x.device) for v in zip(*bounds))
        idx = lo[:, None] + torch.arange(kmax, device=x.device)
        ok = idx < hi[:, None]  # [o, kmax]
        win = win.index_select(2 + d, idx.clamp(max=n - 1).reshape(-1))
        win = win.reshape(win.shape[:2 + d] + idx.shape + win.shape[3 + d:])
        win = win.movedim(3 + d, -1)
        shape = [1] * (2 * nd)
        shape[d], shape[nd + d] = ok.shape
        keep = ok.reshape(shape) if keep is None else keep & ok.reshape(shape)
        starts.append(lo)
    win = torch.where(keep, win, _lowest(x.dtype))
    val, first = _first_max(win.reshape(win.shape[:2 + nd] + (-1,)))
    kdims = win.shape[2 + nd:]
    offs = _window_coords(first, kdims)
    coords = [starts[d].reshape(_out_grid(outs, d)) + offs[d]
              for d in range(nd)]
    return val, _flat_index(coords, spatial)


def _max_unpool(x, indices, nd, kernel_size, stride, padding, output_size,
                op_name):
    """Scatter ``x``'s values to their flat ``indices`` in a zero plane
    of ``output_size`` (its last ``nd`` entries), or of ``(in - 1) *
    stride - 2 * padding + kernel`` per dim (``pooling.py:289-338``)."""
    k, s = _window(nd, kernel_size, stride)
    x, indices = cast_inputs(op_name, *tensors(x, indices))
    if output_size is not None:
        out_sp = tuple(shape_list(output_size))[-nd:]
    else:
        pads = padding if isinstance(padding, (list, tuple)) \
            else [padding] * nd
        out_sp = tuple((x.shape[2 + d] - 1) * s[d] - 2 * pads[d] + k[d]
                       for d in range(nd))
    n, c = x.shape[:2]
    out = torch.zeros((n * c, math.prod(out_sp)), dtype=x.dtype,
                      device=x.device)
    out = out.scatter(1, indices.reshape(n * c, -1).long(),
                      x.reshape(n * c, -1))
    return out.reshape((n, c) + out_sp)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCL", name=None):
    """The inverse of ``max_pool1d(return_mask=True)`` (``data_format``
    is accepted, channel-first as in the reference)."""
    return _max_unpool(x, indices, 1, kernel_size, stride, padding,
                       output_size, "unpool")


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCHW", name=None):
    return _max_unpool(x, indices, 2, kernel_size, stride, padding,
                       output_size, "unpool")


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCDHW", name=None):
    return _max_unpool(x, indices, 3, kernel_size, stride, padding,
                       output_size, "unpool3d")
