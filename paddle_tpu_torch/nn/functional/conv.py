"""Convolutions (counterpart of ``paddle_tpu/nn/functional/conv.py``).

The reference convolves through ``lax.conv_general_dilated``, which XLA
tiles itself: no Pallas kernel. Here each call is one
``torch.nn.functional.conv{1,2,3}d`` (cuDNN on the card). If cuDNN
refuses a call, the error is raised; nothing tries another route.

- The weight is ``[out, in / groups, *k]`` in both layouts, as the
  reference's is (it transposes to HWIO for channel-last, ``conv.py:
  58-66``), so a ``state_dict`` does not depend on the layout.
- Channel-last input (``NLC``, ``NHWC``, ``NDHWC``) is moved to
  channel-first by ``movedim``: on a contiguous channel-last tensor that
  is a view in torch's ``channels_last`` memory format, which cuDNN
  convolves without a copy, and the output moves back the same way.
- Paddle's padding forms: an int, ``nd`` ints, ``2 * nd`` ints (a low
  and a high side per dim), ``nd`` pairs, ``'SAME'`` (XLA's: the larger
  half on the high side, any stride) and ``'VALID'``. Torch's own
  padding takes only the symmetric forms; an asymmetric one is applied
  with ``F.pad`` first.

The transposed convolutions (``conv1d/2d/3d_transpose``) are
``torch.nn.functional.conv_transpose{1,2,3}d``, the weight in Paddle's
``[in, out / groups, *k]``, which is torch's too. The reference computes
them as the gradient of the forward convolution (``conv.py:105-180``):
the output size is ``(in - 1) * stride - 2 * padding + dilation * (k -
1) + 1 + output_padding``, or ``output_size`` when given (passed to
torch as the output padding it implies). Padding is an int or ``nd``
ints; the reference refuses ``'SAME'`` and ``'VALID'`` there, and so
does the port.
"""
from __future__ import annotations

import torch

from ...amp.auto_cast import cast_inputs
from ...tensor._common import shape_list

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_CONV = {1: torch.nn.functional.conv1d, 2: torch.nn.functional.conv2d,
         3: torch.nn.functional.conv3d}
_CONV_T = {1: torch.nn.functional.conv_transpose1d,
           2: torch.nn.functional.conv_transpose2d,
           3: torch.nn.functional.conv_transpose3d}


def _ntuple(v, n):
    if isinstance(v, int):
        return (v,) * n
    v = tuple(v)
    return v * n if len(v) == 1 else v


def _same_pads(in_sizes, ksizes, strides, dilations):
    """XLA's ``'SAME'`` pads (``lax.padtype_to_pads``) over the dilated
    window: ``ceil(in / s)`` outputs, the larger half of the padding on
    the high side."""
    pads = []
    for n, k, s, d in zip(in_sizes, ksizes, strides, dilations):
        eff = (k - 1) * d + 1
        total = max((-(-n // s) - 1) * s + eff - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _resolve_padding(padding, nd, in_sizes, ksizes, strides, dilations):
    """Paddle's padding as ``nd`` (low, high) pairs."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0)] * nd
        if mode == "SAME":
            return _same_pads(in_sizes, ksizes, strides, dilations)
        raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    padding = list(padding)
    if all(isinstance(p, int) for p in padding):
        if len(padding) == nd:
            return [(p, p) for p in padding]
        if len(padding) == 2 * nd:
            return [(padding[2 * i], padding[2 * i + 1]) for i in range(nd)]
    return [tuple(p) for p in padding]


def pad_spatial(x, pads, value=0.0):
    """``x`` (channel-first) with explicit (low, high) pads on its last
    ``len(pads)`` dims."""
    flat = []
    for lo, hi in reversed(pads):  # F.pad lists the last dim first
        flat += [lo, hi]
    return torch.nn.functional.pad(x, flat, value=value)


def _conv(x, weight, bias, stride, padding, dilation, groups, channel_last,
          nd, op_name):
    x, weight, bias = cast_inputs(op_name, x, weight, bias)
    strides = _ntuple(stride, nd)
    dilations = _ntuple(dilation, nd)
    if channel_last:
        x = x.movedim(-1, 1)
    pads = _resolve_padding(padding, nd, x.shape[2:], weight.shape[2:],
                            strides, dilations)
    if all(lo == hi for lo, hi in pads):
        torch_pad = tuple(lo for lo, _ in pads)
    else:
        x = pad_spatial(x, pads)
        torch_pad = 0
    out = _CONV[nd](x, weight, bias, strides, torch_pad, dilations, groups)
    return out.movedim(1, -1) if channel_last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    """1-D convolution of ``x`` ``[N, C, L]`` (``NLC``: ``[N, L, C]``)."""
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format not in ("NCL", "NCW"), 1, "conv1d")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """2-D convolution of ``x`` ``[N, C, H, W]`` (``NHWC``:
    ``[N, H, W, C]``)."""
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 not data_format.startswith("NC"), 2, "conv2d")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    """3-D convolution of ``x`` ``[N, C, D, H, W]`` (``NDHWC``:
    ``[N, D, H, W, C]``)."""
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 not data_format.startswith("NC"), 3, "conv3d")


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, channel_last, nd, op_name,
                    output_size):
    if isinstance(padding, str):
        raise NotImplementedError(
            f"{op_name}(padding={padding!r}): 'SAME' and 'VALID' are not "
            f"taken for transposed convolutions (the reference refuses "
            f"them too); pass ints")
    x, weight, bias = cast_inputs(op_name, x, weight, bias)
    strides = _ntuple(stride, nd)
    dilations = _ntuple(dilation, nd)
    pads = _ntuple(padding, nd)
    out_pad = _ntuple(output_padding, nd)
    if channel_last:
        x = x.movedim(-1, 1)
    if output_size is not None:
        ksz = weight.shape[2:]
        base = [(x.shape[2 + i] - 1) * strides[i] - 2 * pads[i]
                + dilations[i] * (ksz[i] - 1) + 1 for i in range(nd)]
        out_pad = tuple(int(o) - b for o, b in zip(
            _ntuple(shape_list(output_size), nd), base))
    out = _CONV_T[nd](x, weight, bias, strides, pads, out_pad, groups,
                      dilations)
    return out.movedim(1, -1) if channel_last else out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups,
                           data_format not in ("NCL", "NCW"), 1,
                           "conv1d_transpose", output_size)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, not data_format.startswith("NC"),
                           2, "conv2d_transpose", output_size)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, not data_format.startswith("NC"),
                           3, "conv3d_transpose", output_size)
