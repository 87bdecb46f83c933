"""Linear, dropout, embedding, padding, resampling and the other common
ops (counterpart of ``paddle_tpu/nn/functional/common.py``).

The reference computes each through ``apply`` as plain XLA: no Pallas
kernel. Here each is torch ops on the device of its input, cast by
``amp.auto_cast`` under the reference's op name, outputs narrowed to the
reference's 32-bit dtypes (``tensor._common.canon``). Where the
reference reads values on the host, so does the port: ``pad`` and
``interpolate`` given a tensor for a size, ``sequence_mask`` without
``maxlen``, ``class_center_sample`` (its sampling runs on the host in
both) and ``edit_distance``'s ``ignored_tokens`` (``loss.py``).

The random functions (``dropout`` and its 2-D, 3-D and alpha forms)
draw from ``framework.random.generator`` of the input's device and count
each draw (``note_draw``); the reference draws from ``jax.random``, so
the masks differ for one seed and the tests compare their statistics.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ...amp.auto_cast import cast_inputs
from ...framework import random
from ...tensor._common import canon, dtype_of, shape_list, tensors

__all__ = ["linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "embedding", "one_hot", "label_smooth", "pad", "zeropad2d",
           "normalize", "cosine_similarity", "pairwise_distance",
           "pixel_shuffle", "pixel_unshuffle", "channel_shuffle",
           "interpolate", "upsample", "unfold", "fold", "bilinear",
           "grid_sample", "affine_grid", "sequence_mask",
           "class_center_sample", "gather_tree", "temporal_shift",
           "diag_embed", "sparse_attention"]

_F = torch.nn.functional


def linear(x, weight, bias=None, name=None):
    """``x @ weight (+ bias)`` with ``weight`` in Paddle's ``[in, out]``
    layout (the reference's op ``linear``: white under ``auto_cast``, so
    x, weight and bias are cast to the low dtype there)."""
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


_DROPOUT_MODES = ("upscale_in_train", "downscale_in_infer")


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Zero each element with probability ``p`` while ``training``
    (``common.py:27-50``).

    - ``upscale_in_train`` (the default) scales the kept elements by
      ``1 / (1 - p)`` in training and is the identity outside it;
    - ``downscale_in_infer`` keeps them unscaled in training and
      multiplies by ``1 - p`` outside it;
    - ``axis`` (an int or a list) draws one Bernoulli value per index of
      those dims and broadcasts it over the others (``axis=[0, 1]`` on
      ``NCHW`` drops whole channels);
    - ``p == 1`` gives zeros in training.

    The mask comes from the device's dropout generator
    (``framework.random.generator``)."""
    if mode not in _DROPOUT_MODES:
        raise ValueError(f"dropout mode must be one of {_DROPOUT_MODES}, "
                         f"got {mode!r}")
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout p must be in [0, 1], got {p!r}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training and p > 0.0:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if axis is not None:
        axes = {a % x.dim() for a in (axis if isinstance(axis, (list, tuple))
                                      else [axis])}
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    random.note_draw()
    keep = torch.empty(shape, dtype=torch.float32, device=x.device)
    keep.bernoulli_(1.0 - p, generator=random.generator(x.device))
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep.bool(), kept,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Drops whole channels of a 4-D ``x``: one draw per (batch,
    channel)."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    """Drops whole channels of a 5-D ``x``."""
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=axis, training=training)


_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU's dropout: a dropped element becomes ``-alpha * scale``, then
    ``a * x + b`` keeps the mean and variance of a standard normal input
    (the reference's fp32 coefficients)."""
    if not training or p == 0.0:
        return x
    (x,) = cast_inputs("alpha_dropout", x)
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    coef_a = np.float32(1.0 / np.sqrt((1 - p) * (1 + p * alpha_p ** 2)))
    coef_b = -coef_a * p * alpha_p
    random.note_draw()
    keep = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    keep.bernoulli_(1.0 - p, generator=random.generator(x.device))
    dropped = torch.full((), alpha_p, dtype=x.dtype, device=x.device)
    return float(coef_a) * torch.where(keep.bool(), x, dropped) \
        + float(coef_b)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the indices ``x``; with ``padding_idx``
    (negative counts from the end) those positions give zeros, so that
    row gets no gradient from them (``sparse`` is accepted and
    ignored, as in the reference)."""
    x, weight = cast_inputs("embedding", *tensors(x, weight))
    out = weight[x.long()]
    if padding_idx is not None:
        pad_row = padding_idx if padding_idx >= 0 \
            else weight.shape[0] + padding_idx
        out = out * (x != pad_row)[..., None].to(out.dtype)
    return out


def one_hot(x, num_classes, name=None):
    """fp32 one-hot rows of ``num_classes`` (an index outside the range
    gives a zero row, as ``jax.nn.one_hot`` does)."""
    (x,) = cast_inputs("one_hot", *tensors(x))
    classes = torch.arange(int(num_classes), device=x.device)
    return (x[..., None] == classes).to(torch.float32)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """``(1 - epsilon) * label + epsilon * prior`` (uniform ``1 / k``
    without ``prior_dist``)."""
    label, prior_dist = cast_inputs("label_smooth",
                                    *tensors(label, prior_dist))
    if prior_dist is None:
        return (1 - epsilon) * label + epsilon / label.shape[-1]
    return (1 - epsilon) * label + epsilon * prior_dist


_PAD_MODES = ("constant", "reflect", "replicate", "circular")


def _pad_index(n, lo, hi, mode, device):
    """Source indices of a dim of size ``n`` padded by ``(lo, hi)``:
    numpy's ``edge`` (replicate), ``wrap`` (circular) and ``reflect``
    (mirrored without the edge, repeating past one period)."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "circular":
        return i % n
    if n == 1:
        return torch.zeros_like(i)
    j = i % (2 * n - 2)
    return torch.where(j >= n, 2 * n - 2 - j, j)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW",  # noqa: A002
        name=None):
    """Paddle's ``pad``: ``len(pad) == 2 * x.dim()`` gives a (low, high)
    pair for every dim in order; a shorter list gives pairs for the
    spatial dims (after ``N, C`` for ``NC*`` layouts, between ``N`` and
    ``C`` else) from the last backwards (``common.py:113-145``). Modes
    ``constant`` (``value``), ``reflect``, ``replicate`` and ``circular``
    as numpy's ``constant``, ``reflect``, ``edge`` and ``wrap``. A
    tensor ``pad`` is read on the host."""
    if mode not in _PAD_MODES:
        raise ValueError(f"pad mode must be one of {_PAD_MODES}, got "
                         f"{mode!r}")
    pad = shape_list(pad)
    (x,) = cast_inputs("pad", *tensors(x))
    nd = x.dim()
    cfg = [(0, 0)] * nd
    if len(pad) == 2 * nd:
        cfg = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        spatial = list(range(2, nd)) if data_format.startswith("NC") \
            else list(range(1, nd - 1))
        if len(pad) // 2 > len(spatial):
            raise ValueError(f"pad of {len(pad)} values is longer than the "
                             f"{len(spatial)} spatial dims of "
                             f"{data_format}")
        for i in range(len(pad) // 2):
            cfg[spatial[-(i + 1)]] = (pad[2 * i], pad[2 * i + 1])
    if mode == "constant":
        flat = [v for lo_hi in reversed(cfg) for v in lo_hi]
        return _F.pad(x, flat, value=value)
    for dim, (lo, hi) in enumerate(cfg):
        if lo or hi:
            x = x.index_select(dim, _pad_index(x.shape[dim], lo, hi, mode,
                                               x.device))
    return x


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x / max(||x||_p, epsilon)`` over ``axis``."""
    (x,) = cast_inputs("normalize", x)
    n = torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=True)
    return x / n.clamp(min=epsilon)


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    """``sum(x1 * x2) / max(||x1|| ||x2||, eps)`` over ``axis`` (the
    product of the norms clamped, not each norm as torch's op does)."""
    a, b = cast_inputs("cosine_similarity", x1, x2)
    dot = (a * b).sum(axis)
    na = torch.linalg.vector_norm(a, dim=axis)
    nb = torch.linalg.vector_norm(b, dim=axis)
    return dot / (na * nb).clamp(min=eps)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """``||x - y + epsilon||_p`` over the last dim."""
    a, b = cast_inputs("pairwise_distance", x, y)
    return torch.linalg.vector_norm(a - b + epsilon, ord=p, dim=-1,
                                     keepdim=keepdim)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    (x,) = cast_inputs("pixel_shuffle", x)
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, c // (r * r))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    (x,) = cast_inputs("pixel_unshuffle", x)
    r = downscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return x.reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = x.shape
    x = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // r, w // r, c * r * r)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    (x,) = cast_inputs("channel_shuffle", x)
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, groups, c // groups, h, w).permute(0, 2, 1, 3, 4)
        return x.reshape(n, c, h, w)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, groups, c // groups).permute(0, 1, 2, 4, 3)
    return x.reshape(n, h, w, c)


_INTERP_KIND = {"nearest": "nearest", "area": "area", "linear": "linear",
                "bilinear": "linear", "trilinear": "linear",
                "bicubic": "cubic"}


@functools.lru_cache(maxsize=256)
def _axis_weights(n_in, n_out, kind, align_corners, align_mode):
    """``[n_out, n_in]`` float64 resampling matrix of one axis, the
    reference's ``_axis_weights`` (``common.py:245-291``): ``nearest``
    takes ``rint`` of the corner-aligned source with ``align_corners``,
    else its floor; ``area`` averages ``[floor(j n_in / n_out),
    ceil((j + 1) n_in / n_out))``; ``linear`` and ``cubic`` (Keys, A =
    -0.75) sample at the corner-aligned, asymmetric (``align_mode`` 1,
    linear only) or half-pixel source coordinate, the taps clipped to
    the edge. Cached by its arguments: a model resamples few sizes."""
    j = np.arange(n_out, dtype=np.float64)
    w = np.zeros((n_out, n_in), dtype=np.float64)
    rows = np.arange(n_out)
    if kind == "nearest":
        if align_corners:
            src = np.rint(j * (n_in - 1) / max(n_out - 1, 1)).astype(int)
        else:
            src = np.floor(j * n_in / n_out).astype(int)
        w[rows, np.clip(src, 0, n_in - 1)] = 1.0
        return w
    if kind == "area":
        for jj in range(n_out):
            start = int(np.floor(jj * n_in / n_out))
            end = max(int(np.ceil((jj + 1) * n_in / n_out)), start + 1)
            w[jj, start:end] = 1.0 / (end - start)
        return w
    if align_corners:
        src = j * (n_in - 1) / max(n_out - 1, 1)
    elif kind == "linear" and align_mode == 1:
        src = j * (n_in / n_out)
    else:
        src = (j + 0.5) * (n_in / n_out) - 0.5
    if kind == "linear":
        src = np.clip(src, 0, n_in - 1)
        lo = np.floor(src).astype(int)
        hi = np.minimum(lo + 1, n_in - 1)
        frac = src - lo
        np.add.at(w, (rows, lo), 1.0 - frac)
        np.add.at(w, (rows, hi), frac)
        return w
    a = -0.75

    def cubic(t):
        t = np.abs(t)
        return np.where(
            t <= 1, (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1,
            np.where(t < 2, a * t ** 3 - 5 * a * t ** 2 + 8 * a * t - 4 * a,
                     0.0))
    base = np.floor(src).astype(int)
    for tap in (-1, 0, 1, 2):
        idx = base + tap
        np.add.at(w, (rows, np.clip(idx, 0, n_in - 1)), cubic(src - idx))
    return w


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resampling of the spatial dims (``common.py:215-325``), separable:
    each axis is multiplied by its ``[n_out, n_in]`` weight matrix
    (:func:`_axis_weights`, built on the host in float64 and cast to the
    compute dtype) through ``tensordot``, not ``torch.nn.functional.
    interpolate``, whose rules differ: ``nearest`` with
    ``align_corners`` rounds, and with ``scale_factor`` the ratio is
    ``n_in / n_out`` of the integer target ``int(n_in * scale)``.
    Integer input is computed in fp32 and cast back (``nearest``
    through ``rint``). An int ``size`` sizes the first spatial dim only,
    as the reference's does; a tensor ``size`` is read on the host."""
    if isinstance(size, torch.Tensor):
        size = [int(s) for s in size.reshape(-1).tolist()]
    mode = mode.lower()
    if mode not in _INTERP_KIND:
        raise ValueError(f"unsupported interpolate mode {mode!r}")
    kind = _INTERP_KIND[mode]
    (x,) = cast_inputs("interpolate", x)
    nd = x.dim()
    spatial = list(range(1, nd - 1)) if not data_format.startswith("NC") \
        else list(range(2, nd))
    if size is not None:
        tgt = [int(s) for s in size] if isinstance(size, (list, tuple)) \
            else [int(size)]
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else [scale_factor] * len(spatial)
        tgt = [int(x.shape[d] * s) for d, s in zip(spatial, sf)]
    dt = x.dtype if x.is_floating_point() else torch.float32
    out = x.to(dt)
    for d, n_out in zip(spatial, tgt):
        n_in = out.shape[d]
        if n_in == n_out:
            continue
        w = torch.from_numpy(_axis_weights(n_in, n_out, kind,
                                           bool(align_corners),
                                           int(align_mode)))
        w = w.to(device=x.device, dtype=dt)
        out = torch.tensordot(out, w, dims=([d], [1])).movedim(-1, d)
    if out.dtype != x.dtype:
        out = (torch.round(out) if kind == "nearest" else out).to(x.dtype)
    return out


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col of ``[N, C, H, W]``: ``[N, C * kh * kw, L]``, channels
    outer and the window row-major inside, as the reference's patches;
    ``paddings`` an int, ``(ph, pw)`` or ``(top, left, bottom,
    right)``."""
    (x,) = cast_inputs("unfold", x)
    if isinstance(paddings, (list, tuple)) and len(paddings) == 4:
        pt, pl, pb, pr = paddings
    else:
        ph, pw = _pair(paddings)
        pt, pl, pb, pr = ph, pw, ph, pw
    x = _F.pad(x, (pl, pr, pt, pb))
    return _F.unfold(x, _pair(kernel_sizes), dilation=_pair(dilations),
                     stride=_pair(strides))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the adjoint of :func:`unfold` (overlaps summed)."""
    (x,) = cast_inputs("fold", x)
    return _F.fold(x, _pair(output_sizes), _pair(kernel_sizes),
                   dilation=_pair(dilations), padding=_pair(paddings),
                   stride=_pair(strides))


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] @ weight[o] @ x2[b] (+ bias)``."""
    a, b, w, bias = cast_inputs("bilinear", x1, x2, weight, bias)
    out = torch.einsum("bi,oij,bj->bo", a, w, b)
    return out if bias is None else out + bias


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Bilinear sampling of ``x`` ``[N, C, H, W]`` at ``grid`` ``[N, Ho,
    Wo, 2]`` (x then y in ``[-1, 1]``), zero outside: the only function
    the reference computes (``common.py:391-415``), whatever ``mode`` and
    ``padding_mode`` say, so any other value raises here. The default
    ``align_corners`` is the reference's (True; torch's is False)."""
    if mode != "bilinear" or padding_mode != "zeros":
        raise NotImplementedError(
            f"grid_sample(mode={mode!r}, padding_mode={padding_mode!r}): "
            f"the reference samples bilinearly with zero padding whatever "
            f"these say; the port computes only that")
    a, g = cast_inputs("grid_sample", x, grid)
    return _F.grid_sample(a, g.to(a.dtype), mode="bilinear",
                          padding_mode="zeros",
                          align_corners=bool(align_corners))


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """The ``[N, H, W, 2]`` sampling grid of the affine maps ``theta``
    ``[N, 2, 3]`` over an ``out_shape`` ``[N, C, H, W]`` output (read on
    the host when a tensor)."""
    _, _, h, w = shape_list(out_shape)
    (th,) = cast_inputs("affine_grid", theta)
    dev = th.device

    def coords(n):
        if align_corners:
            return torch.linspace(-1, 1, n, device=dev)
        return (torch.arange(n, device=dev) * 2 + 1) / n - 1
    gy, gx = torch.meshgrid(coords(h), coords(w), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum("hwk,nok->nhwo", base.to(th.dtype), th)


def sequence_mask(lengths, maxlen=None, dtype="int64", name=None):
    """``mask[..., j] = j < lengths[...]`` of width ``maxlen`` (the
    longest length, read on the host, when None), in ``dtype`` narrowed
    as the reference narrows it (int64 gives int32)."""
    (lengths,) = cast_inputs("sequence_mask", *tensors(lengths))
    m = int(lengths.max()) if maxlen is None else int(maxlen)
    out = torch.arange(m, device=lengths.device) < lengths[..., None]
    return out.to(dtype_of(dtype))


def class_center_sample(label, num_classes, num_samples, group=None):
    """The class centers of a partial-fc margin loss
    (``common.py:451-480``): every positive class of ``label`` and
    ``num_samples`` less their count of the others, drawn without
    replacement, sorted; returns ``(remapped label, sampled classes)``
    (int32), the labels remapped into the sampled set. It runs on the
    host, as the reference does; the draw is ``torch.randperm`` from the
    CPU's generator (one counted draw), not JAX's permutation.
    ``group`` is ignored, as in the reference."""
    lab_t = label if isinstance(label, torch.Tensor) else torch.as_tensor(
        np.asarray(label))
    orig = lab_t.detach().cpu().numpy()
    lab = orig.reshape(-1)
    positives = np.unique(lab)
    if num_samples < positives.size:
        raise ValueError(
            f"class_center_sample: num_samples={num_samples} is smaller "
            f"than the {positives.size} distinct positive classes")
    if num_samples > num_classes:
        raise ValueError(
            f"class_center_sample: num_samples={num_samples} exceeds "
            f"num_classes={num_classes}; the sampled set is a subset of "
            "the classes, so its static size cannot exceed num_classes")
    negatives = np.setdiff1d(np.arange(num_classes), positives)
    random.note_draw()
    perm = torch.randperm(negatives.size,
                          generator=random.generator("cpu")).numpy()
    n_extra = num_samples - positives.size
    sampled = np.sort(np.concatenate([positives, negatives[perm[:n_extra]]]))
    remapped = np.searchsorted(sampled, lab).reshape(orig.shape)
    dev = lab_t.device
    return (torch.from_numpy(remapped.astype(np.int32)).to(dev),
            torch.from_numpy(sampled.astype(np.int32)).to(dev))


def gather_tree(ids, parents):
    """Beam-search backtrace: ``ids`` and ``parents`` ``[T, B, K]``; the
    last step keeps its beams, each earlier step takes the beams its
    successor's parents name (``extension.py:248``). A loop over T of
    batched gathers on the device; no gradient."""
    ids, parents = tensors(ids, parents)
    out = [ids[-1]]
    sel = parents[-1].long()
    for t in range(ids.shape[0] - 2, -1, -1):
        out.append(torch.gather(ids[t], 1, sel))
        sel = torch.gather(parents[t], 1, sel).long()
    return canon(torch.stack(out[::-1]))


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None,
                   data_format="NCHW"):
    """TSM's shift of ``[N * T, C, H, W]`` (``T = seg_num``): the first
    ``shift_ratio`` of the channels take step ``t - 1``'s values, the
    next ``shift_ratio`` step ``t + 1``'s, zeros past the ends."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"unsupported data_format {data_format!r}")
    (x,) = cast_inputs("temporal_shift", x)
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    nt, c, h, w = x.shape
    n = nt // seg_num
    v = x.reshape(n, seg_num, c, h, w)
    c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
    zero = torch.zeros((n, 1, c, h, w), dtype=x.dtype, device=x.device)
    fwd = torch.cat([v[:, 1:], zero], dim=1)
    bwd = torch.cat([zero, v[:, :-1]], dim=1)
    out = torch.cat([bwd[:, :, :c1], fwd[:, :, c1:c2], v[:, :, c2:]], dim=2)
    out = out.reshape(nt, c, h, w)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):  # noqa: A002
    """``paddle_tpu_torch.diag_embed`` at the functional namespace."""
    from ...tensor.manipulation import diag_embed as _diag_embed

    return _diag_embed(input, offset=offset, dim1=dim1, dim2=dim2)


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Attention of ``[B, H, T, D]`` inputs where each query row sees only
    the keys its CSR row lists (``offset`` ``[B, H, T + 1]``, ``columns``
    ``[B, H, nnz]``; ``common.py:550-594``). As in the reference the
    pattern becomes a dense ``[B, H, T, T]`` additive bias (0 or
    -1e30), plus ``(key_padding_mask - 1) * 1e30`` and an additive
    ``attn_mask``, and the products stay dense: torch ops, since the
    reference computes it outside any Pallas kernel. An entry past the
    last row or column is dropped, as XLA drops an out-of-range
    scatter."""
    q, k, v, off, cols, kp, am = cast_inputs(
        "sparse_attention", query, key, value, sparse_csr_offset,
        sparse_csr_columns, key_padding_mask, attn_mask)
    b, h, t, d = q.shape
    nnz = cols.shape[-1]
    pos = torch.arange(nnz, device=q.device).expand(b, h, nnz).contiguous()
    rows = torch.searchsorted(off.long().contiguous(), pos, right=True) - 1
    cols = cols.long()
    ok = (rows >= 0) & (rows < t) & (cols >= 0) & (cols < t)
    hits = torch.zeros((b, h, t, t), dtype=torch.int32, device=q.device)
    hits.index_put_((torch.arange(b, device=q.device)[:, None, None]
                     .expand(b, h, nnz),
                     torch.arange(h, device=q.device)[None, :, None]
                     .expand(b, h, nnz),
                     rows.clamp(0, t - 1), cols.clamp(0, t - 1)),
                    ok.to(torch.int32), accumulate=True)
    bias = torch.where(hits > 0, 0.0, -1e30).to(q.dtype)
    if kp is not None:
        kp = kp.to(torch.float32) if kp.dtype == torch.bool else kp
        bias = bias + (kp[:, None, None, :] - 1.0) * 1e30
    if am is not None:
        bias = bias + am.expand(bias.shape).to(q.dtype)
    logits = torch.einsum("bhtd,bhsd->bhts", q, k) / torch.sqrt(
        torch.tensor(d, dtype=q.dtype, device=q.device))
    p = torch.softmax(logits + bias, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", p, v.to(p.dtype))
