"""Statistics (counterpart of ``paddle_tpu/tensor/stat.py``).

``median`` defaults to the average of the two middle values, as the
reference does (``torch.median`` takes the lower one). ``histogram``
(with its range taken from the data), ``histogramdd`` and ``bincount``
read sizes or bounds on the host, so a ``TrainStep`` graph cannot hold
them.
"""
from __future__ import annotations

import torch

from ..amp.auto_cast import cast_inputs
from ._common import axes, canon, float_of, tensors
from .math import mean  # noqa: F401  (mean lives in math, re-exported)


def _op(name, *xs):
    return cast_inputs(name, *tensors(*xs))


def _moments(name, fn, x, axis, unbiased, keepdim):
    (a,) = _op(name, x)
    return canon(fn(float_of(a), axes(axis, a.dim()),
                    correction=1 if unbiased else 0, keepdim=keepdim))


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _moments("std", torch.std, x, axis, unbiased, keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _moments("var", torch.var, x, axis, unbiased, keepdim)


def _last(a, axis):
    """``a`` with the dims of ``axis`` moved last and flattened into one,
    and a function that puts a reduced result back with keepdim."""
    dims = axes(axis, a.dim())
    rest = [d for d in range(a.dim()) if d not in dims]
    moved = a.permute(*rest, *dims).reshape(
        [a.shape[d] for d in rest] + [-1])

    def keep(out):
        shape = list(out.shape[:out.dim() - len(rest)]) + [
            1 if d in dims else a.shape[d] for d in range(a.dim())]
        return out.reshape(shape)
    return moved, keep


def _middle(s, k):
    """The lower and upper middle values of the sorted rows ``s`` whose
    first ``k`` entries count."""
    lo = torch.gather(s, -1, torch.clamp_min((k - 1) // 2, 0)[..., None])
    hi = torch.gather(s, -1, torch.clamp_min(k // 2, 0)[..., None])
    return lo[..., 0], hi[..., 0]


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    """The median along ``axis`` (all dims by default): the mean of the two
    middle values (``mode="avg"``, float) or the lower one
    (``mode="min"``, in x's dtype)."""
    (a,) = _op("median", x)
    rows, keep = _last(a, axis)
    n = rows.shape[-1]
    s = torch.sort(rows, -1).values
    k = torch.full(rows.shape[:-1], n, dtype=torch.long, device=a.device)
    lo, hi = _middle(s, k)
    out = (float_of(lo) + float_of(hi)) / 2 if mode == "avg" else lo
    return canon(keep(out) if keepdim else out)


def nanmedian(x, axis=None, keepdim=False, name=None):
    """The median of the non-NaN values (the mean of the two middle
    ones); NaN where every value is NaN."""
    (a,) = _op("nanmedian", x)
    rows, keep = _last(float_of(a), axis)
    s = torch.sort(rows, -1).values  # NaN sorts last
    k = (~torch.isnan(rows)).sum(-1)
    lo, hi = _middle(s, k)
    out = torch.where(k > 0, (lo + hi) / 2,
                      torch.full_like(lo, float("nan")))
    return canon(keep(out) if keepdim else out)


def _quantile(name, fn, x, q, axis, keepdim, interpolation):
    (a,) = _op(name, x)
    rows, keep = _last(float_of(a), axis)
    qq = q.to(rows) if isinstance(q, torch.Tensor) else torch.tensor(
        q, dtype=rows.dtype, device=rows.device)
    out = fn(rows, qq, dim=-1, interpolation=interpolation)
    return canon(keep(out) if keepdim else out)


def quantile(x, q, axis=None, keepdim=False, interpolation="linear", name=None):
    """The ``q`` quantiles (a number or a list, the list's dim first)
    along ``axis``."""
    return _quantile("quantile", torch.quantile, x, q, axis, keepdim,
                     interpolation)


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear", name=None):
    return _quantile("nanquantile", torch.nanquantile, x, q, axis, keepdim,
                     interpolation)


def _bin_index(a, lo, hi, bins):
    """numpy's bin of each value of ``a`` in ``bins`` equal bins over
    [lo, hi] (the last bin closed), and which values lie in range."""
    edges = torch.linspace(lo, hi, bins + 1, dtype=torch.float64,
                           device=a.device)
    v = a.to(torch.float64)
    i = torch.clamp(((v - lo) * (bins / (hi - lo))).floor().long(),
                    0, bins - 1)
    i = i - (v < edges[i]).long()
    i = i + ((v >= edges[i + 1]) & (i != bins - 1)).long()
    return torch.clamp(i, 0, bins - 1), (v >= lo) & (v <= hi), edges


def _range(a, lo, hi):
    if lo == 0 and hi == 0:
        lo, hi = float(a.min()), float(a.max())
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    return float(lo), float(hi)


def histogram(input, bins=100, min=0, max=0, weight=None, density=False, name=None):  # noqa: A002
    """Counts of ``input`` in ``bins`` equal bins over [min, max] (the
    data's range when both are 0), int32; float with ``weight`` or
    ``density``. The range is read on the host."""
    a, w = tensors(input, weight)
    a = a.reshape(-1)
    lo, hi = _range(a, min, max)
    i, ok, edges = _bin_index(a, lo, hi, bins)
    wt = (torch.ones_like(a, dtype=torch.float64) if w is None
          else w.reshape(-1).to(torch.float64))
    hist = torch.zeros(bins, dtype=torch.float64, device=a.device) \
        .index_add_(0, i[ok], wt[ok])
    if density:
        hist = hist / hist.sum() / torch.diff(edges)
    elif w is None:
        hist = hist.round().long()
    return canon(hist)


def histogramdd(x, bins=10, ranges=None, density=False, weights=None, name=None):
    """The D-dimensional histogram of the rows of ``x`` ``[n, D]`` (float)
    and each dim's bin edges. ``ranges`` pairs ``(lo, hi)`` per dim, or
    the flat list of them; the data's range by default."""
    a, w = tensors(x, weights)
    a = a.reshape(-1, a.shape[-1])
    nd = a.shape[1]
    nb = [bins] * nd if isinstance(bins, int) else [int(b) for b in bins]
    if ranges is not None and len(ranges) == 2 * nd \
            and not isinstance(ranges[0], (list, tuple)):
        ranges = [ranges[2 * d:2 * d + 2] for d in range(nd)]
    flat = torch.zeros(a.shape[0], dtype=torch.long, device=a.device)
    ok = torch.ones(a.shape[0], dtype=torch.bool, device=a.device)
    edges = []
    for d in range(nd):
        lo, hi = (_range(a[:, d], 0, 0) if ranges is None
                  else _range(a[:, d], *ranges[d]))
        i, inside, e = _bin_index(a[:, d], lo, hi, nb[d])
        flat = flat * nb[d] + i
        ok &= inside
        edges.append(e)
    wt = (torch.ones(a.shape[0], dtype=torch.float64, device=a.device)
          if w is None else w.reshape(-1).to(torch.float64))
    total = 1
    for b in nb:
        total *= b
    hist = torch.zeros(total, dtype=torch.float64, device=a.device) \
        .index_add_(0, flat[ok], wt[ok]).reshape(nb)
    if density:
        vol = edges[0].diff()
        for e in edges[1:]:
            vol = vol[..., None] * e.diff()
        hist = hist / hist.sum() / vol
    return canon(hist), canon(edges)


def bincount(x, weights=None, minlength=0, name=None):
    """Counts of each non-negative int (int32; float with ``weights``).
    Its size depends on the data and is read on the host."""
    a, w = tensors(x, weights)
    return canon(torch.bincount(a.reshape(-1).long(), w, minlength))


def corrcoef(x, rowvar=True, name=None):
    (a,) = _op("corrcoef", x)
    return canon(torch.corrcoef(a if rowvar else a.t()))


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    a, fw, aw = tensors(x, fweights, aweights)
    (a,) = cast_inputs("cov", a)
    return canon(torch.cov(a if rowvar else a.t(), correction=int(ddof),
                           fweights=None if fw is None else fw.long(),
                           aweights=aw))

