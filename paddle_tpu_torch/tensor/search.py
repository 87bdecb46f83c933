"""Search and sort ops (counterpart of ``paddle_tpu/tensor/search.py``).

Indices come back int32, as the reference's. Ties break as the
reference breaks them: ``topk`` and ``kthvalue`` take the lower index
among equal values (``jax.lax.top_k`` and a stable sort), ``argsort``
is stable ascending and its reverse descending, ``mode`` takes the
largest of the most frequent values and its last index. ``nonzero``
(and ``where`` with only a condition) gives a shape that depends on the
data: it is read on the host, so a ``TrainStep`` graph cannot hold it.
"""
from __future__ import annotations

import torch

from ..amp.auto_cast import cast_inputs
from ._common import canon, dtype_of, promote, scalar, tensors


def _arg(fn, x, axis, keepdim, dtype):
    (a,) = tensors(x)
    if a.dtype == torch.bool:
        a = a.to(torch.uint8)
    if axis is None:
        out = fn(a.reshape(-1), 0)
        if keepdim:
            out = out.reshape([1] * a.dim())
    else:
        out = fn(a, axis, keepdim=keepdim)
    return out.to(dtype_of(dtype))


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    """The index of the first maximum (int32 for int64)."""
    return _arg(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    """The indices that sort ``x`` along ``axis``: equal values keep
    their order, and ``descending`` reverses the ascending order (equal
    values then come last index first), as the reference's sort does."""
    (a,) = tensors(x)
    idx = torch.sort(a, dim=axis, stable=True)[1]
    return (idx.flip(axis) if descending else idx).to(torch.int32)


def sort(x, axis=-1, descending=False, stable=False, name=None):
    (a,) = cast_inputs("sort", *tensors(x))
    return canon(torch.sort(a, dim=axis, descending=descending,
                            stable=True)[0])


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):  # noqa: A002
    """The ``k`` largest (or smallest) values along ``axis`` and their
    int32 indices, the lower index first among equal values."""
    (a,) = cast_inputs("topk", *tensors(x))
    kk = int(scalar(k))
    vals, idx = torch.sort(a, dim=axis, descending=largest, stable=True)
    return (canon(vals.narrow(axis, 0, kk)),
            idx.narrow(axis, 0, kk).to(torch.int32))


def where(condition, x=None, y=None, name=None):
    """``x`` where ``condition`` holds, else ``y``; with only the
    condition, :func:`nonzero` as a tuple."""
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    c, a, b = cast_inputs("where", *tensors(condition, x, y))
    return canon(torch.where(c.bool(), a, b))


def where_(condition, x, y, name=None):
    """:func:`where` written into ``x``."""
    return x.copy_(where(condition, x, y))


def nonzero(x, as_tuple=False):
    """The ``[n, ndim]`` int32 coordinates of the non-zero entries (a
    tuple of ``[n, 1]`` columns with ``as_tuple``). Its size depends on
    the data and is read on the host: a ``TrainStep`` graph cannot hold
    this op."""
    (a,) = tensors(x)
    nz = torch.nonzero(a).to(torch.int32)
    if as_tuple:
        return tuple(nz[:, i:i + 1] for i in range(nz.shape[1]))
    return nz


def searchsorted(sorted_sequence, values, out_int32=False, right=False, name=None):
    seq, v = promote(*tensors(sorted_sequence, values))
    return torch.searchsorted(seq.contiguous(), v.contiguous(), right=right,
                              out_int32=True)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    """The ``k``-th smallest value along ``axis`` and its int32 index in
    a stable sort."""
    (a,) = cast_inputs("kthvalue", *tensors(x))
    vals, idx = torch.sort(a, dim=axis, stable=True)
    v = vals.select(axis, k - 1)
    i = idx.select(axis, k - 1).to(torch.int32)
    if keepdim:
        v, i = v.unsqueeze(axis), i.unsqueeze(axis)
    return canon(v), i


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the largest among equally
    frequent ones) and the int32 index of its last occurrence."""
    (a,) = tensors(x)
    ax = axis % a.dim()
    rows = torch.movedim(a, ax, -1)
    flat = rows.reshape(-1, rows.shape[-1])
    s = torch.sort(flat, dim=-1).values
    start = torch.ones_like(s, dtype=torch.bool)
    start[:, 1:] = s[:, 1:] != s[:, :-1]
    group = torch.cumsum(start.long(), -1) - 1
    counts = torch.zeros_like(group).scatter_add_(
        -1, group, torch.ones_like(group))
    per = torch.gather(counts, -1, group)
    # sorted ascending: the last position with the top count holds the
    # largest of the most frequent values
    best = per == per.max(-1, keepdim=True).values
    last = torch.where(best, torch.arange(s.shape[-1], device=s.device),
                       -1).max(-1).values
    vals = torch.gather(s, -1, last[:, None])[:, 0]
    pos = torch.arange(flat.shape[-1], device=a.device)
    idxs = torch.where(flat == vals[:, None], pos, -1).max(-1).values
    vals = vals.reshape(rows.shape[:-1])
    idxs = idxs.reshape(rows.shape[:-1]).to(torch.int32)
    if keepdim:
        vals, idxs = vals.unsqueeze(ax), idxs.unsqueeze(ax)
    return canon(vals), idxs


def index_fill(x, index, axis, value, name=None):
    a, idx = cast_inputs("index_fill", *tensors(x, index))
    return canon(torch.index_fill(a, axis, idx.reshape(-1).long(),
                                  torch.tensor(value, dtype=a.dtype,
                                               device=a.device)))


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)
