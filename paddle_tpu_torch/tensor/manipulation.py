"""Shape, layout, gather and scatter ops (counterpart of
``paddle_tpu/tensor/manipulation.py``).

Index inputs may be int32, as the reference's are: they are cast to
int64 where torch's op needs it. ``masked_select``, ``unique`` and
``unique_consecutive`` give a shape that depends on the data: they read
it on the host, so a ``TrainStep`` graph cannot hold them (a step that
calls them fails its capture and runs eagerly, as the reference runs
them eagerly in numpy).
"""
from __future__ import annotations

import builtins

import torch

from ..amp.auto_cast import cast_inputs
from ._common import (
    as_tensor, canon, dtype_of, scalar, shape_list, tensors,
)


def _op(name, *xs):
    """``xs`` as tensors, cast by ``auto_cast`` under op ``name``."""
    return cast_inputs(name, *tensors(*xs))


def _inplace(x, out):
    """Write ``out`` into ``x``'s storage and return ``x``."""
    x.copy_(out)
    return x


def reshape(x, shape, name=None):
    (x,) = _op("reshape", x)
    return canon(x.reshape(shape_list(shape)))


def reshape_(x, shape, name=None):
    """``x`` takes ``shape`` in place (contiguous ``x``: a new view of its
    storage)."""
    out = reshape(x, shape)
    return x.as_strided_(out.shape, out.contiguous().stride())


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    (x,) = _op("flatten", x)
    if x.dim() == 0:
        return canon(x.reshape(1))
    return canon(torch.flatten(x, start_axis, stop_axis))


def transpose(x, perm, name=None):
    (x,) = _op("transpose", x)
    return canon(x.permute(*[int(p) for p in perm]))


def t(x, name=None):
    """The transpose of a matrix (every dim reversed above 2-D, as
    ``a.T``); a vector as it is."""
    (x,) = _op("t", x)
    return canon(x.permute(*reversed(range(x.dim()))) if x.dim() >= 2
                 else x)


def moveaxis(x, source, destination, name=None):
    (x,) = _op("moveaxis", x)
    return canon(torch.movedim(x, source, destination))


def _squeeze_dims(x, axis):
    if axis is None:
        return [d for d in range(x.dim()) if x.shape[d] == 1]
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return [a % x.dim() for a in axes if x.shape[a % x.dim()] == 1]


def squeeze(x, axis=None, name=None):
    """Drop the size-1 dims among ``axis`` (all of them by default);
    a named dim of another size stays."""
    (x,) = _op("squeeze", x)
    dims = _squeeze_dims(x, axis)
    return canon(x.squeeze(tuple(dims)) if dims else x)


def squeeze_(x, axis=None, name=None):
    dims = _squeeze_dims(x, axis)
    return x.squeeze_(tuple(dims)) if dims else x


def _unsqueeze_dims(x, axis):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    axes = [int(scalar(a)) for a in axes]
    return sorted(a if a >= 0 else a + x.dim() + 1 for a in axes)


def unsqueeze(x, axis, name=None):
    (x,) = _op("unsqueeze", x)
    for a in _unsqueeze_dims(x, axis):
        x = x.unsqueeze(a)
    return canon(x)


def unsqueeze_(x, axis, name=None):
    for a in _unsqueeze_dims(x, axis):
        x.unsqueeze_(a)
    return x


def concat(x, axis=0, name=None):
    return canon(torch.cat(_op("concat", *x), int(scalar(axis))))


def stack(x, axis=0, name=None):
    return canon(torch.stack(_op("stack", *x), axis))


def split(x, num_or_sections, axis=0, name=None):
    """Equal parts (``num_or_sections`` an int that divides the dim) or
    the given sizes, one of which may be -1."""
    (x,) = _op("split", x)
    ax = int(scalar(axis))
    dim = x.shape[ax]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections:
            raise ValueError(f"split: dim {ax} of size {dim} does not split "
                             f"into {num_or_sections} equal parts")
        secs = [dim // num_or_sections] * num_or_sections
    else:
        secs = [int(scalar(s)) for s in num_or_sections]
        if -1 in secs:
            known = builtins.sum(s for s in secs if s != -1)
            secs = [dim - known if s == -1 else s for s in secs]
    return canon(list(torch.split(x, secs, ax)))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unbind(x, axis=0, name=None):
    (x,) = _op("unbind", x)
    return canon(list(torch.unbind(x, axis)))


unstack = unbind


def tile(x, repeat_times, name=None):
    (x,) = _op("tile", x)
    return canon(torch.tile(x, tuple(shape_list(repeat_times))))


def expand(x, shape, name=None):
    """Broadcast to ``shape``; -1 keeps an existing dim and is refused
    for a new one."""
    (x,) = _op("expand", x)
    target = shape_list(shape)
    offset = len(target) - x.dim()
    for i, s in enumerate(target):
        if s == -1:
            if i < offset:
                raise ValueError(
                    f"expand: -1 at position {i} refers to a new dimension "
                    f"(input has {x.dim()} dims, target has {len(target)}); "
                    f"-1 is only valid for existing dims")
            target[i] = x.shape[i - offset]
    return canon(x.expand(target))


def expand_as(x, y, name=None):
    x, y = _op("expand_as", x, y)
    return canon(x.expand(y.shape))


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def broadcast_tensors(inputs, name=None):
    return canon(list(torch.broadcast_tensors(*_op("broadcast_tensors",
                                                  *inputs))))


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def cast(x, dtype):
    """``x`` in ``dtype`` (never cast by ``auto_cast``)."""
    (x,) = tensors(x)
    return x.to(dtype_of(dtype))


def gather(x, index, axis=0, name=None):
    """Rows ``index`` of ``x`` along ``axis`` (a 0-d index drops the
    dim, a multi-dim one is flattened)."""
    x, index = _op("gather", x, index)
    ax = int(scalar(axis))
    if index.dim() == 0:
        return canon(x.select(ax, int(index)))
    return canon(torch.index_select(x, ax, index.reshape(-1).long()))


def _nd(idx):
    return tuple(idx[..., i].long() for i in range(idx.shape[-1]))


def gather_nd(x, index, name=None):
    """``x`` at the coordinates in ``index``'s last dim (its first k
    dims)."""
    x, index = _op("gather_nd", x, index)
    return canon(x[_nd(index)] if index.shape[-1] > 0 else x)


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    arr, indices = _op("take_along_axis", arr, indices)
    return canon(torch.take_along_dim(arr, indices.long(), axis))


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):  # noqa: A002
    """``arr`` with ``values`` (broadcast to ``indices``' shape) put at
    ``indices`` along ``axis``: assigned, added or multiplied."""
    arr, indices, values = _op("put_along_axis", arr, indices, values)
    idx = indices.long()
    v = values.to(arr.dtype).expand(idx.shape)
    ax = axis % arr.dim()
    if reduce == "assign":
        return canon(arr.scatter(ax, idx, v))
    if reduce in ("add", "sum"):
        return canon(arr.scatter_add(ax, idx, v))
    if reduce in ("mul", "multiply"):
        return canon(arr.scatter_reduce(ax, idx, v, "prod"))
    raise ValueError(f"unsupported reduce: {reduce}")


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows ``index`` of ``x`` replaced by ``updates`` (``overwrite``), or
    zeroed and then summed over repeated indices."""
    x, index, updates = _op("scatter", x, index, updates)
    i = (index.reshape(-1).long(),)
    updates = updates.to(x.dtype)
    if overwrite:
        return canon(x.index_put(i, updates))
    zeroed = x.index_put(i, torch.zeros_like(updates))
    return canon(zeroed.index_put(i, updates, accumulate=True))


def scatter_(x, index, updates, overwrite=True, name=None):
    return _inplace(x, scatter(x, index, updates, overwrite))


def scatter_nd_add(x, index, updates, name=None):
    x, index, updates = _op("scatter_nd_add", x, index, updates)
    return canon(x.index_put(_nd(index), updates.to(x.dtype),
                             accumulate=True))


def scatter_nd(index, updates, shape, name=None):
    index, updates = _op("scatter_nd", index, updates)
    zeros = torch.zeros(shape_list(shape), dtype=updates.dtype,
                        device=updates.device)
    return canon(zeros.index_put(_nd(index), updates, accumulate=True))


def index_select(x, index, axis=0, name=None):
    x, index = _op("index_select", x, index)
    return canon(torch.index_select(x, axis, index.reshape(-1).long()))


def index_sample(x, index, name=None):
    x, index = _op("index_sample", x, index)
    return canon(torch.take_along_dim(x, index.long(), 1))


def index_add(x, index, axis, value, name=None):
    x, index, value = _op("index_add", x, index, value)
    return canon(torch.index_add(x, axis, index.reshape(-1).long(),
                                 value.to(x.dtype)))


def index_put(x, indices, value, accumulate=False, name=None):
    x, value = _op("index_put", x, value)
    idx = tuple(as_tensor(i, x.device).long() for i in indices)
    return canon(x.index_put(idx, value.to(x.dtype), accumulate=accumulate))


def flip(x, axis, name=None):
    (x,) = _op("flip", x)
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return canon(torch.flip(x, [int(a) for a in axes]))


def roll(x, shifts, axis=None, name=None):
    (x,) = _op("roll", x)
    return canon(torch.roll(x, shifts, axis))


def rot90(x, k=1, axes=(0, 1), name=None):
    (x,) = _op("rot90", x)
    return canon(torch.rot90(x, k, list(axes)))


def repeat_interleave(x, repeats, axis=None, name=None):
    (x,) = _op("repeat_interleave", x)
    if isinstance(repeats, torch.Tensor):
        repeats = repeats.to(x.device).long()
    return canon(torch.repeat_interleave(x, repeats, axis))


def masked_select(x, mask, name=None):
    """The entries of ``x`` where ``mask`` (broadcast to x) holds, as a
    1-D tensor. Its size depends on the data and is read on the host: a
    ``TrainStep`` graph cannot hold this op."""
    x, mask = tensors(x, mask)
    return canon(torch.masked_select(x, mask.bool().expand(x.shape)))


def masked_fill(x, mask, value, name=None):
    if isinstance(value, torch.Tensor):
        x, mask, value = _op("masked_fill", x, mask, value)
    else:
        x, mask = _op("masked_fill", x, mask)
        value = torch.full((), value, dtype=x.dtype, device=x.device)
    return canon(torch.where(mask.bool(), value.to(x.dtype), x))


def slice(x, axes, starts, ends, name=None):  # noqa: A001
    (x,) = _op("slice", x)
    idx = [builtins.slice(None)] * x.dim()
    for ax, st, en in zip(axes, starts, ends):
        idx[ax] = builtins.slice(int(scalar(st)), int(scalar(en)))
    return canon(x[tuple(idx)])


def strided_slice(x, axes, starts, ends, strides, name=None):
    """Python slicing per axis; a negative stride walks backwards, as in
    numpy (torch's slicing takes only positive strides, so those dims
    are gathered)."""
    (x,) = _op("strided_slice", x)
    for ax, st, en, sr in zip(axes, starts, ends, strides):
        st, en, sr = (int(scalar(v)) for v in (st, en, sr))
        if sr > 0:
            idx = [builtins.slice(None)] * x.dim()
            idx[ax] = builtins.slice(st, en, sr)
            x = x[tuple(idx)]
        else:
            keep = range(x.shape[ax])[builtins.slice(st, en, sr)]
            x = torch.index_select(x, ax, torch.tensor(
                list(keep), dtype=torch.int64, device=x.device))
    return canon(x)


def crop(x, shape=None, offsets=None, name=None):
    (x,) = _op("crop", x)
    s = shape_list(shape)
    offs = [0] * len(s) if offsets is None else [int(scalar(o))
                                                 for o in offsets]
    idx = tuple(builtins.slice(o, o + (d if d != -1 else x.shape[i] - o))
                for i, (o, d) in enumerate(zip(offs, s)))
    return canon(x[idx])


def _first_index(inverse, n_unique, length):
    """For each unique value, the first position (along its dim) that
    maps to it."""
    pos = torch.arange(length, device=inverse.device)
    first = torch.full((n_unique,), length, dtype=torch.int64,
                       device=inverse.device)
    return first.scatter_reduce(0, inverse.reshape(-1).long(), pos, "amin")


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """The sorted unique values (of the flattened ``x``, or slices along
    ``axis``), with the first index, the inverse and the counts as asked,
    int32 as the reference gives them. Its size depends on the data and
    is read on the host: a ``TrainStep`` graph cannot hold this op."""
    (x,) = tensors(x)
    src = x.reshape(-1) if axis is None else x
    vals, inv, counts = torch.unique(src, sorted=True, return_inverse=True,
                                     return_counts=True, dim=axis)
    out = [vals]
    if return_index:
        length = src.shape[0 if axis is None else axis]
        out.append(_first_index(inv, vals.shape[0 if axis is None
                                                 else axis], length))
    if return_inverse:
        out.append(inv.reshape(x.shape) if axis is None else inv)
    if return_counts:
        out.append(counts)
    out = [canon(o) if i == 0 else o.to(torch.int32)
           for i, o in enumerate(out)]
    return out[0] if len(out) == 1 else tuple(out)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    """Runs of equal values of the flattened ``x`` collapsed to one, with
    the inverse and the counts (int32). Its size depends on the data and
    is read on the host: a ``TrainStep`` graph cannot hold this op."""
    if axis is not None:
        raise NotImplementedError(
            "unique_consecutive with axis is not supported yet")
    (x,) = tensors(x)
    vals, inv, counts = torch.unique_consecutive(
        x.reshape(-1), return_inverse=True, return_counts=True)
    out = [canon(vals)]
    if return_inverse:
        out.append(inv.to(torch.int32))
    if return_counts:
        out.append(counts.to(torch.int32))
    return out[0] if len(out) == 1 else tuple(out)


def as_complex(x, name=None):
    (x,) = _op("as_complex", x)
    return canon(torch.complex(x[..., 0], x[..., 1]))


def as_real(x, name=None):
    (x,) = _op("as_real", x)
    return canon(torch.stack([x.real, x.imag], -1))


def view(x, shape_or_dtype, name=None):
    """A reshape (a list or tuple) or a bitcast to a dtype. A bitcast to
    a narrower dtype adds a trailing dim of the width ratio and one to a
    wider dtype drops it, as ``jax.lax.bitcast_convert_type`` does."""
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    (x,) = _op("view_dtype", x)
    d = dtype_of(shape_or_dtype)
    src, dst = x.element_size(), torch.empty((), dtype=d).element_size()
    if dst < src:
        return x.unsqueeze(-1).view(d)
    if dst > src:
        return x.view(d).squeeze(-1)
    return x.view(d)


def view_as(x, other, name=None):
    return reshape(x, other.shape)


def numel(x, name=None):
    """The element count as a 0-d int32 tensor."""
    (x,) = tensors(x)
    return torch.tensor(x.numel(), dtype=torch.int32, device=x.device)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):  # noqa: A002
    (idx,) = tensors(input)
    size = (index_num + nshards - 1) // nshards
    mine = torch.div(idx, size, rounding_mode="floor") == shard_id
    return canon(torch.where(mine, idx - shard_id * size,
                             torch.full_like(idx, ignore_value)))


def tensor_split(x, num_or_indices, axis=0, name=None):
    (x,) = _op("tensor_split", x)
    return canon(list(torch.tensor_split(x, num_or_indices, axis)))


def hsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=1)


def vsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=0)


def dsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=2)


def hstack(x, name=None):
    return canon(torch.hstack(_op("hstack", *x)))


def vstack(x, name=None):
    return canon(torch.vstack(_op("vstack", *x)))


def dstack(x, name=None):
    return canon(torch.dstack(_op("dstack", *x)))


def _atleast(name, fn, inputs):
    outs = [canon(fn(*_op(name, x))) for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_1d(*inputs, name=None):
    return _atleast("atleast_1d", torch.atleast_1d, inputs)


def atleast_2d(*inputs, name=None):
    return _atleast("atleast_2d", torch.atleast_2d, inputs)


def atleast_3d(*inputs, name=None):
    return _atleast("atleast_3d", torch.atleast_3d, inputs)


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):  # noqa: A002
    (x,) = _op("diag_embed", input)
    return canon(torch.diag_embed(x, offset, dim1, dim2))


def _diag_fill_coords(a, offset, wrap):
    rows, cols = a.shape
    if wrap and rows > cols:
        # numpy.fill_diagonal's wrap: the flat buffer at stride cols + 1
        start = offset if offset >= 0 else -offset * cols
        flats = torch.arange(start, rows * cols, cols + 1, device=a.device)
        return flats // cols, flats % cols
    ii = torch.arange(rows, device=a.device)
    jj = ii + offset
    ok = (jj >= 0) & (jj < cols)
    return ii[ok], jj[ok]


def fill_diagonal(x, value, offset=0, wrap=False, name=None):
    """``x`` with ``value`` on its ``offset`` diagonal (a tall matrix's
    repeated every ``cols + 1`` rows under ``wrap``); above 2-D, on the
    hyper-diagonal of equal dims, offset 0."""
    (x,) = _op("fill_diagonal", x)
    val = torch.full((), value, dtype=x.dtype, device=x.device)
    if x.dim() == 2:
        return canon(x.index_put(_diag_fill_coords(x, offset, wrap), val))
    if offset != 0 or wrap:
        raise ValueError(
            "fill_diagonal supports offset/wrap only for 2-D tensors")
    if len(set(x.shape)) != 1:
        raise ValueError(f"fill_diagonal on a {x.dim()}-D tensor requires "
                         f"all dims equal, got {tuple(x.shape)}")
    i = torch.arange(x.shape[0], device=x.device)
    return canon(x.index_put((i,) * x.dim(), val))


def fill_diagonal_(x, value, offset=0, wrap=False, name=None):
    return _inplace(x, fill_diagonal(x, value, offset, wrap))


def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1, name=None):
    """``x`` with ``y`` on the ``offset`` diagonal of dims (dim1, dim2);
    ``y`` broadcasts to the diagonal's shape."""
    x, y = _op("fill_diagonal_tensor", x, y)
    nd = x.dim()
    d1, d2 = dim1 % nd, dim2 % nd
    off = offset
    if d1 > d2:
        d1, d2, off = d2, d1, -offset
    m = torch.movedim(x, (d1, d2), (nd - 2, nd - 1))
    n1, n2 = m.shape[-2], m.shape[-1]
    dlen = builtins.min(n1 + builtins.min(off, 0), n2 - builtins.max(off, 0))
    rows = torch.arange(dlen, device=x.device) + builtins.max(-off, 0)
    cols = torch.arange(dlen, device=x.device) + builtins.max(off, 0)
    bb = y.to(x.dtype).expand(m.shape[:-2] + (dlen,))
    m = m.clone()
    m[..., rows, cols] = bb
    return canon(torch.movedim(m, (nd - 2, nd - 1), (d1, d2)))


def fill_diagonal_tensor_(x, y, offset=0, dim1=0, dim2=1, name=None):
    return _inplace(x, fill_diagonal_tensor(x, y, offset, dim1, dim2))


def fill(x, value, name=None):
    (x,) = _op("fill", x)
    return canon(torch.full_like(x, value))


def fill_(x, value, name=None):
    with torch.no_grad():
        return x.fill_(value)


def take(x, index, mode="raise", name=None):
    """Entries of the flattened ``x`` at ``index``: 'wrap' wraps out of
    range indices, 'clip' and 'raise' clamp them after a negative index
    counts from the end (no error from the device, as in the
    reference's compiled program)."""
    if mode not in ("raise", "wrap", "clip"):
        raise ValueError(f"take mode must be raise|wrap|clip, got {mode!r}")
    x, index = _op("take", x, index)
    flat = x.reshape(-1)
    n = flat.shape[0]
    i = index.long()
    if mode == "wrap":
        i = torch.remainder(i, n)
    else:
        i = torch.clamp(torch.where(i < 0, i + n, i), 0, n - 1)
    return canon(torch.take(flat, i))


def unflatten(x, axis, shape, name=None):
    """Dim ``axis`` split into ``shape`` (one entry may be -1)."""
    (x,) = _op("unflatten", x)
    shape = shape_list(shape)
    if shape.count(-1) > 1:
        raise ValueError("unflatten shape can have at most one -1")
    return canon(torch.unflatten(x, axis % x.dim(), shape))


def reverse(x, axis, name=None):
    """``flip`` under its old name."""
    return flip(x, axis)
