"""Collectives over one process group, raw and as autograd pairs.

The reference writes none of these: a sharding constraint in a traced
program lets GSPMD derive each collective and its transpose. With one
process per rank the model code calls them itself. A ``group`` here is
``(member ranks, process group)`` as ``env.ParallelEnv.group`` gives it;
with one member every function returns its input as it is (no autograd
node), so a degree-1 model runs exactly the ops of a single-card one.

The autograd pairs (Megatron's conjugates):

- :func:`copy_to`: identity forward, all-reduce (sum) backward;
- :func:`reduce_from`: all-reduce forward, identity backward;
- :func:`scatter_to`: this rank's chunk of ``dim`` forward, all-gather
  backward;
- :func:`gather_from`: all-gather forward, this rank's chunk backward;
- :func:`gather_reduce`: all-gather forward, reduce-scatter backward;
- :func:`reduce_scatter`: reduce-scatter forward, all-gather backward.

Gloo has no reduce-scatter for CUDA tensors on every version, so on a
gloo group it is an all-reduce and this rank's chunk of the sum.

Gloo carries a CUDA tensor through the host, which a CUDA graph cannot
capture: every collective of the package goes through :func:`run`,
which counts such calls, and :func:`host_staged` reads the count, so
``jit.TrainStep`` can tell a step that makes one and run it eagerly.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["run", "host_staged", "all_reduce", "all_gather",
           "all_gather_list", "all_gather_uneven", "reduce_scatter_raw",
           "chunk_of", "copy_to", "reduce_from", "scatter_to", "gather_from",
           "gather_reduce", "reduce_scatter", "reduce_grad_cols"]


_host_staged = [0]


def host_staged() -> int:
    """How many collectives so far ran a CUDA tensor over gloo."""
    return _host_staged[0]


def run(fn, t, group, *args, **kwargs):
    """``fn(*args, group=<the group's process group>, **kwargs)``, for a
    ``torch.distributed`` function ``fn``; counted by :func:`host_staged`
    when ``t``, the tensor it carries (None: none), is a CUDA tensor and
    the group runs gloo."""
    if t is not None and t.is_cuda and dist.get_backend(group[1]) == "gloo":
        _host_staged[0] += 1
    return fn(*args, group=group[1], **kwargs)


def _n(group):
    return len(group[0])


def _rank(group):
    return group[0].index(dist.get_rank())


def all_reduce(t, group, op=dist.ReduceOp.SUM):
    """Sum (or ``op``) ``t`` over the group in place; returns it."""
    run(dist.all_reduce, t, group, t, op=op)
    return t


def all_gather(t, dim, group):
    """Every member's ``t`` concatenated along ``dim`` in group order."""
    return torch.cat(all_gather_list(t, group), dim=dim)


def all_gather_list(t, group):
    """Every member's ``t``, in group order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in group[0]]
    run(dist.all_gather, t, group, parts, t)
    return parts


def all_gather_uneven(t, dim, sizes, group):
    """Every member's ``t``, in group order, member ``i``'s ``sizes[i]``
    long along ``dim`` (each padded to the longest for the collective,
    which takes equal pieces)."""
    pad = max(sizes) - t.shape[dim]
    if pad:
        shape = list(t.shape)
        shape[dim] = pad
        t = torch.cat([t, t.new_zeros(shape)], dim)
    return [p.narrow(dim, 0, k)
            for p, k in zip(all_gather_list(t, group), sizes)]


def chunk_of(t, dim, group):
    """This member's equal chunk of ``t`` along ``dim``."""
    n, rank = _n(group), _rank(group)
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of size {size} does not split "
                         f"evenly over {n} ranks")
    return t.narrow(dim, rank * (size // n), size // n)


def reduce_scatter_raw(t, dim, group):
    """This member's chunk along ``dim`` of the group's sum of ``t``."""
    n = _n(group)
    if dist.get_backend(group[1]) == "gloo":
        return chunk_of(all_reduce(t.clone(), group), dim, group).contiguous()
    parts = [p.contiguous() for p in t.chunk(n, dim)]
    out = torch.empty_like(parts[0])
    run(dist.reduce_scatter, t, group, out, parts)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return chunk_of(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return chunk_of(g, ctx.dim, ctx.group).contiguous(), None, None


class _GatherReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_raw(g.contiguous(), ctx.dim, ctx.group), \
            None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter_raw(x.contiguous(), dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


class _ReduceGradCols(torch.autograd.Function):
    """Identity forward; the backward sums ``cols`` of the last dim of
    the gradient over the group (the replicated columns of a weight
    whose other columns are sharded)."""

    @staticmethod
    def forward(ctx, w, cols, group):
        ctx.cols, ctx.group = cols, group
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        start, stop = ctx.cols
        part = g[..., start:stop].contiguous()
        g[..., start:stop] = all_reduce(part, ctx.group)
        return g, None, None


def _one(group):
    return group is None or _n(group) == 1


def copy_to(x, group):
    return x if _one(group) else _CopyTo.apply(x, group)


def reduce_from(x, group):
    return x if _one(group) else _ReduceFrom.apply(x, group)


def scatter_to(x, dim, group):
    return x if _one(group) else _ScatterTo.apply(x, dim, group)


def gather_from(x, dim, group):
    return x if _one(group) else _GatherFrom.apply(x, dim, group)


def gather_reduce(x, dim, group):
    return x if _one(group) else _GatherReduce.apply(x, dim, group)


def reduce_scatter(x, dim, group):
    return x if _one(group) else _ReduceScatter.apply(x, dim, group)


def reduce_grad_cols(w, cols, group):
    return w if _one(group) else _ReduceGradCols.apply(w, cols, group)
