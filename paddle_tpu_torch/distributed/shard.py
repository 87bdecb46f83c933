"""Sharding specs: a full tensor to this rank's shard and back.

Counterpart of ``paddle_tpu/distributed/shard.py``. There a spec places
one global array over the mesh and GSPMD splits it; here a spec says
which part of the global tensor this rank holds: dim ``i`` named by an
axis (or a tuple of axes) is cut into that group's count of equal
chunks and the rank keeps the chunk at its place in the group. A dim
that the axes do not divide stays whole, as the reference drops such an
axis.

A parameter records its layout (``_dist_layout``, a :class:`Layout`):
its global shape and its *cuts*, at most one a dim, as the reference
never puts two axes on one dim. A cut is an axis, a dim and the dim's
*segments*. A fused weight (the Llama's ``qkv_proj``, ``gate_up_proj``)
is cut segment by segment: the rank holds its chunk of each part of the
dim, side by side, not the contiguous chunk of the whole, and a segment
may be replicated (K and V when the mp degree does not divide their
heads). A segment may be cut in whole *units* (a head of ``d``
columns), as ``torch.tensor_split`` splits them: the first ``units %
n`` ranks hold one unit more, and a rank may hold none. A segment cut
by the element must split evenly (the reference raises on such a dim
as well). ZeRO adds an even cut of another dim (``add_cut``), so a weight
at mp 2 x sharding 2 holds its sharding chunk of its mp piece.
:func:`local_piece`, :func:`gather_global`, :func:`regions` and
:func:`global_sq_norms` read every cut; ``is_distributed`` is set on
such a parameter, as Paddle sets it on its tensor-parallel weights. A
layer whose axis has degree 1 cuts nothing but records the dims it
names (``annotate``), where ZeRO does not cut.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _comm
from . import env as env_mod

__all__ = ["PartitionSpec", "shard_tensor", "sharding_constraint",
           "replicate", "get_sharding", "shard_parameter", "local_piece",
           "gather_global", "global_sq_norms", "set_layout",
           "grad_layout", "mark_local", "place", "Cut", "Layout",
           "cut_layout", "add_cut", "layout_spec", "regions", "annotate",
           "unit_sizes"]


class PartitionSpec(tuple):
    """Mesh-axis names (or None, or a tuple of names) per dim."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


class Cut(NamedTuple):
    axis: str         # the mesh axis
    dim: int          # the dim it cuts
    segments: tuple   # ((global size, cut?[, unit]), ...) along dim


def unit_sizes(size, unit, n):
    """The sizes of the ``n`` pieces of ``size`` cut in whole units of
    ``unit``, as ``torch.tensor_split`` cuts ``size / unit`` units: the
    first ``(size / unit) % n`` pieces one unit more."""
    k, extra = divmod(size // unit, n)
    return [(k + (r < extra)) * unit for r in range(n)]


def _span(seg, n, rank):
    """``(start, length)`` of rank ``rank``'s piece of segment ``seg``
    (``(size, cut?[, unit])``) within it. A segment cut by the element
    must split evenly (raises ``ValueError``), as the reference raises
    on a parameter dim its mesh axis does not divide."""
    size, sharded = seg[0], seg[1]
    if not sharded:
        return 0, size
    unit = seg[2] if len(seg) > 2 else 1
    if unit == 1 and size % n:
        raise ValueError(f"a segment of size {size} does not split evenly "
                         f"over {n} ranks (the reference raises too)")
    sizes = unit_sizes(size, unit, n)
    return sum(sizes[:rank]), sizes[rank]


class Layout(NamedTuple):
    """How a rank's tensor lies in the global one: its cuts, at most one
    a dim (the tensor-parallel or expert cut first, then ZeRO's), and
    the global shape."""
    cuts: tuple       # Cut, ...
    shape: tuple      # the global shape

    @property
    def axes(self):
        """The mesh axes of the cuts (a cut over a tuple of axes names
        each)."""
        return tuple(a for c in self.cuts for a in _names(c.axis))


def cut_layout(axis, dim, shape, segments=None):
    """A layout of one cut: ``dim`` of ``shape`` over ``axis``, by its
    ``segments`` (one cut segment by default)."""
    shape = tuple(shape)
    dim %= len(shape)
    segs = tuple(segments) if segments else ((shape[dim], True),)
    return Layout((Cut(axis, dim, segs),), shape)


def add_cut(layout, axis, dim, shape=None):
    """``layout`` (None: whole, of ``shape``) with an even cut of ``dim``
    over ``axis`` added."""
    shape = tuple(layout.shape if layout is not None else shape)
    cuts = layout.cuts if layout is not None else ()
    if any(c.dim == dim for c in cuts):
        raise ValueError(f"dim {dim} is cut already: {layout}")
    return Layout(cuts + (Cut(axis, dim, ((shape[dim], True),)),), shape)


def layout_spec(layout):
    """The ``PartitionSpec`` of a layout (an axis on each cut dim)."""
    parts = [None] * len(layout.shape)
    for c in layout.cuts:
        parts[c.dim] = c.axis
    return PartitionSpec(*parts)


def _pair(axes):
    return env_mod.ensure_env().group(axes)


def _names(part):
    if part is None:
        return ()
    return tuple(part) if isinstance(part, (tuple, list)) else (part,)


def get_sharding(t):
    """The spec ``t`` was cut by (a parameter's from its layout), or
    None."""
    lay = getattr(t, "_dist_layout", None)
    if lay is not None:
        return layout_spec(lay)
    return getattr(t, "_sharding_spec", None)


def shard_tensor(x, mesh=None, placements=None, *, spec=None,
                 stop_gradient=None):
    """This rank's shard of the full tensor ``x`` by ``spec`` (or
    ``placements``, the same strings); differentiable (the gradient of
    the rest is 0). The result records its spec."""
    parts = tuple(spec if spec is not None else (placements or ()))
    env = env_mod.ensure_env()
    out, kept = x, []
    for i, p in enumerate(parts):
        names = _names(p)
        n = 1
        for nm in names:
            n *= env.degree(nm)
        if not names or i >= x.dim() or x.shape[i] % n:
            kept.append(None)
            continue
        kept.append(p)
        if n > 1:
            out = _comm.chunk_of(out, i, _pair(names))
    out = out.contiguous() if out is not x else out.view_as(x)
    if stop_gradient:
        out = out.detach()
    out._sharding_spec = PartitionSpec(*kept)
    return out


def sharding_constraint(x, *spec):
    """Reshard ``x`` from its recorded spec (replicated if none) to
    ``spec``: a dim that leaves an axis is all-gathered over it, a dim
    that gains one keeps this rank's chunk. Differentiable: the
    gradient of a gather is this rank's chunk, of a chunk the
    all-gather."""
    src = tuple(get_sharding(x) or ())
    out = x
    for i in range(x.dim()):
        s = _names(src[i]) if i < len(src) else ()
        t = _names(spec[i]) if i < len(spec) else ()
        if s == t:
            continue
        if s:
            out = _comm.gather_from(out, i, _pair(s))
        if t:
            out = _comm.scatter_to(out, i, _pair(t))
    if out is x:
        out = x.view_as(x)
    out._sharding_spec = PartitionSpec(*spec)
    return out


def mark_local(x, *spec):
    """Record that ``x`` already is this rank's shard by ``spec`` (a
    model's activations: each rank computes its own part), moving no
    data; returns a view that carries the spec. The reference marks the
    same tensors with ``sharding_constraint`` (its arrays are global);
    here a consumer that must know where this rank's part lies in the
    global tensor reads it (:func:`place`)."""
    out = x.view_as(x)
    out._sharding_spec = PartitionSpec(*spec)
    return out


def place(part):
    """``(count, index)`` of this rank among the chunks that the axis (or
    tuple of axes) ``part`` cuts a dim into: ``(1, 0)`` for None, at
    degree 1 or without a parallel environment."""
    names = _names(part)
    env = env_mod.get_env()
    if env is None or not names:
        return 1, 0
    n = 1
    for nm in names:
        n *= env.degree(nm)
    if n == 1:
        return 1, 0
    return n, env.members(names).index(env.rank)


def replicate(x):
    """``x`` whole on every rank."""
    return sharding_constraint(x)


def _n_rank(axis):
    ranks, _ = _pair(axis)
    return len(ranks), ranks.index(env_mod.ensure_env().rank)


def _local_sizes(cut, n, rank):
    return [_span(seg, n, rank)[1] for seg in cut.segments]


def local_piece(full, layout: Layout, places=None):
    """This rank's part of the global tensor ``full``: along each cut's
    dim, each segment's chunk (or the whole replicated segment), side by
    side. ``places``: ``(count, index)`` on each cut's group (by default
    the mesh axes')."""
    out = full
    for i, cut in enumerate(layout.cuts):
        n, rank = places[i] if places is not None else _n_rank(cut.axis)
        pieces, off = [], 0
        for seg in cut.segments:
            start, length = _span(seg, n, rank)
            pieces.append(out.narrow(cut.dim, off + start, length))
            off += seg[0]
        out = pieces[0] if len(pieces) == 1 else torch.cat(pieces, cut.dim)
    return out


def regions(local, layout: Layout):
    """The parts of this rank's tensor ``local``: ``[(bounds, part,
    axes)]``, one for each segment of every cut dim, ``bounds`` the
    part's ``[start, stop)`` in the global tensor on each dim and
    ``axes`` the axes that cut it (a segment a cut replicates is not cut
    by that axis)."""
    out = [([[0, d] for d in layout.shape], local, ())]
    for cut in layout.cuts:
        n, rank = _n_rank(cut.axis)
        split = []
        for bounds, t, axes in out:
            off = 0
            for seg, part in zip(
                    cut.segments, torch.split(t, _local_sizes(cut, n, rank),
                                              dim=cut.dim)):
                b = [list(x) for x in bounds]
                start, length = _span(seg, n, rank)
                b[cut.dim] = [off + start, off + start + length]
                split.append((b, part,
                              axes + (_names(cut.axis) if seg[1] else ())))
                off += seg[0]
        out = split
    return out


def _gather_cut(local, cut):
    pair = _pair(cut.axis)
    n = len(pair[0])
    if n == 1:
        return local
    sizes = [_local_sizes(cut, n, r) for r in range(n)]
    split = [torch.split(p, sz, dim=cut.dim) for p, sz in zip(
        _comm.all_gather_uneven(local.contiguous(), cut.dim,
                                [sum(sz) for sz in sizes], pair), sizes)]
    out = []
    for j, seg in enumerate(cut.segments):
        out.append(torch.cat([s[j] for s in split], cut.dim)
                   if seg[1] else split[0][j])
    return torch.cat(out, cut.dim)


def gather_global(local, layout: Layout):
    """The global tensor from every member's local part (collective over
    each cut's axis, the last cut first)."""
    for cut in reversed(layout.cuts):
        local = _gather_cut(local, cut)
    return local


def annotate(param, *dims):
    """Record the dims ``param``'s layer names a mesh axis on, whatever
    the axis's degree (``_axis_dims``): ZeRO cuts another dim, as the
    reference adds its axis to the first dim its spec leaves free."""
    param._axis_dims = frozenset(getattr(param, "_axis_dims", ())) \
        | {d % param.dim() for d in dims}
    return param


def set_layout(param, layout: Layout):
    """Record ``param``'s layout and mark it ``is_distributed`` (when a
    segment is cut)."""
    param._dist_layout = layout
    annotate(param, *(c.dim for c in layout.cuts))
    param.is_distributed = any(seg[1] for c in layout.cuts
                               for seg in c.segments)
    return param


def shard_parameter(param, *spec):
    """Cut a full parameter down to this rank's shard by ``spec`` (one
    sharded dim), in place, and record its layout."""
    dims = [i for i, p in enumerate(spec) if p is not None]
    if len(dims) > 1:
        raise ValueError(f"shard_parameter takes one sharded dim, got "
                         f"spec {spec}")
    if not dims:
        return param
    set_layout(param, cut_layout(spec[dims[0]], dims[0], param.shape))
    with torch.no_grad():
        param.data = local_piece(param.data, param._dist_layout) \
            .contiguous()
    return param


def grad_layout(param):
    """The layout of ``param``'s gradient, states and master as the
    optimizer holds them: ZeRO's slice (``_zero_layout``), else the
    parameter's own (``_dist_layout``), else None (whole)."""
    lay = getattr(param, "_zero_layout", None)
    return lay if lay is not None else getattr(param, "_dist_layout", None)


def global_sq_norms(layouts, tensors):
    """The squared L2 norm of each global tensor, in fp32, from the
    local ``tensors`` and their ``layouts`` (None: replicated, counted
    once): each part's squares summed over exactly the axes that cut it
    (:func:`regions`), in one all-reduce per set of axes; a part no
    axis cuts is counted once."""
    sq, cut = [], {}
    for lay, t in zip(layouts, tensors):
        t32 = t.to(torch.float32)
        if lay is None:
            sq.append(torch.sum(torch.square(t32)))
            continue
        sq.append(t32.new_zeros(()))
        i = len(sq) - 1
        for _, part, axes in regions(t32, lay):
            s = torch.sum(torch.square(part))
            if axes:
                cut.setdefault(env_mod._canon(axes), []).append((i, s))
            else:
                sq[i] = sq[i] + s
    for axes, items in cut.items():
        red = _comm.all_reduce(torch.stack([s for _, s in items]),
                               _pair(axes))
        for (i, _), v in zip(items, red.unbind()):
            sq[i] = sq[i] + v
    return sq
