"""Sharding specs: a full tensor to this rank's shard and back.

Counterpart of ``paddle_tpu/distributed/shard.py``. There a spec places
one global array over the mesh and GSPMD splits it; here a spec says
which part of the global tensor this rank holds: dim ``i`` named by an
axis (or a tuple of axes) is cut into that group's count of equal
chunks and the rank keeps the chunk at its place in the group. A dim
that the axes do not divide stays whole, as the reference drops such an
axis.

A parameter records its layout (``_dist_layout``: the axis, the one
sharded dim, the global shape and the dim's *segments*). A fused weight
(the Llama's ``qkv_proj``, ``gate_up_proj``) is sharded segment by
segment: the rank holds its chunk of each part of the dim, side by
side, not the contiguous chunk of the whole, and a segment may be
replicated (K and V when the mp degree does not divide their heads).
:func:`local_piece`, :func:`gather_global` and :func:`global_sq_norms`
read it; ``is_distributed`` is set on such a parameter, as Paddle sets
it on its tensor-parallel weights.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _comm
from . import env as env_mod

__all__ = ["PartitionSpec", "shard_tensor", "sharding_constraint",
           "replicate", "get_sharding", "shard_parameter", "local_piece",
           "gather_global", "global_sq_norms", "set_layout",
           "grad_layout", "mark_local", "place"]


class PartitionSpec(tuple):
    """Mesh-axis names (or None, or a tuple of names) per dim."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


class Layout(NamedTuple):
    axis: str         # the mesh axis of the sharded dim
    dim: int          # the sharded dim
    segments: tuple   # ((global size, sharded?), ...) along dim
    shape: tuple      # the global shape


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
        parts = [None] * len(lay.shape)
        parts[lay.dim] = lay.axis
        return PartitionSpec(*parts)
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


def local_piece(full, layout: Layout, n=None, rank=None):
    """This rank's part of the global tensor ``full`` (each segment's
    chunk, or the whole replicated segment, side by side)."""
    if n is None:
        n, rank = _n_rank(layout.axis)
    pieces, off = [], 0
    for size, sharded in layout.segments:
        if sharded:
            if size % n:
                raise ValueError(
                    f"dim {layout.dim} segment of size {size} does not "
                    f"split evenly over mp = {n}")
            pieces.append(full.narrow(layout.dim, off + rank * (size // n),
                                      size // n))
        else:
            pieces.append(full.narrow(layout.dim, off, size))
        off += size
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, layout.dim)


def _split_local(t, layout: Layout, n):
    """The local tensor's segments (chunks and replicated parts)."""
    sizes = [size // n if sharded else size
             for size, sharded in layout.segments]
    return list(torch.split(t, sizes, dim=layout.dim))


def gather_global(local, layout: Layout):
    """The global tensor from every member's local part (collective over
    the layout's axis)."""
    pair = _pair(layout.axis)
    n = len(pair[0])
    if n == 1:
        return local
    parts = _comm.all_gather_list(local, pair)
    split = [_split_local(p, layout, n) for p in parts]
    out = []
    for j, (_, sharded) in enumerate(layout.segments):
        out.append(torch.cat([s[j] for s in split], layout.dim)
                   if sharded else split[0][j])
    return torch.cat(out, layout.dim)


def set_layout(param, axis, dim, segments=None, shape=None):
    """Record ``param``'s layout (its global ``shape``, the ``segments``
    of ``dim``, one sharded segment by default) and mark it
    ``is_distributed``."""
    shape = tuple(shape if shape is not None else param.shape)
    segs = tuple(segments) if segments else ((shape[dim], True),)
    param._dist_layout = Layout(axis, dim % len(shape), segs, shape)
    param.is_distributed = any(s for _, s in segs)
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
    set_layout(param, spec[dims[0]], dims[0])
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
    once): the sharded segments' squares summed over their axis in one
    all-reduce per axis, the replicated ones counted once."""
    sq, shard = [], {}
    for lay, t in zip(layouts, tensors):
        t32 = t.to(torch.float32)
        if lay is None:
            sq.append(torch.sum(torch.square(t32)))
            continue
        n, _ = _n_rank(lay.axis)
        rep = t32.new_zeros(())
        sh = t32.new_zeros(())
        for (_, sharded), part in zip(lay.segments,
                                      _split_local(t32, lay, n)):
            s = torch.sum(torch.square(part))
            if sharded:
                sh = sh + s
            else:
                rep = rep + s
        sq.append(rep)
        shard.setdefault(lay.axis, []).append((len(sq) - 1, sh))
    for axis, items in shard.items():
        red = _comm.all_reduce(torch.stack([s for _, s in items]),
                               _pair(axis))
        for (i, _), v in zip(items, red.unbind()):
            sq[i] = sq[i] + v
    return sq
