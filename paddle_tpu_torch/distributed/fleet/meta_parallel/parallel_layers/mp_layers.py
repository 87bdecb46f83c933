"""Megatron-style tensor-parallel layers.

Counterpart of ``paddle_tpu/distributed/fleet/meta_parallel/
parallel_layers/mp_layers.py``. There each weight is one global array
sharded over ``mp`` and GSPMD derives the collectives from sharding
constraints. Here each rank holds its shard (``shard.Layout`` records
how it is cut) and the layers call the conjugate collectives of
``distributed._comm`` themselves:

- :class:`VocabParallelEmbedding`: this rank's vocab rows; ids outside
  them look up zeros, and the partial rows are all-reduced over ``mp``;
- :class:`ColumnParallelLinear`: weight ``[in, out/mp]``; the input
  enters through an identity whose backward all-reduces its gradient,
  and ``gather_output`` all-gathers the output's last dim. A fused
  projection (``out_segments``) is cut segment by segment, and a
  replicated segment's gradient is summed over ``mp``; a segment may be
  cut in whole units (heads of ``d`` columns, ``(size, True, d)``), the
  first ranks holding one head more when mp does not divide the heads;
- :class:`RowParallelLinear`: weight ``[in/mp, out]`` (``in_unit``: its
  rows cut in whole units, as the heads of the column-parallel product
  before it); the partial product is all-reduced, the bias added
  after;
- :class:`ParallelCrossEntropy` on vocab-sharded logits, Megatron's
  way: the max, the sum of exponentials and the picked logit each
  all-reduced over ``mp``, in fp32;
- :func:`masked_token_mean`: the sum over the non-ignored tokens
  divided by their count over the global batch (all-reduced over
  ``dp``); the value returned is that mean all-reduced over ``dp``,
  the gradient each rank's own part (``DataParallel`` sums them).

The group is the hybrid group's ``mp`` axis (``mp_group`` overrides
it). At degree 1 no collective runs and each layer is the single-card
math, op for op. Weights are drawn on their global shape from
``generator`` (torch's default generator when None) and cut, so ranks
seeded alike hold the pieces of one global weight; ``generator=False``
leaves them unset, for a model that fills its weights itself.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from .... import _comm
from .... import shard
from .....framework.device import resolve_device
from .....nn import functional as F
from ...base.topology import get_hcg

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "masked_token_mean"]


def _axis_group(axis, group=None):
    """(degree, this rank's place, (ranks, process group)) on ``axis``
    of the hybrid group, or of ``group``; (1, 0, None) without one."""
    if group is None:
        hcg = get_hcg()
        if hcg is None:
            return 1, 0, None
        group = {"mp": hcg.get_model_parallel_group,
                 "dp": hcg.get_data_parallel_group,
                 "sep": hcg.get_sep_parallel_group}[axis]()
    pair = group._pair()
    if len(pair[0]) == 1:
        return 1, 0, None
    return len(pair[0]), pair[0].index(dist.get_rank()), pair


def check_even(n, dims):
    """Raise ``ValueError`` naming the first of ``dims`` (``(name,
    size)`` pairs: a model's vocab, FFN widths, flat attention widths)
    that mp = ``n`` does not split evenly, as the reference raises on
    a parameter dim that mp does not divide."""
    for what, size in dims:
        _even(size, n, what)


def rank_heads(heads, n, rank):
    """``(count, first)`` of the heads rank ``rank`` of ``n`` holds: whole
    heads as ``torch.tensor_split`` cuts them, the first ``heads % n``
    ranks one more (a rank may hold none), as a segment cut in units of
    a head splits."""
    sizes = shard.unit_sizes(heads, 1, n)
    return sizes[rank], sum(sizes[:rank])


def _even(size, n, what):
    if size % n:
        raise ValueError(
            f"{what} = {size} does not split evenly over mp = {n} (the "
            f"reference raises too: a parameter dim must divide over mp)")


def _param(shape, init, dtype, device, generator, layout, n, rank):
    """A parameter drawn on its global ``shape`` by ``init`` and cut to
    this rank's piece of ``layout`` at ``n > 1`` (at ``n`` 1 kept whole,
    the dims the layout names recorded; None: whole, no dim named)."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    if generator is not False:
        init(w, generator)
    if layout is not None and n > 1:
        w = shard.local_piece(w, layout, [(n, rank)])
    p = nn.Parameter(w.to(dtype).contiguous())
    if layout is not None and n > 1:
        shard.set_layout(p, layout)
    elif layout is not None:
        shard.annotate(p, *(c.dim for c in layout.cuts))
    return p


def _normal(std):
    return lambda w, g: w.normal_(0.0, std, generator=g)


def _xavier(w, g):
    fan_in, fan_out = w.shape[0], w.shape[1]
    w.normal_(0.0, (2.0 / (fan_in + fan_out)) ** 0.5, generator=g)


def _zeros(w, g):
    w.zero_()


class VocabParallelEmbedding(nn.Module):
    """Embedding ``[vocab, dim]`` with the vocab rows sharded over
    ``mp``."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, *, dtype=torch.float32,
                 device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        self._n, self._rank, self._group = _axis_group("mp", mp_group)
        _even(num_embeddings, self._n, "num_embeddings (the vocab)")
        self._per = num_embeddings // self._n
        layout = shard.cut_layout("mp", 0, (num_embeddings, embedding_dim))
        self.weight = _param((num_embeddings, embedding_dim), _normal(1.0),
                             dtype, dev, generator, layout, self._n,
                             self._rank)

    def forward(self, x):
        ids = x.long()
        if self._n == 1:
            return torch.nn.functional.embedding(ids, self.weight)
        start = self._rank * self._per
        outside = (ids < start) | (ids >= start + self._per)
        local = torch.where(outside, torch.zeros_like(ids), ids - start)
        out = torch.nn.functional.embedding(local, self.weight)
        out = out.masked_fill(outside[..., None], 0.0)
        return _comm.reduce_from(out, self._group)


def _segments(out_features, out_segments):
    return tuple(out_segments) if out_segments else ((out_features, True),)


def _replicated_cols(segs, n, rank):
    """The local column range of the replicated segments (they must be
    adjacent), or None."""
    start, cols = 0, []
    for seg in segs:
        local = shard._span(seg, n, rank)[1]
        if not seg[1]:
            cols.append((start, start + local))
        start += local
    if not cols:
        return None
    if any(a[1] != b[0] for a, b in zip(cols, cols[1:])):
        raise ValueError("replicated segments of a column-parallel weight "
                         "must be adjacent")
    return cols[0][0], cols[-1][1]


class ColumnParallelLinear(nn.Module):
    """``x @ W + b`` with ``W [in, out]`` sharded on ``out``.
    ``out_segments`` (``((size, sharded), ...)`` over ``out``) cuts a
    fused projection segment by segment; ``gather_output=False`` leaves
    the output sharded on its last dim for a following
    :class:`RowParallelLinear`."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, out_segments=None,
                 dtype=torch.float32, device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        self._in_features, self._out_features = in_features, out_features
        self.gather_output = gather_output
        self._n, self._rank, self._group = _axis_group("mp", mp_group)
        self.is_mp = self._n > 1
        segs = _segments(out_features, out_segments)
        if sum(seg[0] for seg in segs) != out_features:
            raise ValueError(f"out_segments {segs} do not add up to "
                             f"out_features {out_features}")
        _even(out_features, self._n, "a column-parallel output dim")
        for seg in segs:
            if seg[1] and len(seg) < 3:
                _even(seg[0], self._n, "a column-parallel output segment")
        self._rep = _replicated_cols(segs, self._n, self._rank) \
            if self.is_mp else None
        wl = shard.cut_layout("mp", 1, (in_features, out_features), segs)
        self.weight = _param((in_features, out_features), _xavier, dtype,
                             dev, generator, wl, self._n, self._rank)
        has_bias = True if has_bias is None else has_bias
        bl = shard.cut_layout("mp", 0, (out_features,), segs)
        self.bias = _param((out_features,), _zeros, dtype, dev, generator,
                           bl, self._n, self._rank) if has_bias else None

    def _enter(self, x):
        return _comm.copy_to(x, self._group)

    def forward(self, x):
        w, b = self.weight, self.bias
        if self._rep is not None:
            w = _comm.reduce_grad_cols(w, self._rep, self._group)
            if b is not None:
                b = _comm.reduce_grad_cols(b, self._rep, self._group)
        out = F.linear(self._enter(x), w, b)
        if self.gather_output:
            out = _comm.gather_from(out, out.dim() - 1, self._group)
        return out


class RowParallelLinear(nn.Module):
    """``x @ W + b`` with ``W [in, out]`` sharded on ``in``; with
    ``input_is_parallel`` the input arrives sharded on its last dim (a
    :class:`ColumnParallelLinear`'s output), else this rank's chunk of
    it is taken. The partial products are summed over ``mp``, then the
    (replicated) bias is added. ``in_unit`` cuts ``in`` in whole units
    (a head's ``d`` rows, the first ranks one more where mp does not
    divide the heads; ``input_is_parallel`` then)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None, *,
                 in_unit=1, dtype=torch.float32, device="cuda",
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        self._in_features, self._out_features = in_features, out_features
        self.input_is_parallel = input_is_parallel
        self._n, self._rank, self._group = _axis_group("mp", mp_group)
        self.is_mp = self._n > 1
        _even(in_features, self._n, "a row-parallel input dim")
        wl = shard.cut_layout("mp", 0, (in_features, out_features),
                              ((in_features, True, in_unit),))
        self.weight = _param((in_features, out_features), _xavier, dtype,
                             dev, generator, wl, self._n, self._rank)
        self.bias = _param((out_features,), _zeros, dtype, dev, generator,
                           None, 1, 0) if has_bias else None

    def _exit(self, out):
        return _comm.reduce_from(out, self._group)

    def _bias(self):
        return self.bias

    def forward(self, x):
        if not self.input_is_parallel:
            x = _comm.scatter_to(x, x.dim() - 1, self._group)
        out = self._exit(F.linear(x, self.weight))
        return out if self.bias is None else out + self._bias()


class _VocabParallelCE(torch.autograd.Function):
    """Per-token CE on logits sharded over the vocab: ``[.., V/mp]`` in,
    ``[.., 1]`` out (0 where ignored), the softmax kept for the
    backward."""

    @staticmethod
    def forward(ctx, logits, label, ignore, group):
        lg = logits.to(torch.float32)
        per = lg.shape[-1]
        start = group[0].index(dist.get_rank()) * per
        mx = torch.amax(lg, dim=-1, keepdim=True)
        _comm.all_reduce(mx, group, dist.ReduceOp.MAX)
        ex = torch.exp(lg - mx)
        se = torch.sum(ex, dim=-1, keepdim=True)
        _comm.all_reduce(se, group)
        safe = torch.where(label < 0, torch.zeros_like(label), label)
        local = safe - start
        inside = (local >= 0) & (local < per)
        idx = torch.where(inside, local, torch.zeros_like(local))[..., None]
        picked = torch.gather(lg - mx, -1, idx) * inside[..., None]
        _comm.all_reduce(picked, group)
        keep = (label != ignore)[..., None]
        loss = torch.where(keep, torch.log(se) - picked,
                           torch.zeros((), device=lg.device))
        ctx.save_for_backward(ex / se, idx, inside[..., None], keep)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        soft, idx, inside, keep = ctx.saved_tensors
        grad = soft.scatter_add(-1, idx, -inside.to(soft.dtype))
        grad = grad * (g * keep)
        return grad.to(ctx.dtype), None, None, None


class ParallelCrossEntropy(nn.Module):
    """Per-token softmax cross-entropy ``[..., 1]`` of (vocab-sharded
    over ``mp``) logits: the fp32 log-sum-exp minus the picked fp32
    logit, 0 where the label is ``ignore_index``."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index
        self._n, _, self._group = _axis_group("mp", mp_group)

    def forward(self, input, label):  # noqa: A002
        lg = input.to(torch.float32)
        lb = label if label.dim() == lg.dim() - 1 else label.squeeze(-1)
        if self._n > 1:
            return _VocabParallelCE.apply(input, lb.long(),
                                          self.ignore_index, self._group)
        mx = torch.amax(lg, dim=-1, keepdim=True)
        lse = torch.log(torch.sum(torch.exp(lg - mx), dim=-1,
                                  keepdim=True)) + mx
        safe = torch.where(lb < 0, torch.zeros_like(lb), lb).long()
        picked = torch.gather(lg, -1, safe[..., None])
        loss = (lse - picked)[..., 0]
        loss = torch.where(lb == self.ignore_index,
                           torch.zeros((), device=lg.device), loss)
        return loss[..., None]


def masked_token_mean(loss, labels, ignore_index=-100, count=None,
                      group=None):
    """Mean of a per-token loss over the tokens whose label is not
    ``ignore_index``: the sum in fp32 over the count of valid labels of
    the global batch (at least 1), never over the total token count.
    Under ``dp`` (see the module note) the count is all-reduced and the
    returned value is the global mean on every rank. ``group``: the
    ``(ranks, process group)`` the batch is split over instead of dp's
    (dp and sep for a context-parallel model); ``count``: the global
    count itself, when the caller has it (a pipeline's microbatches
    share their whole batch's)."""
    if group is None:
        _, _, group = _axis_group("dp")
    if count is None:
        cnt = (labels != ignore_index).sum()
        if group is not None and len(group[0]) > 1:
            cnt = _comm.all_reduce(cnt.clone(), group)
    else:
        cnt = torch.as_tensor(count, device=loss.device)
    cnt = torch.clamp(cnt, min=1).to(torch.float32)
    mean = torch.sum(loss.to(torch.float32)) / cnt
    return _comm.reduce_from(mean, group).to(loss.dtype)
