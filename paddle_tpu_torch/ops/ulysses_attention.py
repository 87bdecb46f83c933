"""Ulysses (DeepSpeed-style) sequence-parallel attention.

Counterpart of ``paddle_tpu/ops/ulysses_attention.py``. Each rank of a
group of ``n`` holds the ``[b, s/n, h, d]`` chunk of q, k and v; one
all-to-all (``collective.all_to_all``) turns the sequence chunk into a
head chunk ``[b, s, h/n, d]``, attention runs over the full sequence on
the local heads through the flash kernels (1-3, ``flash_attention``),
and a second all-to-all turns the output back. The all-to-alls are
linear, and each one's gradient is the other's.
"""
from __future__ import annotations

import torch

from ..distributed.collective import all_to_all
from .cuda.flash_attention import flash_attention

__all__ = ["ulysses_attention"]


class _AllToAll(torch.autograd.Function):
    """``x`` split along ``split`` over the group, the pieces received
    concatenated along ``concat``; the backward swaps the two."""

    @staticmethod
    def forward(ctx, x, group, split, concat):
        ctx.group, ctx.split, ctx.concat = group, split, concat
        return all_to_all(x, group=group, split_axis=split,
                          concat_axis=concat)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g.contiguous(), group=ctx.group,
                          split_axis=ctx.concat,
                          concat_axis=ctx.split), None, None, None


def ulysses_attention(q, k, v, group, causal=True, scale=None):
    """Exact attention of this rank's ``[b, s/n, h, d]`` chunk over the
    ranks of ``group`` (a ``collective.Group``) holding the chunks in
    order. q, k and v need equal head counts divisible by ``n``, as in
    the reference. Returns ``[b, s/n, h, d]``."""
    n = group.nranks
    if not (q.shape[2] == k.shape[2] == v.shape[2]):
        raise ValueError(
            "ulysses attention requires equal q/k/v head counts "
            f"(got {q.shape[2]}/{k.shape[2]}/{v.shape[2]}); GQA/MQA "
            "would shard kv heads below 1 per device — repeat KV "
            "heads first or use ring_flash_attention")
    if q.shape[2] % n:
        raise ValueError(
            f"ulysses attention needs heads % axis degree == 0, got "
            f"h={q.shape[2]} over {group.name}={n}")
    q2, k2, v2 = (_AllToAll.apply(t, group, 2, 1) for t in (q, k, v))
    out = flash_attention(q2, k2, v2, causal=causal, scale=scale)
    return _AllToAll.apply(out, group, 1, 2)
