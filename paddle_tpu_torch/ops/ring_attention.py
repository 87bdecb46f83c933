"""Ring attention: exact attention over a sequence split across ranks.

Counterpart of ``paddle_tpu/ops/ring_attention.py`` (its flash-backed
path, ``_ring_fwd_shard_flash`` and ``_ring_bwd_shard_flash``). Each
rank of a group of ``n`` holds the ``[b, s/n, h, d]`` chunk ``idx`` of
q, k and v, chunks in group order. The reference runs the ring inside
``shard_map`` with ``jax.lax.ppermute``; here each rank runs its own
loop, and K and V rotate one rank on each step as one batch of
point-to-point transfers (``collective.p2p``).

- **Forward.** Step ``t`` holds the key block ``src = (idx - t) mod
  n``. Kernel 1 (``flash_fwd``) runs on it: causal on the diagonal
  block (``src == idx``), with no mask where the block is earlier, and
  not at all where it is later (causal only). The steps' ``(O, lse)``
  pairs are combined in fp32 by ``logaddexp``, as the reference does.
- **Backward.** A second ring rotates ``k, v`` and the fp32 ``dk, dv``
  accumulators; on each step kernels 2 (``flash_bwd_dq``, given delta)
  and 3 (``flash_bwd_dkv``) run on the block with the *global* lse and
  ``delta = rowsum(dO * O)`` of the combined output, so the blocks'
  contributions sum to the exact gradient (FlashAttention-2's ds is
  linear over key blocks). After ``n`` rotations each rank's ``dk, dv``
  are home.

On CPU tensors the kernels' wrappers run their plain versions; on CUDA
tensors they launch the kernels or raise.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..distributed.collective import p2p
from .cuda.flash_attention import (
    NEG_INF, _delta, _upstream, flash_bwd_dkv, flash_bwd_dq, flash_fwd,
)

__all__ = ["ring_attention"]


def _rotate(tensors, pair):
    """Each tensor from this rank to the next in the group, and the
    previous rank's in its place (one batch of transfers)."""
    ranks = pair[0]
    n, idx = len(ranks), ranks.index(dist.get_rank())
    bufs = [torch.empty_like(t) for t in tensors]
    p2p([(t, (idx + 1) % n) for t in tensors],
        [(b, (idx - 1) % n) for b in bufs], pair)
    return bufs


def _rows(x, b, h, s):
    """``[b * h, s]`` -> ``[b, s, h, 1]``."""
    return x.reshape(b, h, s).permute(0, 2, 1)[..., None]


def _visible(src, idx, causal):
    """(whether step ``src`` runs a block, whether it is causal)."""
    return not (causal and src > idx), causal and src == idx


class _RingFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        group = group._pair()
        ranks = group[0]
        n, idx = len(ranks), ranks.index(dist.get_rank())
        b, s, h, _ = q.shape
        o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.full((b * h, s), NEG_INF, dtype=torch.float32,
                         device=q.device)
        kt, vt = k, v
        for t in range(n):
            run, diag = _visible((idx - t) % n, idx, causal)
            if run:
                o_t, lse_t = flash_fwd(q, kt, vt, causal=diag, scale=scale)
                new = torch.logaddexp(lse, lse_t)
                o = o * torch.exp(_rows(lse - new, b, h, s)) \
                    + o_t.to(torch.float32) * torch.exp(
                        _rows(lse_t - new, b, h, s))
                lse = new
            if t < n - 1:
                kt, vt = _rotate([kt, vt], group)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        ranks = group[0]
        n, idx = len(ranks), ranks.index(dist.get_rank())
        do = _upstream(g, q)
        delta = _delta(do, out)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        kt, vt = k, v
        for t in range(n):
            run, diag = _visible((idx - t) % n, idx, causal)
            if run:
                dq += flash_bwd_dq(q, kt, vt, do, lse, delta, causal=diag,
                                   scale=scale).to(torch.float32)
                dk_t, dv_t = flash_bwd_dkv(q, kt, vt, do, lse, delta,
                                           causal=diag, scale=scale)
                dk += dk_t.to(torch.float32)
                dv += dv_t.to(torch.float32)
            if t < n - 1:
                kt, vt, dk, dv = _rotate([kt, vt, dk, dv], group)
            else:
                dk, dv = _rotate([dk, dv], group)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def ring_attention(q, k, v, group, causal=True, scale=None):
    """Exact attention of this rank's ``[b, s/n, h, d]`` chunk of q over
    every rank's k and v (``[b, s/n, h_kv, d]``), the ranks of
    ``group`` (a ``collective.Group``) holding the chunks in order.
    Differentiable; returns ``[b, s/n, h, d]`` in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _RingFn.apply(q, k, v, group, causal, float(scale))
