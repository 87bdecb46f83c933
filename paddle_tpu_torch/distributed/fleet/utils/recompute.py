"""Activation recomputation (gradient checkpointing).

Counterpart of ``paddle_tpu/distributed/fleet/utils/recompute.py``: the
segment keeps only its inputs and runs its forward again in the
backward. The reference wraps the segment in ``jax.checkpoint``, and its
PRNG key is an operand, so the recomputed dropout draws the same masks.
Here the segment runs under ``torch.utils.checkpoint`` (non-reentrant),
and the port's dropout generators (``framework.random``) are saved
before the forward and put back for the recomputation, then restored,
so the recomputed dropout masks are the forward's.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ....framework import random as rng

__all__ = ["recompute", "recompute_sequential"]


def recompute(function, *args, **kwargs):
    """``function(*args, **kwargs)`` without keeping its intermediate
    activations; the backward recomputes them. ``preserve_rng_state``
    (default True) replays the forward's random numbers;
    ``use_reentrant`` is accepted (the non-reentrant form always
    runs)."""
    preserve = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    start = rng.get_state() if preserve else None
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1 or start is None:
            return function(*a, **kwargs)
        outer = rng.get_state()
        rng.replace_state(start)
        try:
            return function(*a, **kwargs)
        finally:
            rng.replace_state(outer)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=preserve)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Split ``functions`` (a ``Sequential`` or a list of layers) into
    ``ctx["segments"]`` chunks (default 1) and recompute each."""
    segments = int((ctx or {}).get("segments", 1) or 1)
    preserve = (ctx or {}).get("preserve_rng_state", True)
    layers = list(functions)
    size = max(1, (len(layers) + segments - 1) // segments)
    out = args
    for start in range(0, len(layers), size):
        seg = nn.Sequential(*layers[start:start + size])
        out = recompute(seg, *(out if isinstance(out, tuple) else (out,)),
                        preserve_rng_state=preserve, **kwargs)
        kwargs = {}
    return out
