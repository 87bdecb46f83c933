"""Symmetric int8 quantization: per-position KV, per-channel weights.

Counterpart of ``quantize_kv``/``dequantize_kv`` and
``quantize_weight_int8`` in ``paddle_tpu/quantization/__init__.py``.
``quantize_kv``/``dequantize_kv`` are the one helper pair the int8
KV path uses everywhere — the engine's quantize-on-write
(``serving/engine.py``), the reference round-trip of
``generate(kv_int8=True)``, and the inputs of the int8 paged kernel —
so the three cannot diverge. Bit-identical to the reference on the same
fp32 input: ``torch.round`` rounds half to even like ``jnp.round``, the
clip is +-127, and the scale is one fp32 division.
"""
from __future__ import annotations

import torch

__all__ = ["quantize_kv", "dequantize_kv", "quantize_weight_int8"]


def quantize_kv(x: torch.Tensor):
    """x ``[..., d]`` -> (q int8 ``[..., d]``, s fp32 ``[...]``): one
    amax scale per (position, kv_head)."""
    x32 = x.to(torch.float32)
    amax = x32.abs().amax(dim=-1)
    # a device-side divisor: on CUDA, division by a Python scalar is
    # taken as a multiply by its reciprocal, which rounds differently
    s = torch.clamp_min(amax / amax.new_full((), 127.0), 1e-12)
    q = torch.clamp(torch.round(x32 / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def dequantize_kv(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: fp32 multiply, then one cast to
    ``dtype``."""
    return (q.to(torch.float32) * s[..., None]).to(dtype)


def quantize_weight_int8(w: torch.Tensor, group=None) -> dict:
    """Per-output-channel symmetric int8 weight-only quantization, the
    weight pack of ``generate(int8_weights=True)`` and the engine's
    ``int8_weights``: w ``[..., in, out]`` -> ``{"q": int8 [..., in,
    out], "s": fp32 [..., 1, out]}`` with ``s = max(max|w| / 127,
    1e-12)`` over the input axis and ``q = clip(round(w / s), -127,
    127)``, half to even like ``jnp.round``.

    ``group`` (a ``distributed._comm`` group): ``w`` is this rank's
    shard of a weight whose input axis is split over the group (a
    row-parallel weight); the absmax is the maximum over the group, so
    each rank's pack is its slice of the whole weight's."""
    w32 = w.to(torch.float32)
    amax = w32.abs().amax(dim=-2, keepdim=True)
    if group is not None:
        import torch.distributed as dist

        from ..distributed import _comm

        _comm.all_reduce(amax, group, op=dist.ReduceOp.MAX)
    s = torch.clamp_min(amax / amax.new_full((), 127.0), 1e-12)
    q = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s}
