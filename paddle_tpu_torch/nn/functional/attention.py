"""Attention (counterpart of ``paddle_tpu/nn/functional/attention.py``).

Both entries take the reference's ``[batch, seq, heads, head_dim]``
layout (k/v may have fewer heads: GQA) and run hand-written CUDA kernels
on a CUDA tensor, their plain versions on a CPU tensor. Routing:

- a call with a ``[b, 1, 1, sk]`` key-padding ``attn_mask``, or with
  dropout while training, goes to the head-batched entry
  (``ops/cuda/head_flash.py``, kernels 4-6), which takes the mask as one
  additive row per batch row and draws the dropout mask in the kernel
  from two seed words per call (``framework/random.py``), hashed at the
  query's global coordinates when a model marked it as a rank's part of
  the batch or heads (``_dropout_coords``). This mirrors
  ``flash_attention_kernel`` (``flash_attention.py:667-684``), which
  takes ``hb_flash`` wherever the ``flash_headbatch`` tune row engages
  it; the port has no tune table, and on the card both kernel families
  read ``[b, s, h, d]`` through strides, so the choice between them is
  the mask's layout alone, and the per-batch-row layout is what
  ``BertModel`` builds;
- every other call (no mask, no dropout: the Llama path) goes to the
  flash entry (``ops/cuda/flash_attention.py``, kernels 1-3).

``ring_flash_attention`` and ``ulysses_attention`` take each rank's
chunk of the sequence over the ``sep`` group (``ops/ring_attention.py``,
``ops/ulysses_attention.py``, both on kernels 1-3) and are
:func:`scaled_dot_product_attention` at degree 1.

A row-varying mask (``[.., sq, sk]``) has no TPU kernel; JAX sends it to
its composite (``flash_attention.py:633-641``). The port has no
composite: it raises ``NotImplementedError`` (ROADMAP queue A). There is
no crossover to a composite on the card either: the TPU path's autotune
table (``flash_attention.py:657-709``) measured the TPU, and on the card
the kernel always runs.
"""
from __future__ import annotations

import torch

from ...amp.auto_cast import cast_inputs
from ...framework import random
from ...ops.cuda.flash_attention import NEG_INF
# the kernel entry under another name: ``flash_attention`` here is the
# reference's functional of that name, which returns a tuple
from ...ops.cuda.flash_attention import flash_attention as flash_kernel
from ...ops.cuda.head_flash import hb_flash

__all__ = ["scaled_dot_product_attention", "flash_attention",
           "sliding_window_attention", "ring_flash_attention",
           "ulysses_attention"]


def _key_padding_additive(mask, q_shape, k_shape):
    """A ``[b, 1, 1, sk]`` key-padding mask as the additive fp32 ``[b, 1,
    sk]`` rows the kernels take (the reference's ``_key_padding_additive``,
    ``flash_attention.py:728``): bool means keep (0, else NEG_INF), a
    float mask is cast to fp32 and clamped at NEG_INF, so a fully masked
    row cannot give inf - inf. Any other shape or dtype raises
    ``NotImplementedError``."""
    b, sk = q_shape[0], k_shape[1]
    if tuple(mask.shape) != (b, 1, 1, sk):
        raise NotImplementedError(
            f"attn_mask of shape {tuple(mask.shape)}: the port runs only "
            f"[b, 1, 1, sk] = [{b}, 1, 1, {sk}] key-padding masks (the "
            f"encoder slice's kernels); row-varying masks are not ported "
            f"(ROADMAP queue A)")
    m = mask.reshape(b, 1, sk)
    if m.dtype == torch.bool:
        return torch.where(m, 0.0, NEG_INF).to(torch.float32)
    if not m.is_floating_point():
        raise NotImplementedError(
            f"attn_mask of dtype {m.dtype}: pass a bool (keep) or an "
            f"additive float mask")
    return torch.clamp(m.to(torch.float32), min=NEG_INF)


def _dropout_coords(query):
    """Where ``query`` (``[b, s, h, d]``) lies in the global batch and
    heads, as the kernels' ``coords`` (first batch row, first head,
    global heads), from the spec a model recorded on it
    (``shard.mark_local``: dim 0 over the batch axes, dim 2 over mp), or
    None when it is the whole tensor. The reference's dropout hashes the
    global query head (its arrays are global under GSPMD); so does a
    rank here, and every layout drops what one card drops."""
    from ...distributed import shard

    spec = shard.get_sharding(query)
    if spec is None:
        return None
    spec = tuple(spec) + (None,) * (4 - len(spec))
    b, _, h, _ = query.shape
    _, rb = shard.place(spec[0])
    nh, rh = shard.place(spec[2])
    if rb == 0 and nh == 1:
        return None
    return rb * b, rh * h, nh * h


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Softmax attention with scale ``1/sqrt(head_dim)``; ``is_causal``
    masks bottom-right aligned; ``attn_mask`` is a ``[b, 1, 1, sk]``
    key-padding mask (bool keep, or additive float); ``dropout_p`` drops
    attention probabilities while ``training`` (outside training it is
    0, as in the reference). A white op under ``auto_cast``."""
    query, key, value = cast_inputs("scaled_dot_product_attention", query,
                                    key, value)
    p = float(dropout_p) if training else 0.0
    kadd = None
    if attn_mask is not None:
        kadd = _key_padding_additive(attn_mask, query.shape, key.shape)
    if kadd is None and p == 0.0:
        return flash_kernel(query, key, value, causal=is_causal)
    seed = coords = None
    if p > 0.0:
        seed, coords = random.next_seed_words(), _dropout_coords(query)
    return hb_flash(query, key, value, seed=seed, kmask=kadd,
                    causal=is_causal, dropout=p, coords=coords)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, name=None):
    """``(scaled_dot_product_attention(query, key, value, None, dropout,
    causal), None)``, as the reference returns it
    (``attention.py:103-111``): always in training, so ``dropout > 0``
    drops (kernels 4-6) and ``dropout == 0`` runs kernels 1-3. No
    softmax is returned, with or without ``return_softmax``."""
    return scaled_dot_product_attention(query, key, value, None, dropout,
                                        causal), None


def sliding_window_attention(query, key, value, window_size, name=None):
    """Causal local attention: query row r sees keys in ``(r -
    window_size, r]`` (bottom-right aligned)."""
    if not isinstance(window_size, int) or window_size <= 0:
        raise ValueError(
            f"window_size must be a positive int, got {window_size!r}")
    query, key, value = cast_inputs("sliding_window_attention", query, key,
                                    value)
    return flash_kernel(query, key, value, causal=True,
                        window=window_size)


def _seq_group(axis):
    """The group of ``axis`` (a ``collective.Group``), or None at degree
    1 or without a parallel environment."""
    from ...distributed import env as env_mod
    from ...distributed.collective import Group

    env = env_mod.get_env()
    if env is None or env.degree(axis) <= 1:
        return None
    return Group((axis,))


def ring_flash_attention(query, key, value, axis="sep", causal=True,
                         name=None):
    """Context-parallel exact attention: each rank of mesh ``axis`` holds
    its chunk of the sequence (``[b, s/n, h, d]``, chunks in rank order)
    and K/V rotate around the ring (``ops/ring_attention.py``, kernels
    1-3 on each block). At degree 1 it is
    :func:`scaled_dot_product_attention`."""
    group = _seq_group(axis)
    if group is None:
        return scaled_dot_product_attention(query, key, value,
                                            is_causal=causal)
    from ...ops.ring_attention import ring_attention

    query, key, value = cast_inputs("scaled_dot_product_attention", query,
                                    key, value)
    return ring_attention(query, key, value, group, causal=causal)


def ulysses_attention(query, key, value, axis="sep", causal=True,
                      name=None):
    """DeepSpeed-Ulysses sequence parallelism: two all-to-alls over mesh
    ``axis`` trade the sequence chunk for a head chunk, so each rank
    attends over the whole sequence with ``h/n`` heads
    (``ops/ulysses_attention.py``, kernels 1-3). At degree 1 it is
    :func:`scaled_dot_product_attention`."""
    group = _seq_group(axis)
    if group is None:
        return scaled_dot_product_attention(query, key, value,
                                            is_causal=causal)
    from ...ops.ulysses_attention import ulysses_attention as _ulysses

    query, key, value = cast_inputs("scaled_dot_product_attention", query,
                                    key, value)
    return _ulysses(query, key, value, group, causal=causal)
