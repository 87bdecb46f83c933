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
- any other ``attn_mask`` that broadcasts to ``[b, h, sq, sk]`` by
  numpy's right-aligned rule (``[sq, sk]``, ``[b, 1, sq, sk]``, ``[b, h,
  sq, sk]``, ...; the Transformer decoder's causal ``[L, L]`` mask) goes
  to the tile mode of the flash entry (kernels 1-3 reading the mask
  through its strides, with dropout drawn by the same hash at the same
  coordinates), as the reference's composite adds it
  (``_sdpa_reference``, ``attention.py:37-45``); a mask that does not
  broadcast raises ``ValueError``;
- every other call (no mask, no dropout: the Llama path) goes to the
  flash entry (``ops/cuda/flash_attention.py``, kernels 1-3).

``ring_flash_attention`` and ``ulysses_attention`` take each rank's
chunk of the sequence over the ``sep`` group (``ops/ring_attention.py``,
``ops/ulysses_attention.py``, both on kernels 1-3) and are
:func:`scaled_dot_product_attention` at degree 1.

A mask is bool (keep: 0, else NEG_INF) or additive float, cast to fp32
and clamped at NEG_INF so that a fully masked row cannot give inf - inf.
A row-varying mask has no TPU kernel (JAX sends it to its composite,
``flash_attention.py:633-641``); the port has no composite and runs the
tile mode. There is no crossover to a composite on the card: the TPU
path's autotune table (``flash_attention.py:657-709``) measured the TPU,
and on the card the kernel always runs.
"""
from __future__ import annotations

import math

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


def _additive(mask):
    """A bool (keep) or float mask as additive fp32 clamped at NEG_INF;
    any other dtype raises ``NotImplementedError``."""
    if mask.dtype == torch.bool:
        return torch.where(mask, 0.0, NEG_INF).to(torch.float32)
    if not mask.is_floating_point():
        raise NotImplementedError(
            f"attn_mask of dtype {mask.dtype}: pass a bool (keep) or an "
            f"additive float mask")
    return torch.clamp(mask.to(torch.float32), min=NEG_INF)


def _mask_operand(mask, q_shape, k_shape):
    """``(key rows, tile mask)``, one of them None: a ``[b, 1, 1, sk]``
    key-padding mask as the additive fp32 ``[b, 1, sk]`` rows that kernels
    4-6 take (the reference's ``_key_padding_additive``,
    ``flash_attention.py:728``); any other mask that broadcasts to ``[b, h,
    sq, sk]`` as the tile mode's 4-D fp32 operand, its broadcast dims kept
    at size 1 and its key dim full and contiguous. A mask that does not
    broadcast raises ``ValueError``."""
    b, sq, h, _ = q_shape
    sk = k_shape[1]
    target = (b, h, sq, sk)
    shape = tuple(mask.shape)
    if len(shape) > 4 or any(
            n not in (1, t) for n, t in zip(shape[::-1], target[::-1])):
        raise ValueError(
            f"attn_mask of shape {list(shape)} does not broadcast to [b, "
            f"num_heads, sq, sk] = {list(target)}")
    if shape == (b, 1, 1, sk):
        return _additive(mask.reshape(b, 1, sk)), None
    m = _additive(mask.reshape((1,) * (4 - len(shape)) + shape))
    if m.shape[3] != sk or m.stride(3) != 1:
        m = m.expand(*m.shape[:3], sk).contiguous()
    return None, m


def _dropout_coords(query):
    """Where ``query`` (``[b, s, h, d]``) lies in the global batch and
    heads, as the kernels' ``coords`` (first batch row, first head,
    global heads), from the spec a model recorded on it
    (``shard.mark_local``: dim 0 over the batch axes, dim 2 over mp;
    ``query._heads``, ``(first, global heads)``, where mp does not
    divide the heads), or None when it is the whole tensor. The
    reference's dropout hashes the global query head (its arrays are
    global under GSPMD); so does a rank here, and every layout drops
    what one card drops."""
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
    first, heads = getattr(query, "_heads", (rh * h, nh * h))
    return rb * b, first, heads


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Softmax attention with scale ``1/sqrt(head_dim)``; ``is_causal``
    masks bottom-right aligned; ``attn_mask`` (bool keep, or additive
    float) broadcasts to ``[b, num_heads, sq, sk]``: a ``[b, 1, 1, sk]``
    key-padding mask runs kernels 4-6, any other the tile mode of kernels
    1-3; ``dropout_p`` drops attention probabilities while ``training``
    (outside training it is 0, as in the reference). A white op under
    ``auto_cast``."""
    query, key, value = cast_inputs("scaled_dot_product_attention", query,
                                    key, value)
    p = float(dropout_p) if training else 0.0
    kadd = tile = None
    if attn_mask is not None:
        kadd, tile = _mask_operand(attn_mask, query.shape, key.shape)
    seed = coords = None
    if p > 0.0:
        seed, coords = random.next_seed_words(), _dropout_coords(query)
    # the kernels read head_dim in 16-byte vectors: a head_dim that is not
    # a multiple of 8 is padded with zeros (the products are unchanged)
    # and the output cut back, at the original scale
    d = query.shape[-1]
    scale, pad = 1.0 / math.sqrt(d), -d % 8
    if pad:
        query, key, value = (torch.nn.functional.pad(t, (0, pad))
                             for t in (query, key, value))
    if tile is not None:
        out = flash_kernel(query, key, value, causal=is_causal, scale=scale,
                           tmask=tile, seed=seed, dropout=p, coords=coords)
    elif kadd is None and p == 0.0:
        out = flash_kernel(query, key, value, causal=is_causal, scale=scale)
    else:
        out = hb_flash(query, key, value, seed=seed, kmask=kadd,
                       causal=is_causal, scale=scale, dropout=p,
                       coords=coords)
    return out[..., :d] if pad else out


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
