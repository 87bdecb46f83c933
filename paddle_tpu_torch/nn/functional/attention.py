"""Attention (counterpart of ``paddle_tpu/nn/functional/attention.py``).

Both entries take the reference's ``[batch, seq, heads, head_dim]``
layout (k/v may have fewer heads: GQA) and route to the autograd
flash-attention Function of ``ops/cuda/flash_attention.py``: the CUDA
kernels on a CUDA tensor, their plain versions on a CPU tensor. There is
no crossover to a composite: the TPU path's autotune table
(``flash_attention.py:657-709``) measured the TPU, and on the card the
kernel always runs.
"""
from __future__ import annotations

from ...ops.cuda.flash_attention import _ENCODER_SLICE, flash_attention

__all__ = ["scaled_dot_product_attention", "sliding_window_attention"]


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """Softmax attention with scale ``1/sqrt(head_dim)``; ``is_causal``
    masks bottom-right aligned. ``attn_mask`` and ``dropout_p > 0``
    while training raise ``NotImplementedError``."""
    if attn_mask is not None:
        raise NotImplementedError(f"attn_mask {_ENCODER_SLICE}")
    if training and dropout_p > 0.0:
        raise NotImplementedError(f"attention dropout {_ENCODER_SLICE}")
    return flash_attention(query, key, value, causal=is_causal)


def sliding_window_attention(query, key, value, window_size):
    """Causal local attention: query row r sees keys in ``(r -
    window_size, r]`` (bottom-right aligned)."""
    if not isinstance(window_size, int) or window_size <= 0:
        raise ValueError(
            f"window_size must be a positive int, got {window_size!r}")
    return flash_attention(query, key, value, causal=True,
                           window=window_size)
