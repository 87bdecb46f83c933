"""Transformer layers (counterpart of ``paddle_tpu/nn/layer/transformer.py``):
``MultiHeadAttention`` with its incremental ``Cache`` and cross-attention
``StaticCache``, the encoder and decoder layers and stacks, and
``Transformer``.

Attention runs through ``F.scaled_dot_product_attention`` on the
``[batch, seq, heads, head_dim]`` layout, so on the card a key-padding
mask (``[b, 1, 1, sk]``: the encoder's and the cross attention's) runs
kernels 4-6 and any other mask (the decoder's causal ``[L, L]`` from
:meth:`Transformer.generate_square_subsequent_mask`) the tile mode of
kernels 1-3, with the attention dropout drawn in the kernels; a cached
decode step (one query row, no mask) runs kernel 1. Layers take
``device`` and ``generator`` keyword-only and hand them to their
sublayers.
"""
from __future__ import annotations

import collections
import copy

import numpy as np
import torch

from ...framework.device import current_device
from .. import functional as F
from .common import Dropout, Linear
from .layers import Layer, LayerList
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


def _convert_attention_mask(attn_mask, dtype):
    """A bool mask (True keeps) as the reference's additive fp32 mask (0,
    else -1e30); a float mask as it is (``transformer.py:20-32``)."""
    if attn_mask is None or attn_mask.is_floating_point():
        return attn_mask
    return torch.where(attn_mask.to(torch.bool), 0.0, -1e30).to(
        torch.float32)


class MultiHeadAttention(Layer):
    """Multi-head attention over ``[batch, seq, embed]`` inputs with
    ``q/k/v/out_proj`` Linear projections. ``cache``: a ``Cache`` (the
    keys and values so far, ``[b, t, heads, head_dim]``; the new ones are
    appended and the grown cache returned beside the output) or a
    ``StaticCache`` (the cross attention's keys and values, computed once
    by :meth:`gen_cache`)."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, generator=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        kw = dict(device=device, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, weight_attr,
                             bias_attr, **kw)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, weight_attr,
                             bias_attr, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               **kw)

    def _split_heads(self, x):
        b, s, _ = x.shape
        return x.reshape(b, s, self.num_heads, self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k.to(k.dtype), k], dim=1)
                v = torch.cat([cache.v.to(v.dtype), v], dim=1)
                cache = self.Cache(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=_convert_attention_mask(attn_mask, q.dtype),
            dropout_p=self.dropout, training=self.training)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        if cache is not None and not isinstance(cache, self.StaticCache):
            return out, cache
        return out

    def gen_cache(self, key, value=None, type=Cache):  # noqa: A002
        """An empty ``Cache`` (``[b, 0, heads, head_dim]`` of key's dtype)
        or, with ``type=StaticCache``, the projected keys and values of
        ``key`` and ``value`` (default: key)."""
        if type == self.StaticCache:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(
                value if value is not None else key))
            return self.StaticCache(k, v)
        empty = key.new_zeros((key.shape[0], 0, self.num_heads,
                               self.head_dim))
        return self.Cache(empty, empty)


def _dropouts(dropout, attn_dropout, act_dropout):
    return (dropout if attn_dropout is None else attn_dropout,
            dropout if act_dropout is None else act_dropout)


class TransformerEncoderLayer(Layer):
    """Self-attention and a feed-forward block, each with a residual
    connection, dropout and a LayerNorm after it (before it with
    ``normalize_before``); ``attn_dropout`` and ``act_dropout`` default
    to ``dropout``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 *, device=None, generator=None):
        super().__init__()
        attn_dropout, act_dropout = _dropouts(dropout, attn_dropout,
                                              act_dropout)
        kw = dict(device=device, generator=generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, **kw)
        self.norm2 = LayerNorm(d_model, **kw)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.act_dropout(self.activation(
            self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    """``num_layers`` copies of ``encoder_layer`` (the first is the layer
    itself, the rest deep copies: equal starting weights, as in the
    reference), then ``norm`` if given."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, c = mod(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    """Self-attention, cross-attention over ``memory`` and a feed-forward
    block, each with a residual connection, dropout and a LayerNorm. As
    in the reference, its attention and feed-forward layers take the
    default attrs (``weight_attr`` and ``bias_attr`` are accepted)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 *, device=None, generator=None):
        super().__init__()
        attn_dropout, act_dropout = _dropouts(dropout, attn_dropout,
                                              act_dropout)
        kw = dict(device=device, generator=generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, **kw)
        self.norm2 = LayerNorm(d_model, **kw)
        self.norm3 = LayerNorm(d_model, **kw)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, sc = self.self_attn(tgt, tgt, tgt, tgt_mask, cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None or not isinstance(
                cache[1], MultiHeadAttention.StaticCache):
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask,
                                  cache[1])
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.act_dropout(self.activation(
            self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (sc, cache[1]))

    def gen_cache(self, memory):
        """(the self-attention's empty ``Cache``, the cross-attention's
        ``StaticCache`` of ``memory``)."""
        return (self.self_attn.gen_cache(memory),
                self.cross_attn.gen_cache(
                    memory, memory, type=MultiHeadAttention.StaticCache))


class TransformerDecoder(Layer):
    """``num_layers`` copies of ``decoder_layer`` (as
    :class:`TransformerEncoder`), then ``norm`` if given."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [
            copy.deepcopy(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, c = mod(output, memory, tgt_mask, memory_mask,
                                cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        return [layer.gen_cache(memory) for layer in self.layers]


class Transformer(Layer):
    """An encoder-decoder Transformer (Vaswani et al. 2017; the defaults
    are their "base" widths): ``num_encoder_layers`` encoder layers and
    ``num_decoder_layers`` decoder layers (or ``custom_encoder`` and
    ``custom_decoder``), each stack ending in a LayerNorm with
    ``normalize_before``."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args, **kw), num_encoder_layers,
                LayerNorm(d_model, **kw) if normalize_before else None)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args, **kw), num_decoder_layers,
                LayerNorm(d_model, **kw) if normalize_before else None)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    def generate_square_subsequent_mask(self, length):
        """The decoder's causal mask: a float32 ``[length, length]`` with
        -inf above the diagonal and 0 elsewhere, on the model's device
        (``transformer.py:289-292``)."""
        p = next(iter(self.parameters()), None)
        dev = current_device() if p is None else p.device
        m = np.triu(np.full((length, length), -np.inf, np.float32), k=1)
        return torch.from_numpy(m).to(dev)
