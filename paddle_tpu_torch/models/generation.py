"""Greedy autoregressive generation for the Llama family.

Counterpart of ``paddle_tpu/models/generation.py``. The reference
compiles prefill plus a ``lax.scan`` of decode steps into one program;
here the same math runs eagerly: prefill writes the whole prompt into a
preallocated KV cache ``[layers, b, max_len, kv_heads, head_dim]``, then
a Python loop feeds one token at a time against it with a length mask.
The helpers (``_mm``, ``rms_norm``, ``_rope_at``, ``_attend``) keep the
reference's dtype casts line for line: the serving engine reuses them,
and greedy ``generate()`` is the engine's token-identity oracle.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..framework.device import resolve_device
from ..framework.dtype import to_torch_dtype
from ..nn.functional.norm import rms_norm
from ..quantization import dequantize_kv, quantize_kv
from .llama import _rope

__all__ = ["generate"]

_LAYER_KEYS = ("ln1", "qkv", "o", "ln2", "gate_up", "down")


def _mm(x, w):
    return x @ w


def _collect_params(model) -> dict:
    """The decode weights as one dict, per-layer weights stacked on a
    leading layer axis: ``ln1 qkv o ln2 gate_up down`` ``[layers, ...]``
    plus ``embed``, ``norm`` and ``lm_head``. Cached on the model and
    rebuilt when any parameter is replaced or written in place (the
    key holds each parameter's storage address and version counter)."""
    sources = tuple((p.data_ptr(), p._version)
                    for _, p in model.named_parameters())
    cached = getattr(model, "_generation_params_cache", None)
    if cached is not None and cached[0] == sources:
        return cached[1]
    core = model.model
    per_layer = {k: [] for k in _LAYER_KEYS}
    for blk in core.layers:
        per_layer["ln1"].append(blk.input_layernorm.weight)
        per_layer["qkv"].append(blk.self_attn.qkv_proj.weight)
        per_layer["o"].append(blk.self_attn.o_proj.weight)
        per_layer["ln2"].append(blk.post_attention_layernorm.weight)
        per_layer["gate_up"].append(blk.mlp.gate_up_proj.weight)
        per_layer["down"].append(blk.mlp.down_proj.weight)
    with torch.no_grad():
        params = {k: torch.stack(v) for k, v in per_layer.items()}
        params["embed"] = core.embed_tokens.weight.detach()
        params["norm"] = core.norm.weight.detach()
        params["lm_head"] = model.lm_head.weight.detach()
    model._generation_params_cache = (sources, params)
    return params


def _rope_at(q, k, pos, theta):
    """RoPE at per-token absolute positions ``pos`` — the training
    forward's helper (``llama._rope``), so the conventions cannot
    drift."""
    return _rope(q, k, theta, q.dtype, pos=pos)


def _attend(q, kc, vc, valid_len, nh, nkv, sliding_window=0):
    """q ``[b, sq, nh, d]`` against cached kc/vc ``[b, L, nkv, d]``,
    masked to positions ``< valid_len`` (+ causal within the query
    block, + the sliding-window band). fp32 logits, 1/sqrt(d), -1e30
    mask, fp32 softmax and AV, one cast back."""
    b, sq, _, d = q.shape
    L = kc.shape[1]
    g = nh // nkv
    dev = q.device
    qg = q.reshape(b, sq, nkv, g, d)
    logits = torch.einsum("bskgd,blkd->bskgl", qg.to(torch.float32),
                          kc.to(torch.float32)) / math.sqrt(d)
    q_pos = valid_len - sq + torch.arange(sq, device=dev)  # [sq]
    slots = torch.arange(L, device=dev)
    vis = slots[None, :] <= q_pos[:, None]  # [sq, L]
    if sliding_window > 0:
        vis &= slots[None, :] > q_pos[:, None] - sliding_window
    logits = torch.where(vis[None, :, None, None, :], logits,
                         torch.full((), -1e30, device=dev))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bskgl,blkd->bskgd", p, vc.to(torch.float32))
    return out.reshape(b, sq, nh, d).to(q.dtype)


def _mlp(x, layer_p, cfg):
    h2 = rms_norm(x, layer_p["ln2"], cfg.rms_norm_eps)
    gate, up = _mm(h2, layer_p["gate_up"]).chunk(2, dim=-1)
    act = torch.nn.functional.silu(gate.to(torch.float32)).to(x.dtype)
    return x + _mm(act * up, layer_p["down"])


def _qkv(x, layer_p, pos, cfg):
    """Pre-norm, fused QKV projection and RoPE: ``[b, s, hidden]`` ->
    q ``[b, s, nh, d]``, k/v ``[b, s, nkv, d]``."""
    nh = cfg.num_attention_heads
    nkv = cfg.num_key_value_heads
    d = cfg.hidden_size // nh
    b, s = x.shape[0], x.shape[1]
    h = rms_norm(x, layer_p["ln1"], cfg.rms_norm_eps)
    q, k, v = torch.split(_mm(h, layer_p["qkv"]),
                          [nh * d, nkv * d, nkv * d], dim=-1)
    q, k = _rope_at(q.reshape(b, s, nh, d), k.reshape(b, s, nkv, d), pos,
                    cfg.rope_theta)
    return q, k, v.reshape(b, s, nkv, d)


def _block(x, layer_p, cache_k, cache_v, li, pos, valid_len, cfg,
           kv_int8=False):
    """One decoder layer over a ``[b, s]`` slice, writing its K/V into
    the cache at ``[valid_len - s, valid_len)`` in place and attending
    over the cache. ``kv_int8`` round-trips the fresh K/V through the
    int8 quantizer first — the values the engine's int8 pool would hold,
    which makes ``generate(kv_int8=True)`` the int8 engine's oracle."""
    nh = cfg.num_attention_heads
    nkv = cfg.num_key_value_heads
    b, s = x.shape[0], x.shape[1]
    q, k, v = _qkv(x, layer_p, pos, cfg)
    if kv_int8:
        k = dequantize_kv(*quantize_kv(k), k.dtype)
        v = dequantize_kv(*quantize_kv(v), v.dtype)
    cache_k[li, :, valid_len - s:valid_len] = k
    cache_v[li, :, valid_len - s:valid_len] = v
    out = _attend(q, cache_k[li], cache_v[li], valid_len, nh, nkv,
                  sliding_window=cfg.sliding_window)
    x = x + _mm(out.reshape(b, s, -1), layer_p["o"])
    return _mlp(x, layer_p, cfg)


def _forward(params, ids, cache_k, cache_v, valid_len, cfg, kv_int8=False):
    """Forward ``ids`` ``[b, s]`` at absolute positions
    ``[valid_len - s, valid_len)``; returns the last position's fp32
    logits ``[b, vocab]`` (the caches are updated in place)."""
    b, s = ids.shape
    x = params["embed"][ids.long()].to(to_torch_dtype(cfg.dtype))
    pos = (valid_len - s + torch.arange(s, device=ids.device))[None, :] \
        .expand(b, s)
    for li in range(params["ln1"].shape[0]):
        layer_p = {k: params[k][li] for k in _LAYER_KEYS}
        x = _block(x, layer_p, cache_k, cache_v, li, pos, valid_len, cfg,
                   kv_int8=kv_int8)
    x = rms_norm(x, params["norm"], cfg.rms_norm_eps)
    return _mm(x[:, -1], params["lm_head"]).to(torch.float32)


class _GenCfg:
    """Value view of the ``LlamaConfig`` fields the decode math reads."""

    __slots__ = ("num_attention_heads", "num_key_value_heads",
                 "hidden_size", "rope_theta", "rms_norm_eps", "dtype",
                 "sliding_window")

    def __init__(self, cfg):
        self.num_attention_heads = cfg.num_attention_heads
        self.num_key_value_heads = cfg.num_key_value_heads \
            or cfg.num_attention_heads
        self.hidden_size = cfg.hidden_size
        self.rope_theta = float(cfg.rope_theta)
        self.rms_norm_eps = float(cfg.rms_norm_eps)
        self.dtype = str(cfg.dtype)
        self.sliding_window = int(getattr(cfg, "sliding_window", 0) or 0)


def _check_model_device(model, dev):
    if model.device != dev:
        raise ValueError(f"the model lives on {model.device}, but device "
                         f"{dev} was asked for")


@torch.no_grad()
def generate(model, input_ids, max_new_tokens=32, do_sample=False,
             eos_token_id=None, attention_mask=None, int8_weights=None,
             kv_int8=None, device="cuda"):
    """Greedy continuation of ``input_ids`` (``[b, prompt_len]`` ints: a
    tensor, a numpy array or a list). Returns the generated tokens
    ``[b, max_new_tokens]`` int32 on ``device`` (prompt excluded). After
    ``eos_token_id`` a row keeps emitting it.

    ``kv_int8`` (default: ``PT_SERVE_KV_INT8``) round-trips cached K/V
    through the int8 quantizer (see ``_block``). Sampling,
    ``int8_weights`` (``PT_DECODE_INT8``) and left-padded
    ``attention_mask`` batches are not ported yet and raise
    ``NotImplementedError``."""
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    dev = resolve_device(device)
    _check_model_device(model, dev)
    if do_sample:
        raise NotImplementedError(
            "generate(do_sample=True) is not ported yet (ROADMAP queue A)")
    if int8_weights is None:
        int8_weights = os.environ.get("PT_DECODE_INT8") == "1"
    if int8_weights:
        raise NotImplementedError(
            "weight-only int8 decode is not ported yet (ROADMAP queue A)")
    if kv_int8 is None:
        kv_int8 = os.environ.get("PT_SERVE_KV_INT8") == "1"
    if not isinstance(input_ids, torch.Tensor):
        input_ids = torch.from_numpy(np.asarray(input_ids))
    ids = input_ids.to(dev, torch.int32)
    if attention_mask is not None:
        mask = torch.as_tensor(np.asarray(attention_mask))
        if tuple(mask.shape) != tuple(ids.shape):
            raise ValueError(
                f"attention_mask shape {tuple(mask.shape)} must equal "
                f"input_ids shape {tuple(ids.shape)}")
        if not bool(mask.bool().all()):
            raise NotImplementedError(
                "left-padded attention_mask batches are not ported yet "
                "(ROADMAP queue A); an all-ones mask is accepted")
    cfg = _GenCfg(model.config)
    params = _collect_params(model)
    b, prompt_len = ids.shape
    nh = cfg.num_attention_heads
    nkv = cfg.num_key_value_heads
    d = cfg.hidden_size // nh
    max_len = prompt_len + max_new_tokens
    cache_k = torch.zeros((params["ln1"].shape[0], b, max_len, nkv, d),
                          dtype=to_torch_dtype(cfg.dtype), device=dev)
    cache_v = torch.zeros_like(cache_k)
    eos = -1 if eos_token_id is None else int(eos_token_id)
    logits = _forward(params, ids, cache_k, cache_v, prompt_len, cfg,
                      kv_int8=kv_int8)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    fin = tok == eos
    out = [tok]
    for i in range(max_new_tokens - 1):
        logits = _forward(params, tok[:, None], cache_k, cache_v,
                          prompt_len + 1 + i, cfg, kv_int8=kv_int8)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        tok = torch.where(fin, torch.full_like(nxt, eos), nxt)
        fin = fin | (tok == eos)
        out.append(tok)
    return torch.stack(out, dim=1)
