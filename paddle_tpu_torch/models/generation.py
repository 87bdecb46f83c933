"""Autoregressive generation for the Llama family.

Counterpart of ``paddle_tpu/models/generation.py``. The reference
compiles prefill plus a ``lax.scan`` of decode steps into one program;
here the same math runs eagerly: prefill writes the whole prompt into a
preallocated KV cache ``[layers, b, max_len, kv_heads, head_dim]``, then
a Python loop feeds one token at a time against it with a length mask.
The helpers (``_mm``, ``rms_norm``, ``_rope_at``, ``_attend``) keep the
reference's dtype casts line for line: the serving engine reuses them,
and greedy ``generate()`` is the engine's token-identity oracle.

Beside greedy decode: sampling (temperature, top-k, top-p) by the Gumbel
argmax that ``jax.random.categorical`` uses, with the noise drawn from a
``torch.Generator``; weight-only int8 matmuls (``int8_weights``); and
left-padded batches (``attention_mask``), whose pad keys are hidden and
whose RoPE positions start at each row's first real token.

Under tensor parallelism (a model built under ``fleet.init`` with mp >
1) each rank decodes from its own shards, as the training forward does
and as GSPMD partitions the reference's decode: ``qkv`` and
``gate_up`` are column-parallel, ``o`` and ``down`` row-parallel (the
rank's partial product in fp32, summed over mp, then cast), the
embedding vocab-parallel (a masked local lookup, then a sum) and the LM
head column-parallel over the vocabulary (the logits ``[b, V]``
all-gathered before the choice, which every rank then makes alike).
Each rank's cache holds only the kv heads its q heads read
(:class:`_TensorParallel`). The collectives go over the mp group
through ``distributed/_comm.py``, so every rank of the group must run
the decode alike.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..distributed import _comm
from ..distributed.fleet.meta_parallel.parallel_layers.mp_layers import (
    rank_heads,
)
from ..framework.device import resolve_device
from ..framework.dtype import to_torch_dtype
from ..nn.functional.norm import rms_norm
from ..ops.cuda.paged_attention import _per_head
from ..quantization import dequantize_kv, quantize_kv, quantize_weight_int8
from .llama import _rope

__all__ = ["generate"]

_LAYER_KEYS = ("ln1", "qkv", "o", "ln2", "gate_up", "down")
# the matmul weights an int8 pack replaces (embeddings and norms stay)
_INT8_KEYS = ("qkv", "o", "gate_up", "down", "lm_head")


def _mm(x, w):
    """``x @ w``, where ``w`` is a plain weight or an int8 pack
    ``{"q", "s"}``: the product with the int8 weight cast to x's dtype,
    then the per-channel scale, in the reference's order."""
    if isinstance(w, dict):
        return (x @ w["q"].to(x.dtype)) * w["s"].to(x.dtype)
    return x @ w


def _layer(params, li) -> dict:
    """Layer ``li``'s weights (an int8 pack sliced on both tensors)."""
    return {k: ({n: t[li] for n, t in params[k].items()}
                if isinstance(params[k], dict) else params[k][li])
            for k in _LAYER_KEYS}


class _TensorParallel:
    """A rank's part of a tensor-parallel decode: the mp group, the
    rank's vocab rows of the embedding, its ``heads`` q heads (whole
    heads as training cuts them, ``mp_layers.rank_heads``: the first
    ``nh % mp`` ranks one more, a rank possibly none) and the kv heads
    they read, ``kv_heads`` of
    them from global kv head ``kv_lo`` on. Local q head ``i`` reads
    local kv head ``(i + head_offset) // kv_group``, ``kv_group`` the
    model's q heads per kv head (``_GenCfg``); the offset is 0
    when mp divides the kv heads, and else (K and V replicated in the
    training layout, ``kv_whole``) the rank's q heads need not start a
    group: 12 q over 3 kv heads at mp 2 puts kv heads 1, 1, 2, 2, 2, 2
    under rank 1's six, ``kv_lo`` 1 and offset 2."""

    def __init__(self, model):
        par, cfg = model._par, model.config
        nh = cfg.num_attention_heads
        nkv = cfg.num_key_value_heads or nh
        group = nh // nkv  # q heads per kv head
        self.group = par.group
        # a rank without heads reads no kv head
        self.heads, q0 = rank_heads(nh, par.n, par.rank)
        self.kv_lo = q0 // group
        self.kv_heads = 0 if self.heads == 0 else \
            (q0 + self.heads - 1) // group - self.kv_lo + 1
        self.head_offset = q0 - self.kv_lo * group
        self.kv_whole = nkv % par.n != 0
        self.vocab = cfg.vocab_size // par.n
        self.vocab_lo = par.rank * self.vocab


def _tensor_parallel(model):
    """The model's :class:`_TensorParallel` under mp > 1, else None."""
    par = getattr(model, "_par", None)
    return _TensorParallel(model) if par is not None and par.n > 1 \
        else None


def _qkv_columns(w, tp, head_dim):
    """The fused ``qkv`` weight ``[hidden, (q + 2 kv) cols]`` of one
    rank as its decode reads it: its q heads, then the K and V columns
    of the kv heads those read (when the training layout replicates K
    and V, the others are dropped)."""
    if tp is None or not tp.kv_whole:
        return w
    q = tp.heads * head_dim
    kv = (w.shape[-1] - q) // 2
    lo, n = tp.kv_lo * head_dim, tp.kv_heads * head_dim
    return torch.cat([w[..., :q], w[..., q + lo:q + lo + n],
                      w[..., q + kv + lo:q + kv + lo + n]], dim=-1)


def _collect_params(model, int8_weights=False) -> dict:
    """The decode weights as one dict, per-layer weights stacked on a
    leading layer axis: ``ln1 qkv o ln2 gate_up down`` ``[layers, ...]``
    plus ``embed``, ``norm`` and ``lm_head``. ``int8_weights`` packs
    ``qkv o gate_up down lm_head`` with :func:`quantize_weight_int8`.
    Cached on the model and rebuilt when the flag changes or any
    parameter is replaced or written in place (the key holds each
    parameter's storage address and version counter).

    Under tensor parallelism each rank stacks its own shards (no whole
    weight is gathered): the column-parallel ``qkv`` (its q heads and
    the K and V of the kv heads they read, :func:`_qkv_columns`),
    ``gate_up`` and ``lm_head``, the row-parallel ``o`` and ``down``, the
    vocab rows of ``embed``; the norms are whole on every rank. The
    int8 scales of ``o`` and ``down``, whose input axis is split, are
    the maxima over mp (collective: every rank of the group must call
    it then)."""
    sources = tuple((p.data_ptr(), p._version)
                    for _, p in model.named_parameters())
    cached = getattr(model, "_generation_params_cache", None)
    if cached is not None and cached[0] == (sources, bool(int8_weights)):
        return cached[1]
    core = model.model
    tp = _tensor_parallel(model)
    head_dim = model.config.hidden_size // model.config.num_attention_heads
    per_layer = {k: [] for k in _LAYER_KEYS}
    with torch.no_grad():
        for blk in core.layers:
            per_layer["ln1"].append(blk.input_layernorm.weight)
            per_layer["qkv"].append(_qkv_columns(
                blk.self_attn.qkv_proj.weight, tp, head_dim))
            per_layer["o"].append(blk.self_attn.o_proj.weight)
            per_layer["ln2"].append(blk.post_attention_layernorm.weight)
            per_layer["gate_up"].append(blk.mlp.gate_up_proj.weight)
            per_layer["down"].append(blk.mlp.down_proj.weight)
        params = {k: torch.stack(v) for k, v in per_layer.items()}
        params["embed"] = core.embed_tokens.weight.detach()
        params["norm"] = core.norm.weight.detach()
        params["lm_head"] = model.lm_head.weight.detach()
        if int8_weights:
            for k in _INT8_KEYS:
                row = tp is not None and k in ("o", "down")
                params[k] = quantize_weight_int8(
                    params[k], group=tp.group if row else None)
    model._generation_params_cache = ((sources, bool(int8_weights)), params)
    return params


def _embed(params, ids, dtype, tp=None):
    """The embedding rows of ``ids`` in ``dtype``; under tensor
    parallelism this rank's vocab rows looked up (0 elsewhere) and
    summed over mp, which is exact: one rank holds each row."""
    if tp is None:
        return params["embed"][ids.long()].to(dtype)
    local = ids.long() - tp.vocab_lo
    mine = (local >= 0) & (local < tp.vocab)
    x = params["embed"][local.clamp(0, tp.vocab - 1)].to(torch.float32)
    x = torch.where(mine[..., None], x, torch.zeros((), device=x.device))
    return _comm.all_reduce(x, tp.group).to(dtype)


def _row(x, w, tp=None):
    """``x @ w`` for a row-parallel weight (``o``, ``down``): under
    tensor parallelism the rank's partial product in fp32, summed over
    mp in fp32 and cast after the sum (an int8 pack's scale applied
    after the cast, in the reference's order), so the result differs
    from one card's by a reordered fp32 sum; else :func:`_mm`."""
    if tp is None:
        return _mm(x, w)
    q = w["q"] if isinstance(w, dict) else w
    part = torch.matmul(x.to(torch.float32), q.to(torch.float32))
    y = _comm.all_reduce(part, tp.group).to(x.dtype)
    return y * w["s"].to(x.dtype) if isinstance(w, dict) else y


def _logits(x, params, tp=None):
    """fp32 logits ``[..., vocab]`` of the final hidden states ``x``
    (after the norm): under tensor parallelism every rank's vocab
    columns all-gathered, so every rank holds the whole row."""
    out = _mm(x, params["lm_head"]).to(torch.float32)
    return out if tp is None else _comm.all_gather(out, -1, tp.group)


def _rope_at(q, k, pos, theta):
    """RoPE at per-token absolute positions ``pos`` — the training
    forward's helper (``llama._rope``), so the conventions cannot
    drift."""
    return _rope(q, k, theta, q.dtype, pos=pos)


def _kv_per_head(kc, cfg):
    """Cached K or V ``[b, L, nkv, d]`` as the rank's q heads read it,
    with the q heads a kv row serves: as it is when the q heads are
    whole groups of the kv heads (always on one card), else one row per
    q head (``_TensorParallel``'s offset), as the paged kernels map
    them."""
    nh = cfg.num_attention_heads
    kc = _per_head(kc, nh, cfg.kv_group, cfg.head_offset)
    return kc, nh // kc.shape[2]


def _attend(q, kc, vc, valid_len, cfg, key_pad=None):
    """q ``[b, sq, nh, d]`` against cached kc/vc ``[b, L, nkv, d]``,
    masked to positions ``< valid_len`` (+ causal within the query
    block, + the sliding-window band). ``key_pad`` ``[b]`` hides each
    row's leading left-pad slots. fp32 logits, 1/sqrt(d), -1e30 mask,
    fp32 softmax and AV, one cast back."""
    b, sq, nh, d = q.shape
    L = kc.shape[1]
    kc, g = _kv_per_head(kc, cfg)
    vc, _ = _kv_per_head(vc, cfg)
    dev = q.device
    qg = q.reshape(b, sq, nh // g, g, d)
    logits = torch.einsum("bskgd,blkd->bskgl", qg.to(torch.float32),
                          kc.to(torch.float32)) / math.sqrt(d)
    q_pos = valid_len - sq + torch.arange(sq, device=dev)  # [sq]
    slots = torch.arange(L, device=dev)
    vis = slots[None, :] <= q_pos[:, None]  # [sq, L]
    if cfg.sliding_window > 0:
        vis &= slots[None, :] > q_pos[:, None] - cfg.sliding_window
    vis = vis[None].expand(b, sq, L)
    if key_pad is not None:
        vis = vis & (slots[None, None, :] >= key_pad[:, None, None])
    logits = torch.where(vis[:, :, None, None, :], logits,
                         torch.full((), -1e30, device=dev))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bskgl,blkd->bskgd", p, vc.to(torch.float32))
    return out.reshape(b, sq, nh, d).to(q.dtype)


def _mlp(x, layer_p, cfg, tp=None):
    h2 = rms_norm(x, layer_p["ln2"], cfg.rms_norm_eps)
    gate, up = _mm(h2, layer_p["gate_up"]).chunk(2, dim=-1)
    act = torch.nn.functional.silu(gate.to(torch.float32)).to(x.dtype)
    return x + _row(act * up, layer_p["down"], tp)


def _qkv(x, layer_p, pos, cfg):
    """Pre-norm, fused QKV projection and RoPE: ``[b, s, hidden]`` ->
    q ``[b, s, nh, d]``, k/v ``[b, s, nkv, d]`` (the rank's heads under
    tensor parallelism)."""
    nh = cfg.num_attention_heads
    nkv = cfg.num_key_value_heads
    d = cfg.head_dim
    b, s = x.shape[0], x.shape[1]
    h = rms_norm(x, layer_p["ln1"], cfg.rms_norm_eps)
    q, k, v = torch.split(_mm(h, layer_p["qkv"]),
                          [nh * d, nkv * d, nkv * d], dim=-1)
    q, k = _rope_at(q.reshape(b, s, nh, d), k.reshape(b, s, nkv, d), pos,
                    cfg.rope_theta)
    return q, k, v.reshape(b, s, nkv, d)


def _block(x, layer_p, cache_k, cache_v, li, pos, valid_len, cfg,
           key_pad=None, kv_int8=False, tp=None):
    """One decoder layer over a ``[b, s]`` slice, writing its K/V into
    the cache at ``[valid_len - s, valid_len)`` in place and attending
    over the cache. ``kv_int8`` round-trips the fresh K/V through the
    int8 quantizer first — the values the engine's int8 pool would hold,
    which makes ``generate(kv_int8=True)`` the int8 engine's oracle."""
    b, s = x.shape[0], x.shape[1]
    q, k, v = _qkv(x, layer_p, pos, cfg)
    if kv_int8:
        k = dequantize_kv(*quantize_kv(k), k.dtype)
        v = dequantize_kv(*quantize_kv(v), v.dtype)
    cache_k[li, :, valid_len - s:valid_len] = k
    cache_v[li, :, valid_len - s:valid_len] = v
    if cfg.num_attention_heads == 0:  # a rank without heads adds nothing
        out = q
    else:
        out = _attend(q, cache_k[li], cache_v[li], valid_len, cfg,
                      key_pad=key_pad)
    x = x + _row(out.reshape(b, s, -1), layer_p["o"], tp)
    return _mlp(x, layer_p, cfg, tp)


def _forward(params, ids, cache_k, cache_v, valid_len, cfg, key_pad=None,
             kv_int8=False, tp=None):
    """Forward ``ids`` ``[b, s]`` at absolute positions
    ``[valid_len - s, valid_len)``; returns the last position's fp32
    logits ``[b, vocab]`` (the caches are updated in place). With left
    padding (``key_pad`` ``[b]``) RoPE positions shift so that each
    row's first real token sits at position 0. ``tp``: the rank's
    :class:`_TensorParallel` (None on one card)."""
    b, s = ids.shape
    x = _embed(params, ids, to_torch_dtype(cfg.dtype), tp)
    pos = (valid_len - s + torch.arange(s, device=ids.device))[None, :] \
        .expand(b, s)
    if key_pad is not None:
        pos = torch.clamp_min(pos - key_pad[:, None], 0)
    for li in range(params["ln1"].shape[0]):
        x = _block(x, _layer(params, li), cache_k, cache_v, li, pos,
                   valid_len, cfg, key_pad=key_pad, kv_int8=kv_int8, tp=tp)
    x = rms_norm(x, params["norm"], cfg.rms_norm_eps)
    return _logits(x[:, -1], params, tp)


def _gumbel(shape, generator, device):
    """Standard Gumbel noise ``-log(-log(u))``, u uniform in [tiny, 1)
    from ``generator`` — ``jax.random.gumbel``'s construction."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _sample(logits, generator, do_sample, temperature, top_k, top_p,
            use_top_p, noise=None):
    """The next token ``[b]`` from fp32 logits ``[b, vocab]``, step for
    step the reference's ``_sample``: greedy argmax, or logits over
    ``max(temperature, 1e-6)``, everything below the k-th largest set to
    -1e30 (``top_k > 0``), everything below the top-p cutoff (the first
    sorted logit whose cumulative probability reaches ``top_p``) set to
    -1e30 (``use_top_p``), then ``argmax(logits + g)`` with Gumbel noise
    ``g`` — ``jax.random.categorical`` with ``replace=True``. ``noise``
    overrides the draw from ``generator`` (the tests pass JAX's)."""
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    t = np.maximum(np.float32(temperature), np.float32(1e-6))
    logits = logits / logits.new_full((), float(t))
    neg = logits.new_full((), -1e30)
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, neg, logits)
    if use_top_p:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_l, dim=-1), dim=-1)
        idx = torch.sum(cum < logits.new_full((), float(np.float32(top_p))),
                        dim=-1, keepdim=True)
        # every cumulative sum short of top_p (rounding): keep them all
        cutoff = torch.gather(sorted_l, -1,
                              torch.clamp_max(idx, logits.shape[-1] - 1))
        logits = torch.where(logits < cutoff, neg, logits)
    if noise is None:
        noise = _gumbel(logits.shape, generator, logits.device)
    return torch.argmax(logits + noise, dim=-1)


def _left_pad(attention_mask, shape):
    """Validate a left-padded ``attention_mask`` host-side (each row
    ``0^k 1^(n-k)``) and return each row's pad count ``k`` as numpy."""
    if isinstance(attention_mask, torch.Tensor):
        attention_mask = attention_mask.detach().cpu().numpy()
    m = np.asarray(attention_mask)
    if tuple(m.shape) != tuple(shape):
        raise ValueError(
            f"attention_mask shape {tuple(m.shape)} must equal "
            f"input_ids shape {tuple(shape)}")
    mh = m.astype(bool)
    npad = (~mh).sum(axis=1)
    if not np.array_equal(mh, np.arange(mh.shape[1])[None, :]
                          >= npad[:, None]):
        raise ValueError(
            "attention_mask must be LEFT-padded (each row all zeros "
            "then all ones); interior zeros / right padding are not "
            "expressible in the cache layout")
    return npad


class _GenCfg:
    """Value view of the ``LlamaConfig`` fields the decode math reads.
    Given a :class:`_TensorParallel`, the head counts are the rank's
    (its q heads and the kv heads they read) and ``head_offset`` maps
    one to the other; ``kv_group`` is the model's q heads per kv
    head."""

    __slots__ = ("num_attention_heads", "num_key_value_heads", "head_dim",
                 "kv_group", "head_offset", "hidden_size", "rope_theta",
                 "rms_norm_eps", "dtype", "sliding_window")

    def __init__(self, cfg, tp=None):
        nh = cfg.num_attention_heads
        nkv = cfg.num_key_value_heads or nh
        self.head_dim = cfg.hidden_size // nh
        self.kv_group = nh // nkv
        self.num_attention_heads = nh if tp is None else tp.heads
        self.num_key_value_heads = nkv if tp is None else tp.kv_heads
        self.head_offset = 0 if tp is None else tp.head_offset
        self.hidden_size = cfg.hidden_size
        self.rope_theta = float(cfg.rope_theta)
        self.rms_norm_eps = float(cfg.rms_norm_eps)
        self.dtype = str(cfg.dtype)
        self.sliding_window = int(getattr(cfg, "sliding_window", 0) or 0)

    def _key(self):
        """The fields as a tuple (part of the engine's graph keys)."""
        return tuple(getattr(self, f) for f in self.__slots__)


def _check_model_device(model, dev):
    if model.device != dev:
        raise ValueError(f"the model lives on {model.device}, but device "
                         f"{dev} was asked for")


@torch.no_grad()
def generate(model, input_ids, max_new_tokens=32, do_sample=False,
             temperature=1.0, top_k=0, top_p=1.0, eos_token_id=None,
             seed=0, attention_mask=None, int8_weights=None, kv_int8=None,
             generator=None, device="cuda"):
    """Continue ``input_ids`` (``[b, prompt_len]`` ints: a tensor, a
    numpy array or a list). Returns the generated tokens
    ``[b, max_new_tokens]`` int32 on ``device`` (prompt excluded). After
    ``eos_token_id`` a row keeps emitting it.

    ``do_sample`` samples with ``temperature``, ``top_k`` (clamped to
    the vocabulary) and ``top_p`` (see ``_sample``), drawing one noise
    row per step from ``generator``, by default a ``torch.Generator`` on
    ``device`` seeded with ``seed``; greedy otherwise. Unequal-length
    prompts batch by LEFT padding with ``attention_mask`` (``[b,
    prompt_len]``, zeros on the left): pad slots are hidden from
    attention and RoPE positions start at each row's first real token;
    an all-ones mask is no mask. ``int8_weights`` (default:
    ``PT_DECODE_INT8``) runs the matmuls on per-channel int8 weight
    packs. ``kv_int8`` (default: ``PT_SERVE_KV_INT8``) round-trips cached
    K/V through the int8 quantizer (see ``_block``).

    Under tensor parallelism every rank of the mp group calls it with
    the same arguments: each decodes from its shards (the module note),
    draws the same noise from a generator seeded alike, and returns the
    same tokens."""
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if getattr(model.config, "moe_num_experts", 0) > 1:
        raise NotImplementedError(
            "generate() does not decode MoE Llama configs (the reference "
            "refuses them too: the expert dispatch has no cached "
            "single-token path); dense configs are supported")
    dev = resolve_device(device)
    _check_model_device(model, dev)
    if int8_weights is None:
        int8_weights = os.environ.get("PT_DECODE_INT8") == "1"
    if kv_int8 is None:
        kv_int8 = os.environ.get("PT_SERVE_KV_INT8") == "1"
    if not isinstance(input_ids, torch.Tensor):
        input_ids = torch.from_numpy(np.asarray(input_ids))
    ids = input_ids.to(dev, torch.int32)
    key_pad = None
    if attention_mask is not None:
        npad = _left_pad(attention_mask, ids.shape)
        if npad.any():  # an all-ones mask runs the maskless path
            key_pad = torch.from_numpy(npad.astype(np.int32)).to(dev)
    if top_k:
        top_k = min(int(top_k), model.config.vocab_size)
    if do_sample and generator is None:
        generator = torch.Generator(device=dev).manual_seed(int(seed))
    sample = dict(generator=generator, do_sample=bool(do_sample),
                  temperature=temperature, top_k=int(top_k), top_p=top_p,
                  use_top_p=float(top_p) < 1.0)
    tp = _tensor_parallel(model)
    cfg = _GenCfg(model.config, tp)
    params = _collect_params(model, int8_weights=bool(int8_weights))
    b, prompt_len = ids.shape
    max_len = prompt_len + max_new_tokens
    cache_k = torch.zeros((params["ln1"].shape[0], b, max_len,
                           cfg.num_key_value_heads, cfg.head_dim),
                          dtype=to_torch_dtype(cfg.dtype), device=dev)
    cache_v = torch.zeros_like(cache_k)
    eos = -1 if eos_token_id is None else int(eos_token_id)
    logits = _forward(params, ids, cache_k, cache_v, prompt_len, cfg,
                      key_pad=key_pad, kv_int8=kv_int8, tp=tp)
    tok = _sample(logits, **sample).to(torch.int32)
    fin = tok == eos
    out = [tok]
    for i in range(max_new_tokens - 1):
        logits = _forward(params, tok[:, None], cache_k, cache_v,
                          prompt_len + 1 + i, cfg, key_pad=key_pad,
                          kv_int8=kv_int8, tp=tp)
        nxt = _sample(logits, **sample).to(torch.int32)
        tok = torch.where(fin, torch.full_like(nxt, eos), nxt)
        fin = fin | (tok == eos)
        out.append(tok)
    return torch.stack(out, dim=1)
