"""Llama-family causal LM as an ``nn.Module``.

Counterpart of ``paddle_tpu/models/llama.py``. Parameters carry the JAX
model's names (``llama.embed_tokens.weight``,
``llama.layers.{i}.self_attn.qkv_proj.weight``, ..., ``lm_head.weight``)
and Paddle's ``[in, out]`` weight layout, so :func:`load_jax_weights`
can fill the port from the reference model's arrays one name at a time.

This slice of the port serves the model (``models/generation.py``,
``serving/engine.py``); both read the stacked weights through
``generation._collect_params``. The full-sequence training ``forward``
needs the flash-attention kernels of the training slice and raises
until then.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..framework.device import resolve_device
from ..framework.dtype import to_torch_dtype

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "load_jax_weights"]


class LlamaConfig:
    """Same fields, defaults and validation as the reference's
    ``LlamaConfig``."""

    def __init__(
        self,
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=11008,
        num_hidden_layers=32,
        num_attention_heads=32,
        num_key_value_heads=None,
        max_position_embeddings=4096,
        rms_norm_eps=1e-5,
        rope_theta=10000.0,
        tie_word_embeddings=False,
        sequence_parallel=False,
        context_parallel=False,
        context_parallel_mode="ring",
        sliding_window=0,
        use_parallel_cross_entropy=True,
        ce_chunk_size=0,
        recompute=False,
        dtype="float32",
        moe_num_experts=0,
        moe_top_k=2,
        moe_expert_axis="dp",
        moe_aux_loss_coeff=0.01,
    ):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = num_key_value_heads or num_attention_heads
        self.max_position_embeddings = max_position_embeddings
        self.rms_norm_eps = rms_norm_eps
        self.rope_theta = rope_theta
        self.tie_word_embeddings = tie_word_embeddings
        self.sequence_parallel = sequence_parallel
        self.context_parallel = context_parallel
        if context_parallel_mode not in ("ring", "ulysses"):
            raise ValueError(
                "context_parallel_mode must be 'ring' (KV rotation, "
                "extreme lengths) or 'ulysses' (head/seq all-to-all, "
                f"plentiful heads); got {context_parallel_mode!r}")
        self.context_parallel_mode = context_parallel_mode
        # Mistral-style local attention (0 = full causal)
        if not isinstance(sliding_window, int) or sliding_window < 0:
            raise ValueError(
                "sliding_window must be a non-negative int (0 = full "
                f"causal), got {sliding_window!r}")
        if sliding_window and context_parallel:
            raise ValueError(
                "sliding_window with context_parallel is unsupported: the "
                "ring/ulysses paths assume full causal attention")
        self.sliding_window = sliding_window
        self.use_parallel_cross_entropy = use_parallel_cross_entropy
        if ce_chunk_size > 0 and use_parallel_cross_entropy:
            raise ValueError(
                "ce_chunk_size requires use_parallel_cross_entropy=False: "
                "the chunked loss consumes the unsharded lm_head weight; "
                "under TP use ParallelCrossEntropy instead (it already "
                "avoids gathering vocab-sharded logits)")
        self.ce_chunk_size = ce_chunk_size
        self.recompute = recompute
        self.dtype = dtype
        self.moe_num_experts = moe_num_experts
        self.moe_top_k = moe_top_k
        self.moe_expert_axis = moe_expert_axis
        self.moe_aux_loss_coeff = moe_aux_loss_coeff

    @classmethod
    def llama2_7b(cls, **kw):
        return cls(hidden_size=4096, intermediate_size=11008,
                   num_hidden_layers=32, num_attention_heads=32, **kw)

    @classmethod
    def tiny(cls, **kw):
        """Test/dry-run config."""
        kw.setdefault("vocab_size", 128)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("num_hidden_layers", 4)
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("max_position_embeddings", 128)
        return cls(**kw)


def _rope(q, k, theta, dtype, pos=None):
    """Rotary position embedding on ``[b, s, h, d]`` q/k, computed in
    fp32 and cast to ``dtype`` — the reference's half-split
    rotate_half pairing ``(x_i, x_{i+d/2})`` rotated by frequency ``i``.
    ``pos`` (``[s]`` or ``[b, s]`` absolute positions) defaults to
    ``arange(s)``; ``k`` may be None."""
    b, s, h, d = q.shape
    if pos is None:
        pos = torch.arange(s, dtype=torch.float32, device=q.device)
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=q.device) / d))
    freqs = pos.to(torch.float32)[..., None] * inv  # [.., s, d/2]
    if freqs.dim() == 2:  # [s, d/2] -> broadcast over batch
        cos = torch.cos(freqs)[None, :, None, :]
        sin = torch.sin(freqs)[None, :, None, :]
    else:  # [b, s, d/2]
        cos = torch.cos(freqs)[:, :, None, :]
        sin = torch.sin(freqs)[:, :, None, :]

    def rot(x):
        half = x.shape[-1] // 2
        x1, x2 = x[..., :half], x[..., half:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        return out.to(dtype)

    if k is None:
        return rot(q.to(torch.float32)), None
    return rot(q.to(torch.float32)), rot(k.to(torch.float32))


class _Weight(nn.Module):
    """One named ``weight`` parameter — the leaf modules of the reference
    (``ColumnParallelLinear``/``RowParallelLinear`` in ``[in, out]``
    layout, ``RMSNorm``, ``VocabParallelEmbedding``) reduced to what the
    decode path reads."""

    def __init__(self, shape, dtype, device):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(shape, dtype=dtype, device=device),
            requires_grad=False)


class LlamaAttention(nn.Module):
    def __init__(self, config, dtype, device):
        super().__init__()
        h = config.hidden_size
        nh = config.num_attention_heads
        nkv = config.num_key_value_heads
        d = h // nh
        self.qkv_proj = _Weight((h, (nh + 2 * nkv) * d), dtype, device)
        self.o_proj = _Weight((nh * d, h), dtype, device)


class LlamaMLP(nn.Module):
    def __init__(self, config, dtype, device):
        super().__init__()
        h, ffn = config.hidden_size, config.intermediate_size
        self.gate_up_proj = _Weight((h, 2 * ffn), dtype, device)
        self.down_proj = _Weight((ffn, h), dtype, device)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config, dtype, device):
        super().__init__()
        h = config.hidden_size
        self.input_layernorm = _Weight((h,), dtype, device)
        self.self_attn = LlamaAttention(config, dtype, device)
        self.post_attention_layernorm = _Weight((h,), dtype, device)
        self.mlp = LlamaMLP(config, dtype, device)


class LlamaModel(nn.Module):
    def __init__(self, config, dtype, device):
        super().__init__()
        self.embed_tokens = _Weight((config.vocab_size, config.hidden_size),
                                    dtype, device)
        self.layers = nn.ModuleList(
            LlamaDecoderLayer(config, dtype, device)
            for _ in range(config.num_hidden_layers))
        self.norm = _Weight((config.hidden_size,), dtype, device)


class LlamaForCausalLM(nn.Module):
    """The causal LM. Weights are drawn from ``generator`` (a
    ``torch.Generator`` on ``device``; a fresh one seeded with 0 when
    None): normal(0, 0.02) for the embedding and projections, ones for
    the RMSNorm scales. :func:`load_jax_weights` replaces them with a
    reference model's."""

    def __init__(self, config: LlamaConfig, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if config.moe_num_experts > 1:
            raise NotImplementedError(
                "the port does not build MoE Llama configs yet (the "
                "reference's generate() and ServingEngine do not decode "
                "them either); ROADMAP queue A lists the MoE layer")
        dev = resolve_device(device)
        dtype = to_torch_dtype(config.dtype)
        self.config = config
        self.llama = LlamaModel(config, dtype, dev)
        self.lm_head = _Weight((config.hidden_size, config.vocab_size),
                               dtype, dev)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("layernorm.weight") \
                        or name == "llama.norm.weight":
                    p.fill_(1.0)
                else:
                    w = torch.empty(p.shape, dtype=torch.float32,
                                    device=dev)
                    w.normal_(0.0, 0.02, generator=generator)
                    p.copy_(w)

    @property
    def model(self) -> LlamaModel:
        """The decoder stack (the reference sets ``self.llama`` and
        ``self.model`` to the same layer)."""
        return self.llama

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    def forward(self, input_ids, labels=None):
        raise NotImplementedError(
            "LlamaForCausalLM.forward (full-sequence training) needs the "
            "flash-attention kernels of the training slice (ROADMAP queue "
            "B, kernels 1-3); decode with models.generation.generate or "
            "serving.ServingEngine")

    def generate(self, input_ids, max_new_tokens=32, **kw):
        """Greedy KV-cache decoding (see ``models/generation.py``)."""
        from .generation import generate as _generate

        return _generate(self, input_ids, max_new_tokens=max_new_tokens,
                         **kw)


def _to_tensor(arr) -> torch.Tensor:
    """A numpy array (bfloat16 from ``ml_dtypes`` included) as a CPU
    tensor with the same bits."""
    arr = np.array(arr)  # a writable copy: from_numpy shares memory
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def load_jax_weights(model: LlamaForCausalLM, arrays) -> None:
    """Fill ``model`` with the reference model's weights, so the two
    packages compute the same function.

    ``arrays`` maps parameter names to numpy arrays, as
    ``{n: np.asarray(p._data) for n, p in jax_model.named_parameters()}``
    gives them (``llama.*`` names; the ``model.*`` alias of the same
    layer is accepted too). Each array is converted to its parameter's
    dtype and device. Raises ``KeyError`` on a missing or unexpected
    name and ``ValueError`` on a shape mismatch, before any parameter is
    written."""
    params = dict(model.named_parameters())
    given = {}
    for name, arr in arrays.items():
        key = "llama." + name[len("model."):] \
            if name.startswith("model.") else name
        if key in given and not np.array_equal(given[key], arr):
            raise ValueError(f"{name!r} and its alias disagree")
        given[key] = arr
    missing = sorted(set(params) - set(given))
    unexpected = sorted(set(given) - set(params))
    if missing or unexpected:
        raise KeyError(f"load_jax_weights: missing {missing}, "
                       f"unexpected {unexpected}")
    for name, p in params.items():
        if tuple(np.shape(given[name])) != tuple(p.shape):
            raise ValueError(
                f"load_jax_weights: {name} has shape "
                f"{tuple(np.shape(given[name]))}, the model expects "
                f"{tuple(p.shape)}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(_to_tensor(given[name]).to(p.dtype))
