"""Llama-family causal LM as an ``nn.Module``.

Counterpart of ``paddle_tpu/models/llama.py``. Parameters carry the JAX
model's names (``llama.embed_tokens.weight``,
``llama.layers.{i}.self_attn.qkv_proj.weight``, ..., ``lm_head.weight``)
and Paddle's ``[in, out]`` weight layout, so :func:`load_jax_weights`
can fill the port from the reference model's arrays one name at a time.

Two paths read the same trainable parameters: the full-sequence
``forward`` (training: logits, or the loss given labels), whose
attention runs through the flash-attention kernels (or ring or Ulysses
attention over ``sep`` with ``context_parallel``), and the decode path
(``models/generation.py``, ``serving/engine.py``), which reads the
stacked weights through ``generation._collect_params`` under
``no_grad``. ``LlamaForCausalLMPipe`` is the same model as a
``PipelineLayer``, its layers split over pipeline stages.
"""
from __future__ import annotations

import torch
from torch import nn

from ..distributed import _comm
from ..distributed.fleet import batch_axes, get_hcg
from ..distributed.fleet.meta_parallel.parallel_layers.pp_layers import (
    LayerDesc, PipelineLayer,
)
from ..distributed.fleet.meta_parallel.parallel_layers.mp_layers import (
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding, _axis_group, check_even, masked_token_mean,
    rank_heads,
)
from ..distributed.fleet.utils.sequence_parallel_utils import (
    ColumnSequenceParallelLinear, GatherOp, RowSequenceParallelLinear,
    ScatterOp, mark_as_sequence_parallel_parameter,
)
from ..distributed.shard import local_piece
from ..framework.device import resolve_device
from ..framework.dtype import to_torch_dtype
from ..incubate.distributed.models.moe import MoELayer
from ..nn import functional as F
from ..nn.functional.loss import chunked_ce_over
from ._weights import load_jax_weights

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "LlamaForCausalLMPipe", "to_pipe_layout", "from_pipe_layout",
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
    """One named trainable ``weight``: the reference's ``RMSNorm``
    leaves, replicated over every axis."""

    def __init__(self, shape, dtype, device):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(shape, dtype=dtype, device=device))


class _Parallel:
    """What the layers need of the hybrid topology: the ``mp`` degree,
    this rank's place on it and its group (1, 0, None without a hybrid
    group), whether the sequence is sharded over mp (SP), and under
    ``context_parallel`` the ``sep`` degree and this rank's place on it
    (``cp_n``, ``cp_rank``) and the group the batch is split over, dp
    and sep, and over sharding as well under sharding > 1
    (``batch_group``; None: dp's). Under MoE, ``seq_axis`` names the
    axis the MoE layers' input sequence is split over (mp under SP, sep
    under context parallelism, ``("sep", "mp")`` under both: SP splits
    a rank's sequence chunk further over mp; None); the groups the
    layers need (the experts' axis, the batch axes, the sequence axes
    and both) are made here, where every rank runs in one order (a
    pipeline stage builds only its own layers). Under SP ``seq_len`` is
    the length of the sequence the embedding scatters over mp (the
    rank's chunk under context parallelism), set by each forward
    (:func:`_scatter_sequence`, the pipe's ``note_batch``): when mp does
    not divide it, the sequence is padded at its end to a multiple of
    mp, and the padding is trimmed after the final gather and kept out
    of the MoE gate."""

    def __init__(self, config):
        self.n, self.rank, self.group = _axis_group("mp")
        self.sp = bool(config.sequence_parallel) and self.n > 1
        self.seq_len = None
        self.cp_n, self.cp_rank, _ = _axis_group("sep") \
            if config.context_parallel else (1, 0, None)
        self.batch_group = None
        axes = batch_axes(config)
        if axes != ("dp",):
            from ..distributed import env as env_mod

            self.batch_group = env_mod.ensure_env().group(axes)
        moe = config.moe_num_experts > 1
        self.seq_axis = None
        if moe and (self.sp or self.cp_n > 1):
            axes = ("sep",) * (self.cp_n > 1) + ("mp",) * self.sp
            self.seq_axis = axes if len(axes) > 1 else axes[0]
        if moe and get_hcg() is not None:
            from ..distributed import env as env_mod
            from ..incubate.distributed.models.moe.moe_layer import (
                layer_groups,
            )

            env = env_mod.ensure_env()
            for group in layer_groups(config.moe_expert_axis, self.seq_axis):
                env.group(group)

    def leaf(self, kind, *args, **kw):
        """A column (``"col"``) or row (``"row"``) parallel linear, the
        sequence-parallel one under SP, bias-free and unset."""
        cls = {("col", False): ColumnParallelLinear,
               ("col", True): ColumnSequenceParallelLinear,
               ("row", False): RowParallelLinear,
               ("row", True): RowSequenceParallelLinear}[(kind, self.sp)]
        extra = {"gather_output": False} if kind == "col" \
            else {"input_is_parallel": True}
        return cls(*args, has_bias=False, generator=False, **extra, **kw)

    def norm_weight(self, norm):
        """An RMSNorm's weight as the forward reads it: under SP it meets
        sequence shards, so its gradient is summed over ``mp``."""
        return _comm.copy_to(norm.weight, self.group) if self.sp \
            else norm.weight


def _check_even(config, n):
    """The parameter dims mp must divide, as the reference's: the vocab,
    the FFN width and the flat attention widths (the heads themselves
    need not divide: a rank takes whole heads, the first ranks one
    more)."""
    nh, nkv = config.num_attention_heads, config.num_key_value_heads
    d = config.hidden_size // nh
    check_even(n, (("vocab_size", config.vocab_size),
                   ("intermediate_size", config.intermediate_size),
                   ("the flat attention width num_attention_heads * "
                    "head_dim", nh * d),
                   ("the fused qkv width (num_attention_heads + 2 * "
                    "num_key_value_heads) * head_dim", (nh + 2 * nkv) * d)))


class LlamaAttention(nn.Module):
    def __init__(self, config, dtype, device, par):
        super().__init__()
        self.config = config
        self._par = par
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = h // self.num_heads
        d, nh, nkv, n = (self.head_dim, self.num_heads, self.num_kv_heads,
                         par.n)
        # this rank's whole heads (the first nh % n ranks one more; a rank
        # may hold none); K and V are replicated (and repeated per q head,
        # as in the reference) when mp does not divide their heads
        self._nh, q0 = rank_heads(nh, n, par.rank)
        kv_sharded = nkv % n == 0
        self._nkv = nkv // n if kv_sharded else nkv
        rep = nh // nkv
        self.register_buffer("_kv_index", None if kv_sharded else torch.tensor(
            [(q0 + i) // rep for i in range(self._nh)], dtype=torch.int64,
            device=device), persistent=False)  # each local q head's kv head
        self.qkv_proj = par.leaf(
            "col", h, (nh + 2 * nkv) * d, dtype=dtype, device=device,
            out_segments=((nh * d, True, d), (nkv * d, kv_sharded, d),
                          (nkv * d, kv_sharded, d)))
        self.o_proj = par.leaf("row", nh * d, h, dtype=dtype, device=device,
                               in_unit=d)

    def forward(self, x):
        cfg = self.config
        d = self.head_dim
        qkv = self.qkv_proj(x)
        b, s = qkv.shape[0], qkv.shape[1]  # the whole sequence under SP
        q, k, v = torch.split(
            qkv, [self._nh * d, self._nkv * d, self._nkv * d], dim=-1)
        if self._nh == 0:
            # a rank without heads adds nothing to o_proj's sum (its
            # weight's piece is [0, hidden]); no attention runs
            return self.o_proj(q)
        # under SP a sequence mp does not divide arrives padded at its
        # end (_scatter_sequence): the padding is neither query nor key
        par = self._par
        pad = s - par.seq_len if par.sp and par.seq_len is not None else 0
        if pad:
            s = par.seq_len
            q, k, v = q[:, :s], k[:, :s], v[:, :s]
        # RoPE returns the projection's dtype (low under auto_cast O1,
        # where x, the fp32 RMSNorm output, is not). Under context
        # parallelism this rank holds chunk cp_rank of the sequence: its
        # tokens sit at global positions cp_rank * s + arange(s)
        pos = None
        if par.cp_n > 1:
            pos = torch.arange(s, device=q.device) + par.cp_rank * s
        q, k = _rope(q.reshape(b, s, self._nh, d),
                     k.reshape(b, s, self._nkv, d), cfg.rope_theta,
                     q.dtype, pos=pos)
        # v stays a strided view of the projection: the kernels read
        # [b, s, h, d] through strides. GQA runs in the kernels, which
        # map each q head to its kv head without repeating K/V.
        v = v.reshape(b, s, self._nkv, d)
        if self._kv_index is not None:
            k = k.index_select(2, self._kv_index)
            v = v.index_select(2, self._kv_index)
        if cfg.context_parallel:
            # the reference repeats KV under context parallelism (Ulysses
            # needs equal head counts), then runs ring or Ulysses over sep
            if k.shape[2] != self._nh:
                rep = self._nh // k.shape[2]
                k = k.repeat_interleave(rep, dim=2)
                v = v.repeat_interleave(rep, dim=2)
            attend = F.ulysses_attention \
                if cfg.context_parallel_mode == "ulysses" \
                else F.ring_flash_attention
            out = attend(q, k, v, axis="sep", causal=True)
        elif cfg.sliding_window > 0:
            out = F.sliding_window_attention(q, k, v, cfg.sliding_window)
        else:
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        out = out.reshape(b, s, self._nh * d)
        if pad:
            out = torch.nn.functional.pad(out, (0, 0, 0, pad))
        return self.o_proj(out)


class LlamaMLP(nn.Module):
    def __init__(self, config, dtype, device, par):
        super().__init__()
        h, ffn = config.hidden_size, config.intermediate_size
        self.gate_up_proj = par.leaf(
            "col", h, 2 * ffn, dtype=dtype, device=device,
            out_segments=((ffn, True), (ffn, True)))
        self.down_proj = par.leaf("row", ffn, h, dtype=dtype, device=device)

    def forward(self, x):
        gate, up = torch.chunk(self.gate_up_proj(x), 2, dim=-1)
        return self.down_proj(F.silu(gate) * up)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config, dtype, device, par):
        super().__init__()
        self.config = config
        h = config.hidden_size
        self._par = par
        self.input_layernorm = _Weight((h,), dtype, device)
        self.self_attn = LlamaAttention(config, dtype, device, par)
        self.post_attention_layernorm = _Weight((h,), dtype, device)
        if config.moe_num_experts > 1:
            self.mlp = MoELayer(
                h, config.intermediate_size, config.moe_num_experts,
                top_k=config.moe_top_k, activation="silu",
                expert_axis=config.moe_expert_axis,
                sequence_axis=par.seq_axis, dtype=dtype, device=device,
                generator=False)
        else:
            self.mlp = LlamaMLP(config, dtype, device, par)
        if par.sp:
            for norm in (self.input_layernorm,
                         self.post_attention_layernorm):
                mark_as_sequence_parallel_parameter(norm.weight)

    def forward(self, x):
        # under SP x is this rank's sequence chunk: the projections
        # gather it and scatter their output back
        eps, par = self.config.rms_norm_eps, self._par
        h = x + self.self_attn(
            F.rms_norm(x, par.norm_weight(self.input_layernorm), eps))
        y = F.rms_norm(h, par.norm_weight(self.post_attention_layernorm),
                       eps)
        if isinstance(self.mlp, MoELayer) and par.sp:
            # the padding of a sequence mp does not divide stays out of
            # the gate
            return h + self.mlp(y, seq_len=par.seq_len)
        return h + self.mlp(y)


class LlamaModel(nn.Module):
    def __init__(self, config, dtype, device, par):
        super().__init__()
        self.config = config
        self._par = par
        self.embed_tokens = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, dtype=dtype,
            device=device, generator=False)
        self.layers = nn.ModuleList(
            LlamaDecoderLayer(config, dtype, device, par)
            for _ in range(config.num_hidden_layers))
        self.norm = _Weight((config.hidden_size,), dtype, device)
        if par.sp:
            mark_as_sequence_parallel_parameter(self.norm.weight)

    def forward(self, input_ids):
        par = self._par
        x = _scatter_sequence(self.embed_tokens(input_ids).to(
            to_torch_dtype(self.config.dtype)), par)
        for blk in self.layers:
            x = blk(x)
        x = F.rms_norm(x, par.norm_weight(self.norm), self.config.rms_norm_eps)
        return _gather_sequence(x, par)


def _scatter_sequence(x, par):
    """Under SP, this rank's chunk of the sequence of ``x`` ``[b, s, h]``
    (a rank's sep chunk under context parallelism), padded at its end
    with zero rows to a multiple of mp when mp does not divide ``s``
    (``s`` recorded as ``par.seq_len``: the attention and the MoE gate
    leave the padding out); else ``x``."""
    if not par.sp:
        return x
    s = x.shape[1]
    par.seq_len = s
    pad = -s % par.n
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    return ScatterOp.apply(x, par.group)


def _gather_sequence(x, par):
    """Under SP the whole sequence from the ranks' chunks, the padding of
    :func:`_scatter_sequence` trimmed; else ``x``."""
    if not par.sp:
        return x
    x = GatherOp.apply(x, par.group)
    if par.seq_len is not None and par.seq_len < x.shape[1]:
        x = x[:, :par.seq_len]
    return x


def _init_weights(module, generator, dev):
    """normal(0, 0.02) for the embedding and projections, drawn in fp32
    on each parameter's global shape and cut to this rank's piece, and
    ones for the RMSNorm scales, in ``named_parameters`` order."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
                continue
            layout = getattr(p, "_dist_layout", None)
            w = torch.empty(p.shape if layout is None else layout.shape,
                            dtype=torch.float32, device=dev)
            w.normal_(0.0, 0.02, generator=generator)
            p.copy_(w if layout is None else local_piece(w, layout))


def _token_loss(ce, logits, labels, count=None, group=None):
    """The causal LM's loss: fp32 logits into ``ce`` (a
    ``ParallelCrossEntropy``) or, when None, ``F.cross_entropy``, then
    ``masked_token_mean`` (its ``count`` and ``group``)."""
    labels = labels.long()
    if ce is not None:
        loss = ce(logits.to(torch.float32), labels)
        ignore = ce.ignore_index
    else:
        loss = F.cross_entropy(logits.to(torch.float32),
                               labels.unsqueeze(-1), reduction="none")
        ignore = -100
    return masked_token_mean(loss, labels, ignore, count=count, group=group)


class LlamaForCausalLM(nn.Module):
    """The causal LM. Weights are drawn from ``generator`` (a
    ``torch.Generator`` on ``device``; a fresh one seeded with 0 when
    None): normal(0, 0.02) for the embedding and projections, ones for
    the RMSNorm scales. :func:`load_jax_weights` replaces them with a
    reference model's (the ``model.*`` alias of ``llama.*`` included).

    Under a hybrid group with mp > 1 (``fleet.init``) each rank holds
    its shards (``fleet``'s tensor-parallel layers): the vocab rows of
    the embedding, the heads of ``qkv_proj`` and ``o_proj`` (K and V
    replicated, each q head reading its kv head, where mp does not divide
    ``num_key_value_heads``, as the reference repeats them), the columns
    of ``gate_up_proj`` and the rows of ``down_proj``, and the LM head's
    vocab columns; random weights are drawn on the global shapes and
    cut, so every degree builds the same model from one generator. With
    ``sequence_parallel`` the residual stream between the projections
    holds this rank's sequence chunk (Megatron SP: scattered after the
    embedding, all-gathered into ``qkv_proj`` and ``gate_up_proj``,
    reduce-scattered out of ``o_proj`` and ``down_proj``, gathered
    before the LM head), and the norms' gradients are summed over
    ``mp`` in the backward. At mp 1 the model runs the single-card ops
    and no collective.

    With ``context_parallel`` under sep > 1 each rank takes its chunk
    of the sequence (``[b, s/n]`` ids and labels, chunks in sep order):
    RoPE rotates by the chunk's global positions, K and V are repeated
    to the query heads, attention is ring or Ulysses over ``sep``
    (``context_parallel_mode``), and the loss divides by the count over
    dp and sep (``fleet.distributed_model`` then sums the gradients over
    both). At sep 1 it is the plain model, op for op. With
    ``sequence_parallel`` as well, SP splits the rank's chunk further
    over mp (the residual stream ``[b, s / (sep mp), h]``): the
    column-parallel projections gather the chunk over mp, ring or
    Ulysses runs over sep on the rank's ``nh / mp`` heads, and the
    row-parallel ones reduce-scatter back over mp; under MoE the gate
    counts over the sequence split ``(sep, mp)``.

    With ``moe_num_experts > 1`` each layer's MLP is a ``MoELayer``
    (SiLU experts, the config's ``moe_top_k``; each rank holds its share
    of the experts over ``moe_expert_axis``: dp, sharding, sep or mp, or a
    tuple of them such as ``("sep", "mp")`` under SP; and the
    gate counts the tokens of every batch rank, dp x sharding) and the
    loss adds
    ``moe_aux_loss_coeff`` times the layers' aux losses, as the
    reference's ``_add_moe_aux`` does; ``generate()`` and the serving
    engine refuse such a model, as the reference's do."""

    _jax_aliases = (("model.", "llama."),)

    def __init__(self, config: LlamaConfig, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        dtype = to_torch_dtype(config.dtype)
        self.config = config
        par = _Parallel(config)
        if par.n > 1:
            _check_even(config, par.n)
        self._par = par
        self.llama = LlamaModel(config, dtype, dev, par)
        self.lm_head = ColumnParallelLinear(
            config.hidden_size, config.vocab_size, has_bias=False,
            gather_output=not config.use_parallel_cross_entropy,
            dtype=dtype, device=dev, generator=False)
        self.loss_fn = (ParallelCrossEntropy()
                        if config.use_parallel_cross_entropy else None)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        _init_weights(self, generator, dev)

    @property
    def model(self) -> LlamaModel:
        """The decoder stack (the reference sets ``self.llama`` and
        ``self.model`` to the same layer)."""
        return self.llama

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    def forward(self, input_ids, labels=None):
        """``input_ids`` ``[b, s]`` -> logits ``[b, s, vocab]`` in the
        model's dtype, or, given ``labels`` ``[b, s]`` (``-100`` =
        ignored), the fp32 mean loss over the non-ignored tokens: fp32
        logits into ``ParallelCrossEntropy`` or
        ``F.cross_entropy``, then ``masked_token_mean``. With
        ``ce_chunk_size > 0`` (and ``use_parallel_cross_entropy=False``)
        the LM head and the loss run together over vocab chunks
        (``chunked_ce_over``, ``F.chunked_softmax_cross_entropy`` over
        the mp group): the full logits never exist; under mp each rank
        runs its vocab columns of the head's shard and the loss takes
        one MAX and two SUM all-reduces (the head is never gathered).
        The products go through ``F.linear`` (white under
        ``amp.auto_cast``)."""
        cfg = self.config
        group = self._par.batch_group
        hidden = self.model(input_ids)
        if labels is not None and self.loss_fn is None \
                and cfg.ce_chunk_size > 0:
            per_tok = chunked_ce_over(
                hidden, self.lm_head.weight, labels, cfg.ce_chunk_size,
                self._par.group)
            return self._add_moe_aux(
                masked_token_mean(per_tok, labels, -100, group=group))
        logits = self.lm_head(hidden)
        if labels is None:
            return logits
        return self._add_moe_aux(
            _token_loss(self.loss_fn, logits, labels, group=group))

    def _add_moe_aux(self, loss):
        """The loss plus ``moe_aux_loss_coeff`` times the sum of the MoE
        layers' aux losses (each taken off its layer), under MoE."""
        if self.config.moe_num_experts <= 1:
            return loss
        aux = None
        for blk in self.model.layers:
            a = blk.mlp.aux_loss
            if a is not None:
                aux = a if aux is None else aux + a
                blk.mlp.aux_loss = None
        if aux is not None:
            loss = loss + self.config.moe_aux_loss_coeff * aux
        return loss

    def flops_per_token(self, seq_len):
        """Approximate training FLOPs per token (forward and backward,
        the 6 included) for MFU accounting — the reference's count."""
        cfg = self.config
        n_params = (
            cfg.vocab_size * cfg.hidden_size * 2
            + cfg.num_hidden_layers * (
                cfg.hidden_size * (cfg.num_attention_heads
                                   + 2 * cfg.num_key_value_heads)
                * (cfg.hidden_size // cfg.num_attention_heads)
                + cfg.hidden_size * cfg.hidden_size
                + 3 * cfg.hidden_size * cfg.intermediate_size
            )
        )
        attn = cfg.num_hidden_layers * 2 * cfg.hidden_size * seq_len
        return 6 * (n_params + attn)

    def generate(self, input_ids, max_new_tokens=32, **kw):
        """Greedy KV-cache decoding (see ``models/generation.py``)."""
        from .generation import generate as _generate

        return _generate(self, input_ids, max_new_tokens=max_new_tokens,
                         **kw)


# -- the pipeline form ----------------------------------------------------------

class _EmbeddingStage(nn.Module):
    """The pipe's first layer: the (vocab-parallel) embedding, cast to
    the config's dtype; under SP this rank's chunk of the sequence, as
    ``LlamaModel`` scatters it."""

    def __init__(self, config, dtype, device, par):
        super().__init__()
        self.config = config
        self._par = par
        self.embed_tokens = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, dtype=dtype,
            device=device, generator=False)

    def forward(self, input_ids):
        return _scatter_sequence(self.embed_tokens(input_ids).to(
            to_torch_dtype(self.config.dtype)), self._par)


class _HeadStage(nn.Module):
    """The pipe's last layer: the final RMSNorm (under SP on this rank's
    sequence chunk, its weight's gradient summed over mp) and the
    (column-parallel) LM head on the whole sequence."""

    def __init__(self, config, dtype, device, par):
        super().__init__()
        self.config = config
        self._par = par
        self.norm = _Weight((config.hidden_size,), dtype, device)
        if par.sp:
            mark_as_sequence_parallel_parameter(self.norm.weight)
        self.lm_head = ColumnParallelLinear(
            config.hidden_size, config.vocab_size, has_bias=False,
            gather_output=not config.use_parallel_cross_entropy,
            dtype=dtype, device=device, generator=False)

    def forward(self, x):
        par = self._par
        x = F.rms_norm(x, par.norm_weight(self.norm), self.config.rms_norm_eps)
        return self.lm_head(_gather_sequence(x, par))


class _PipeLoss:
    """The pipe's ``loss_fn(logits, labels, count=None)``: the causal
    LM's loss (``LlamaForCausalLM``'s ops), divided by ``count`` when the
    pipeline gives the whole batch's, its value summed over the batch
    group (dp, and sep under context parallelism); ``token_count(labels)``
    counts a microbatch's labels."""

    def __init__(self, config, par):
        self.ce = ParallelCrossEntropy() \
            if config.use_parallel_cross_entropy else None
        self.ignore_index = -100 if self.ce is None \
            else self.ce.ignore_index
        self.group = par.batch_group

    def token_count(self, labels):
        return (labels != self.ignore_index).sum()

    def __call__(self, logits, labels, count=None):
        return _token_loss(self.ce, logits, labels, count=count,
                           group=self.group)


class LlamaForCausalLMPipe(PipelineLayer):
    """The pipeline-parallel Llama (the reference's
    ``LlamaForCausalLMPipe``): ``_EmbeddingStage``, the decoder layers
    (the repeated blocks, split over the stages) and ``_HeadStage`` as
    :class:`~..distributed.fleet.meta_parallel.LayerDesc`\\ s, with the
    causal LM's loss as ``loss_fn``; under mp > 1 each layer holds its
    tensor-parallel pieces, as in ``LlamaForCausalLM``. Canonical keys
    (``state_dict``): ``0.embed_tokens.weight``, ``{i + 1}.<decoder
    layer i's names>``, ``{L + 1}.norm.weight`` and ``{L +
    1}.lm_head.weight``; :func:`to_pipe_layout` maps the causal LM's
    names to them. Each layer's weights are drawn as
    ``LlamaForCausalLM``'s are, from a generator seeded ``seed +
    <index>``, so every stage layout builds the same model.

    With ``sequence_parallel`` under mp > 1 the embedding stage scatters
    the sequence over mp, the decoder layers run on its chunks (what
    crosses between stages is ``[mb, s / mp, h]``) and the head stage
    gathers it after the final norm, as ``LlamaForCausalLM`` does. With
    ``context_parallel`` under sep > 1 each rank is fed its sequence
    chunk of every microbatch's ids and labels (``[b, s / sep]``, chunks
    in sep order), attention is ring or Ulysses over sep, and the loss
    divides by the count over dp and sep, whose ranks' gradients
    ``PipelineParallel`` sums. Under MoE the experts lie over
    ``moe_expert_axis`` and the gate is global over the microbatch,
    under SP and context parallelism too (``MoELayer``'s
    ``sequence_axis``); the pipe adds no aux loss: the reference's pipe
    does not surface it either (its "Known limitation")."""

    def __init__(self, config: LlamaConfig, *, device="cuda", seed=0,
                 **kwargs):
        dev = resolve_device(device)
        dtype = to_torch_dtype(config.dtype)
        par = _Parallel(config)
        if par.n > 1:
            _check_even(config, par.n)
        layer = (config, dtype, dev, par)
        descs = ([LayerDesc(_EmbeddingStage, *layer)]
                 + [LayerDesc(LlamaDecoderLayer, *layer)
                    for _ in range(config.num_hidden_layers)]
                 + [LayerDesc(_HeadStage, *layer)])
        super().__init__(layers=descs, loss_fn=_PipeLoss(config, par),
                         recompute_interval=1 if config.recompute else 0,
                         **kwargs)
        self.config = config
        self._par = par
        for idx, module in self.named_children():
            _init_weights(module, torch.Generator(device=dev).manual_seed(
                seed + int(idx)), dev)

    def note_batch(self, input_ids):
        """Called by ``PipelineParallel`` on every stage with the batch's
        ids: under SP each stage learns the sequence length, so that a
        sequence mp does not divide is padded, trimmed and kept out of
        the MoE gate alike on every stage."""
        if self._par.sp:
            self._par.seq_len = input_ids.shape[1]


def to_pipe_layout(arrays, num_hidden_layers):
    """``LlamaForCausalLM``'s parameters by name (``llama.*`` or
    ``model.*``, ``lm_head.weight``) under ``LlamaForCausalLMPipe``'s
    canonical keys."""
    last = num_hidden_layers + 1
    out = {}
    for name, a in arrays.items():
        rest = name.split(".", 1)[1] if name.startswith(("llama.", "model.")) \
            else name
        if rest.startswith("layers."):
            i, leaf = rest[len("layers."):].split(".", 1)
            out[f"{int(i) + 1}.{leaf}"] = a
        elif rest == "embed_tokens.weight":
            out["0." + rest] = a
        elif rest in ("norm.weight", "lm_head.weight"):
            out[f"{last}.{rest}"] = a
        else:
            raise KeyError(f"{name} is no parameter of the Llama")
    return out


def from_pipe_layout(arrays, num_hidden_layers):
    """The inverse of :func:`to_pipe_layout` (``llama.*`` names)."""
    last = num_hidden_layers + 1
    out = {}
    for key, a in arrays.items():
        idx, leaf = key.split(".", 1)
        idx = int(idx)
        if idx == 0:
            out["llama." + leaf] = a
        elif idx == last:
            out[leaf if leaf == "lm_head.weight" else "llama." + leaf] = a
        else:
            out[f"llama.layers.{idx - 1}.{leaf}"] = a
    return out
