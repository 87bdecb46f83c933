"""BERT (encoder) family as ``nn.Module``s.

Counterpart of ``paddle_tpu/models/bert.py``, the BASELINE config-3
workload (BERT-base MLM under AMP O2, ``benchmarks/baseline_configs.py::
bench_bert_mlm``). Parameters carry the JAX model's names
(``bert.embeddings.word_embeddings.weight``,
``bert.encoder.{i}.attention.qkv.weight``, ..., ``decoder_bias``) and
Paddle's ``[in, out]`` linear layout, so :func:`load_jax_weights` fills
the port from the reference model's arrays name by name.

Attention is non-causal through ``F.scaled_dot_product_attention``: a
padded batch's ``attention_mask`` becomes the reference's additive ``[b,
1, 1, s]`` bias, built in ``config.dtype`` (so under bf16 ``-1e4``
rounds to ``-9984`` as in JAX), and with it, or with attention dropout
while training, the call runs the head-batched kernels (kernels 4-6).
Hidden dropout is ``F.dropout`` (a Bernoulli mask per call); attention
dropout is the kernels' counter hash, seeded per call from
``framework.random``. ``model.train()`` / ``model.eval()`` switch both,
as the reference's ``training`` flag does.
"""
from __future__ import annotations

import torch
from torch import nn

from ..distributed.fleet import batch_axes
from ..distributed.shard import local_piece, mark_local
from ..framework.device import resolve_device
from ..framework.dtype import to_torch_dtype
from ..nn import functional as F
from ..tensor.math import matmul as _matmul
from ._weights import load_jax_weights

__all__ = ["BertConfig", "BertEmbeddings", "BertSelfAttention", "BertLayer",
           "BertModel", "BertForMaskedLM", "BertForSequenceClassification",
           "load_jax_weights"]


class BertConfig:
    """Same fields and defaults as the reference's ``BertConfig``
    (BERT-base)."""

    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, hidden_act="gelu",
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 max_position_embeddings=512, type_vocab_size=2,
                 layer_norm_eps=1e-12, pad_token_id=0, dtype="float32"):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        if hidden_act not in ("gelu", "tanh", "silu"):
            raise ValueError(f"hidden_act {hidden_act!r} is not ported")
        self.hidden_act = hidden_act
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.layer_norm_eps = layer_norm_eps
        self.pad_token_id = pad_token_id
        self.dtype = dtype

    @classmethod
    def base(cls, **kw):
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 128)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("max_position_embeddings", 64)
        return cls(**kw)


def _param(shape, device):
    return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                    device=device))


class _Linear(nn.Module):
    """``x @ weight + bias`` with ``weight`` ``[in, out]`` (the
    reference's ``Linear`` and its meta-parallel linears at degree 1);
    ``has_bias=False`` leaves the bias out. The product is ``F.linear``,
    which ``auto_cast`` casts as the op ``linear``: ``Linear`` and
    ``ColumnParallelLinear`` add the bias inside it, ``RowParallelLinear``
    (``row=True``) after it, so that under O1 its output is the fp32 sum
    of the low-precision product and the fp32 bias, as the reference's."""

    def __init__(self, n_in, n_out, device, has_bias=True, row=False):
        super().__init__()
        self.weight = _param((n_in, n_out), device)
        self.bias = _param((n_out,), device) if has_bias else None
        self.row = row

    def forward(self, x):
        if not self.row:
            return F.linear(x, self.weight, self.bias)
        y = F.linear(x, self.weight)
        return y if self.bias is None else y + self.bias


class _LayerNorm(nn.Module):
    def __init__(self, n, epsilon, device):
        super().__init__()
        self.weight = _param((n,), device)
        self.bias = _param((n,), device)
        self.epsilon = epsilon

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1], self.weight, self.bias,
                            self.epsilon)


class _Embedding(nn.Module):
    def __init__(self, n, dim, device):
        super().__init__()
        self.weight = _param((n, dim), device)

    def forward(self, ids):
        return torch.nn.functional.embedding(ids.long(), self.weight)


class BertEmbeddings(nn.Module):
    def __init__(self, config, device):
        super().__init__()
        h = config.hidden_size
        self.config = config
        self.word_embeddings = _Embedding(config.vocab_size, h, device)
        self.position_embeddings = _Embedding(
            config.max_position_embeddings, h, device)
        self.token_type_embeddings = _Embedding(config.type_vocab_size, h,
                                                device)
        self.layer_norm = _LayerNorm(h, config.layer_norm_eps, device)

    def forward(self, input_ids, token_type_ids=None):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)[None, :]
        emb = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is not None:
            emb = emb + self.token_type_embeddings(token_type_ids)
        return F.dropout(self.layer_norm(emb),
                         self.config.hidden_dropout_prob,
                         training=self.training)


class BertSelfAttention(nn.Module):
    def __init__(self, config, device):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = h // self.num_heads
        self.qkv = _Linear(h, 3 * h, device)
        self.out = _Linear(h, h, device, row=True)
        self.dropout_p = config.attention_probs_dropout_prob

    def forward(self, x, attn_mask=None):
        b, s = x.shape[0], x.shape[1]
        # q, k and v stay strided views of the projection: the kernels
        # read [b, s, h, d] through strides
        q, k, v = (t.reshape(b, s, self.num_heads, self.head_dim)
                   for t in torch.chunk(self.qkv(x), 3, dim=-1))
        # each dp rank holds its rows of the batch: attention dropout
        # hashes them at their global rows
        q = mark_local(q, batch_axes(), None, None, None)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask, self.dropout_p, is_causal=False,
            training=self.training)
        return self.out(out.reshape(b, s, self.num_heads * self.head_dim))


class BertLayer(nn.Module):
    def __init__(self, config, device):
        super().__init__()
        h = config.hidden_size
        self.config = config
        self.attention = BertSelfAttention(config, device)
        self.attn_norm = _LayerNorm(h, config.layer_norm_eps, device)
        self.inter = _Linear(h, config.intermediate_size, device)
        self.output = _Linear(config.intermediate_size, h, device,
                              row=True)
        self.out_norm = _LayerNorm(h, config.layer_norm_eps, device)
        self.act = getattr(F, config.hidden_act)

    def _dropout(self, x):
        return F.dropout(x, self.config.hidden_dropout_prob,
                         training=self.training)

    def forward(self, x, attn_mask=None):
        a = self.attn_norm(x + self._dropout(self.attention(x, attn_mask)))
        f = self.output(self.act(self.inter(a)))
        return self.out_norm(a + self._dropout(f))


class BertModel(nn.Module):
    """The encoder with its pooler (PaddleNLP's ``BertModel`` shape)."""

    def __init__(self, config, device):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config, device)
        self.encoder = nn.ModuleList(BertLayer(config, device)
                                     for _ in range(config.num_hidden_layers))
        self.pooler = _Linear(config.hidden_size, config.hidden_size, device)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """Returns (hidden ``[b, s, h]``, pooled ``[b, h]``).
        ``attention_mask`` ``[b, s]`` (1 keep, 0 pad) becomes the additive
        ``(mask - 1) * 1e4`` ``[b, 1, 1, s]`` in ``config.dtype``."""
        mask_bias = None
        if attention_mask is not None:
            m = attention_mask.to(to_torch_dtype(self.config.dtype))
            mask_bias = (m[:, None, None, :] - 1.0) * 1e4
        x = self.embeddings(input_ids, token_type_ids)
        for blk in self.encoder:
            x = blk(x, mask_bias)
        pooled = F.tanh(self.pooler(x[:, 0]))
        return x, pooled


def _init_weights(module, generator, device):
    """normal(0, 0.02) for matrices and embeddings, zeros for biases,
    ones for the LayerNorm scales, drawn in fp32 from ``generator``; a
    tensor-parallel parameter is drawn on its global shape and cut to
    this rank's piece, so every mp degree builds the same model."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif "norm." in name:
                p.fill_(1.0)
            else:
                layout = getattr(p, "_dist_layout", None)
                w = torch.empty(p.shape if layout is None else layout.shape,
                                dtype=torch.float32, device=device)
                w.normal_(0.0, 0.02, generator=generator)
                p.copy_(w if layout is None else local_piece(w, layout))


class _BertHead(nn.Module):
    """Shared constructor: the device, the encoder and the seeded
    weights. Parameters are fp32, as the reference creates them;
    ``amp.decorate(level="O2")`` casts them."""

    def _build(self, config, device):
        dev = resolve_device(device)
        self.config = config
        self.bert = BertModel(config, dev)
        return dev

    def _init(self, dev, generator):
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        _init_weights(self, generator, dev)

    @property
    def device(self) -> torch.device:
        return self.bert.pooler.weight.device


class BertForMaskedLM(_BertHead):
    """The MLM head tied to the word embedding (the benchmark's model):
    ``transform`` -> GELU -> ``transform_norm`` -> ``h @ E^T +
    decoder_bias``. Weights are drawn from ``generator`` (a
    ``torch.Generator`` on ``device``; one seeded with 0 when None)."""

    def __init__(self, config: BertConfig, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = self._build(config, device)
        self.decoder_bias = _param((config.vocab_size,), dev)
        self.transform = _Linear(config.hidden_size, config.hidden_size, dev)
        self.transform_norm = _LayerNorm(config.hidden_size,
                                         config.layer_norm_eps, dev)
        self._init(dev, generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None, ignore_index=-100):
        """Logits ``[b, s, vocab]`` in the parameters' dtype, or, given
        ``labels`` (``ignore_index`` = not predicted), the mean fp32
        cross-entropy over the predicted tokens."""
        hidden, _ = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.transform_norm(F.gelu(self.transform(hidden)))
        # the tied decoder is the reference's matmul (white under auto_cast)
        logits = _matmul(h, self.bert.embeddings.word_embeddings.weight,
                         transpose_y=True) + self.decoder_bias
        if labels is None:
            return logits
        return F.cross_entropy(
            logits.to(torch.float32).reshape(-1, self.config.vocab_size),
            labels.reshape(-1, 1), ignore_index=ignore_index,
            reduction="mean")

    def flops_per_token(self, seq_len):
        """Training FLOPs per token as ``bench_bert_mlm`` counts them
        (``baseline_configs.py:149-150``): 6 x every parameter plus 12 x
        seq x hidden per layer for the attention products."""
        cfg = self.config
        n_params = sum(p.numel() for p in self.parameters())
        return 6 * n_params \
            + cfg.num_hidden_layers * 12 * seq_len * cfg.hidden_size


class BertForSequenceClassification(_BertHead):
    """The pooled output through dropout and a ``[hidden, num_classes]``
    classifier."""

    def __init__(self, config: BertConfig, num_classes=2, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = self._build(config, device)
        self.classifier = _Linear(config.hidden_size, num_classes, dev)
        self._init(dev, generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(F.dropout(
            pooled, self.config.hidden_dropout_prob, training=self.training))
