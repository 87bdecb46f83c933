"""ERNIE 3.0 as ``nn.Module``s: joint pretraining and fine-tuning.

Counterpart of ``paddle_tpu/models/ernie.py`` (BASELINE config 5,
ERNIE-3.0 10B; ``benchmarks/ernie_bench.py`` drives it). A large
*universal representation* trunk is shared by two small task branches:
the NLU branch reads the trunk run bidirectionally, the NLG branch
reads the same trunk run causally. The trunk therefore runs twice a
step with one set of parameters: gradients from both passes sum into
it, and activations of both passes are held for the backward.
Pretraining is joint: masked LM on the NLU branch plus next-token LM on
the NLG branch, each an fp32 cross-entropy averaged over its predicted
tokens (``masked_token_mean``).

Parameters carry the reference's names (``ernie.encoder.{i}.attention.
qkv.weight``, ``ernie.nlu_branch.layer.{i}.inter.bias``,
``mlm_head.decoder.bias``, ``lm_head.weight``, ...) and Paddle's ``[in,
out]`` linear layout, so :func:`load_jax_weights` fills the port from
the reference's arrays name by name. The reference registers
``encoder.{i}`` and ``layer.{i}`` with ``add_sublayer``; here they are
``nn.ModuleList`` s named ``encoder`` and ``layer``, which give the same
names.

Under ``fleet.init`` with mp > 1 the layers are tensor-parallel where
the reference's are (``fleet``'s mp layers): the word embedding's vocab
rows, each block's fused ``qkv`` (q, k and v heads cut one by one) and
``inter`` column-parallel with ``out`` and ``output`` row-parallel, and
the vocab projections (``mlm_head.decoder``, ``lm_head``, the pipe's
NLG head) column-parallel with their logits gathered. Weights are drawn
on their global shapes and cut, so every mp and pp layout builds the
same model; a dim that mp does not divide raises ``ValueError``.

Every attention call goes through ``F.scaled_dot_product_attention``
with ``is_causal`` set by the pass (NLG) or the branch (NLG branch), so
the port's routing decides the kernels: with attention dropout while
training, or with an ``attention_mask``, the head-batched kernels 4-6
(causal for NLG, bidirectional for NLU); with neither (eval without a
mask) the flash kernels 1-3. The mask becomes the additive ``(mask - 1)
* 1e4`` ``[b, 1, 1, s]`` in ``config.dtype``, as in BERT. The pipeline
form, ``ErnieForPretrainingPipe``, runs one task's trunk and branch
over ``PipelineLayer``'s stages; it takes no mask, so without dropout
its attention runs on kernels 1-3.
"""
from __future__ import annotations

import torch
from torch import nn

from ..distributed.fleet import batch_axes
from ..distributed.fleet.meta_parallel.parallel_layers.mp_layers import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    _axis_group, check_even, masked_token_mean, rank_heads,
)
from ..distributed.fleet.meta_parallel.parallel_layers.pp_layers import (
    LayerDesc, PipelineLayer,
)
from ..distributed.shard import mark_local
from ..framework.device import resolve_device
from ..framework.dtype import to_torch_dtype
from ..nn import functional as F
from ._weights import load_jax_weights
from .bert import _Embedding, _init_weights, _LayerNorm, _Linear

__all__ = ["ErnieConfig", "ErnieEmbeddings", "ErnieSelfAttention",
           "ErnieBlock", "ErnieTrunkBlock", "ErnieTaskBranch", "ErnieModel",
           "ErnieForPretraining", "ErnieForSequenceClassification",
           "ErnieForPretrainingPipe", "load_jax_weights"]


class ErnieConfig:
    """Same fields and defaults as the reference's ``ErnieConfig``: the
    ERNIE-3.0 10B widths (trunk 48 x 4096 with 64 heads and ffn 16384,
    task branches 12 x 768 with 12 heads and ffn 3072)."""

    def __init__(self, vocab_size=40000, hidden_size=4096,
                 num_hidden_layers=48, num_attention_heads=64,
                 intermediate_size=16384,
                 task_hidden_size=768, num_task_layers=12,
                 num_task_attention_heads=12, task_intermediate_size=3072,
                 hidden_act="gelu", hidden_dropout_prob=0.1,
                 attention_probs_dropout_prob=0.1,
                 max_position_embeddings=2048, type_vocab_size=4,
                 layer_norm_eps=1e-12, pad_token_id=0, dtype="float32",
                 recompute=False):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.task_hidden_size = task_hidden_size
        self.num_task_layers = num_task_layers
        self.num_task_attention_heads = num_task_attention_heads
        self.task_intermediate_size = task_intermediate_size
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
        # read only by the pipeline form, as in the reference
        self.recompute = recompute

    @classmethod
    def ernie3_10b(cls, **kw):
        """The 10B config of the ERNIE 3.0 paper (the defaults)."""
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 128)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("num_hidden_layers", 4)
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("task_hidden_size", 32)
        kw.setdefault("num_task_layers", 2)
        kw.setdefault("num_task_attention_heads", 2)
        kw.setdefault("task_intermediate_size", 64)
        kw.setdefault("max_position_embeddings", 64)
        return cls(**kw)


def _col(n_in, n_out, device, has_bias=True, segments=1, unit=1):
    """A column-parallel linear whose output stays sharded (its
    ``segments`` equal parts, a fused projection, cut one by one, in
    whole units of ``unit``: a head's columns)."""
    return ColumnParallelLinear(
        n_in, n_out, has_bias=has_bias, gather_output=False,
        out_segments=((n_out // segments, True, unit),) * segments,
        device=device, generator=False)


def _row(n_in, n_out, device, unit=1):
    return RowParallelLinear(n_in, n_out, input_is_parallel=True,
                             in_unit=unit, device=device, generator=False)


def _head(n_in, vocab, device, has_bias):
    """A vocab projection, column-parallel, its logits gathered over mp
    (the reference's ``ColumnParallelLinear`` default)."""
    return ColumnParallelLinear(n_in, vocab, has_bias=has_bias,
                                device=device, generator=False)


def _check_even(config):
    """Raise ``ValueError`` naming the first parameter dim that mp does
    not split evenly, as the reference raises: the vocab, the trunk's
    and the branches' FFN and flat attention widths (``hidden_size``,
    ``task_hidden_size``). The heads need not divide: a rank takes whole
    heads, the first ranks one more."""
    n, _, _ = _axis_group("mp")
    if n > 1:
        check_even(n, (
            ("vocab_size", config.vocab_size),
            ("the flat attention width hidden_size", config.hidden_size),
            ("intermediate_size", config.intermediate_size),
            ("the flat attention width task_hidden_size",
             config.task_hidden_size),
            ("task_intermediate_size", config.task_intermediate_size)))


class ErnieSelfAttention(nn.Module):
    """Fused ``qkv`` projection split into q, k and v ``[b, s, h, d]``
    (strided views: the kernels read them through strides), attention
    with the pass's ``causal``, then the ``out`` projection. Under mp
    ``qkv`` is column-parallel (each rank its q, k and v heads side by
    side) and ``out`` row-parallel, so a rank attends with its whole
    heads (``heads / mp``; the first ranks one more where mp does not
    divide them, a rank possibly none)."""

    def __init__(self, hidden, heads, dropout, device):
        super().__init__()
        self.head_dim = hidden // heads
        self.qkv = _col(hidden, 3 * hidden, device, segments=3,
                        unit=self.head_dim)
        self.out = _row(hidden, hidden, device, unit=self.head_dim)
        # this rank's heads and the first of them
        self.num_heads, self._first = rank_heads(heads, self.qkv._n,
                                                 self.qkv._rank)
        self._heads = heads
        self.dropout_p = dropout

    def forward(self, x, attn_bias=None, causal=False):
        b, s = x.shape[0], x.shape[1]
        w = self.num_heads * self.head_dim
        q, k, v = (t.reshape(b, s, self.num_heads, self.head_dim)
                   for t in torch.split(self.qkv(x), [w] * 3, dim=-1))
        if self.num_heads == 0:  # nothing to add to out's sum
            return self.out(q.reshape(b, s, 0))
        # this rank's rows (dp) and heads (mp), as the reference marks
        # them: attention dropout hashes them at their global places
        q = mark_local(q, batch_axes(), None, "mp", None)
        q._heads = (self._first, self._heads)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_bias, self.dropout_p, is_causal=causal,
            training=self.training)
        return self.out(out.reshape(b, s, self.num_heads * self.head_dim))


class ErnieBlock(nn.Module):
    """One post-norm transformer block: ``attn_norm(x + drop(attn(x)))``,
    then ``out_norm(a + drop(output(act(inter(a)))))``."""

    def __init__(self, hidden, heads, inter, act, dropout, attn_dropout,
                 eps, device):
        super().__init__()
        self.attention = ErnieSelfAttention(hidden, heads, attn_dropout,
                                            device)
        self.attn_norm = _LayerNorm(hidden, eps, device)
        self.inter = _col(hidden, inter, device)
        self.output = _row(inter, hidden, device)
        self.out_norm = _LayerNorm(hidden, eps, device)
        self.dropout_p = dropout
        self.act = getattr(F, act)

    def _dropout(self, x):
        return F.dropout(x, self.dropout_p, training=self.training)

    def forward(self, x, attn_bias=None, causal=False):
        a = self.attn_norm(
            x + self._dropout(self.attention(x, attn_bias, causal)))
        f = self.output(self.act(self.inter(a)))
        return self.out_norm(a + self._dropout(f))


class ErnieTrunkBlock(ErnieBlock):
    """A trunk block. ``causal`` fixed at construction is the pipeline
    form's mask; a per-call ``causal`` (the joint model's two passes)
    overrides it."""

    def __init__(self, config, device, causal=False):
        super().__init__(config.hidden_size, config.num_attention_heads,
                         config.intermediate_size, config.hidden_act,
                         config.hidden_dropout_prob,
                         config.attention_probs_dropout_prob,
                         config.layer_norm_eps, device)
        self.causal = causal

    def forward(self, x, attn_bias=None, causal=None):
        return super().forward(
            x, attn_bias, causal=self.causal if causal is None else causal)


def _task_block(config, device):
    return ErnieBlock(config.task_hidden_size,
                      config.num_task_attention_heads,
                      config.task_intermediate_size, config.hidden_act,
                      config.hidden_dropout_prob,
                      config.attention_probs_dropout_prob,
                      config.layer_norm_eps, device)


class ErnieEmbeddings(nn.Module):
    """Word + position (+ token type) embeddings, LayerNorm, dropout."""

    def __init__(self, config, device):
        super().__init__()
        h = config.hidden_size
        self.config = config
        self.word_embeddings = VocabParallelEmbedding(
            config.vocab_size, h, device=device, generator=False)
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


class ErnieTaskBranch(nn.Module):
    """A task-specific branch: ``proj`` from the trunk's width (only when
    the widths differ), then ``num_task_layers`` blocks, causal for the
    NLG branch."""

    def __init__(self, config, causal, device):
        super().__init__()
        self.causal = causal
        self.proj = (_Linear(config.hidden_size, config.task_hidden_size,
                             device)
                     if config.task_hidden_size != config.hidden_size
                     else None)
        self.layer = nn.ModuleList(_task_block(config, device)
                                   for _ in range(config.num_task_layers))

    def forward(self, trunk_out, attn_bias=None):
        x = trunk_out if self.proj is None else self.proj(trunk_out)
        for blk in self.layer:
            x = blk(x, attn_bias, causal=self.causal)
        return x


class ErnieModel(nn.Module):
    """The trunk and the task branches named in ``tasks``. The trunk runs
    once per branch: bidirectionally for NLU, causally for NLG, with the
    same parameters. Returns (nlu_out, nlg_out, trunk_bidir_out); an
    absent branch gives None."""

    def __init__(self, config, device, tasks=("nlu", "nlg")):
        super().__init__()
        _check_even(config)
        self.config = config
        self.tasks = tuple(tasks)
        self.embeddings = ErnieEmbeddings(config, device)
        self.encoder = nn.ModuleList(ErnieTrunkBlock(config, device)
                                     for _ in range(config.num_hidden_layers))
        self.nlu_branch = (ErnieTaskBranch(config, False, device)
                           if "nlu" in self.tasks else None)
        self.nlg_branch = (ErnieTaskBranch(config, True, device)
                           if "nlg" in self.tasks else None)

    def _trunk(self, x, attn_bias, causal=False):
        for blk in self.encoder:
            x = blk(x, attn_bias, causal=causal)
        return x

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """``attention_mask`` ``[b, s]`` (1 keep, 0 pad) becomes the
        additive ``(mask - 1) * 1e4`` ``[b, 1, 1, s]`` in
        ``config.dtype`` (-9984 in bf16)."""
        attn_bias = None
        if attention_mask is not None:
            m = attention_mask.to(to_torch_dtype(self.config.dtype))
            attn_bias = (m[:, None, None, :] - 1.0) * 1e4
        x = self.embeddings(input_ids, token_type_ids)
        nlu = nlg = trunk_bidir = None
        if self.nlu_branch is not None:
            trunk_bidir = self._trunk(x, attn_bias)
            nlu = self.nlu_branch(trunk_bidir, attn_bias)
        if self.nlg_branch is not None:
            trunk_causal = self._trunk(x, attn_bias, causal=True)
            nlg = self.nlg_branch(trunk_causal, attn_bias)
        return nlu, nlg, trunk_bidir


class _MLMHead(nn.Module):
    """``decoder(norm(act(transform(h))))``: the NLU branch's masked-LM
    head, its decoder ``[task_hidden, vocab]`` with a bias."""

    def __init__(self, hidden, vocab, eps, act, device):
        super().__init__()
        self.transform = _Linear(hidden, hidden, device)
        self.norm = _LayerNorm(hidden, eps, device)
        self.decoder = _head(hidden, vocab, device, True)
        self.act = getattr(F, act)

    def forward(self, h):
        return self.decoder(self.norm(self.act(self.transform(h))))


class _ErnieHead(nn.Module):
    """Shared constructor: the device and the seeded fp32 weights
    (normal(0, 0.02) matrices and embeddings, zero biases, unit LayerNorm
    scales, drawn from ``generator``, one seeded with 0 when None);
    ``amp.decorate(level="O2")`` casts them."""

    def _init(self, dev, generator):
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        _init_weights(self, generator, dev)

    @property
    def device(self) -> torch.device:
        return self.ernie.embeddings.word_embeddings.weight.device


class ErnieForPretraining(_ErnieHead):
    """Joint pretraining: ``mlm_head`` on the NLU branch, ``lm_head``
    (``[task_hidden, vocab]``, no bias) on the NLG branch."""

    def __init__(self, config: ErnieConfig, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        c = self.config = config
        self.ernie = ErnieModel(config, dev)
        self.mlm_head = _MLMHead(c.task_hidden_size, c.vocab_size,
                                 c.layer_norm_eps, c.hidden_act, dev)
        self.lm_head = _head(c.task_hidden_size, c.vocab_size, dev, False)
        self._init(dev, generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                mlm_labels=None, lm_labels=None, ignore_index=-100):
        """(mlm_logits, lm_logits) ``[b, s, vocab]`` in the parameters'
        dtype, or, given labels (``ignore_index`` = not predicted), the
        loss: the masked-LM term plus the next-token term (logits at
        positions ``:-1`` against labels at ``1:``), each an fp32
        cross-entropy averaged over its predicted tokens."""
        nlu, nlg, _ = self.ernie(input_ids, token_type_ids, attention_mask)
        mlm_logits = self.mlm_head(nlu)
        lm_logits = self.lm_head(nlg)
        if mlm_labels is None and lm_labels is None:
            return mlm_logits, lm_logits
        loss = None
        if mlm_labels is not None:
            per = F.cross_entropy(mlm_logits.to(torch.float32), mlm_labels,
                                  ignore_index=ignore_index,
                                  reduction="none")
            loss = masked_token_mean(per, mlm_labels, ignore_index)
        if lm_labels is not None:
            lb = lm_labels[:, 1:]
            per = F.cross_entropy(lm_logits[:, :-1].to(torch.float32), lb,
                                  ignore_index=ignore_index,
                                  reduction="none")
            lm_loss = masked_token_mean(per, lb, ignore_index)
            loss = lm_loss if loss is None else loss + lm_loss
        return loss

    def flops_per_token(self, seq_len):
        """Dense training FLOPs per token as the reference counts them
        (``ernie.py:328-345``): 6 x (4 h^2 + 2 h ffn) + 12 seq h per
        layer, the trunk and the branches twice (one pass per task
        mask), plus 6 x 2 x task_hidden x vocab for the heads."""
        c = self.config

        def layer_flops(h, inter, layers):
            return layers * (6 * (4 * h * h + 2 * h * inter)
                             + 12 * seq_len * h)

        trunk = 2 * layer_flops(c.hidden_size, c.intermediate_size,
                                c.num_hidden_layers)
        task = 2 * layer_flops(c.task_hidden_size, c.task_intermediate_size,
                               c.num_task_layers)
        heads = 6 * 2 * c.task_hidden_size * c.vocab_size
        return trunk + task + heads


class ErnieForSequenceClassification(_ErnieHead):
    """Fine-tuning head: the NLU branch's first token through dropout and
    a ``[task_hidden, num_classes]`` classifier (the trunk runs once,
    bidirectionally)."""

    def __init__(self, config: ErnieConfig, num_classes=2, *,
                 device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.ernie = ErnieModel(config, dev, tasks=("nlu",))
        self.classifier = _Linear(config.task_hidden_size, num_classes, dev)
        self._init(dev, generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        nlu, _, _ = self.ernie(input_ids, token_type_ids, attention_mask)
        return self.classifier(F.dropout(
            nlu[:, 0], self.config.hidden_dropout_prob,
            training=self.training))


# -- the pipeline form ----------------------------------------------------------

class _ErnieEmbeddingStage(nn.Module):
    """The pipe's first layer: the embeddings, cast to the config's
    dtype."""

    def __init__(self, config, device):
        super().__init__()
        self.config = config
        self.embeddings = ErnieEmbeddings(config, device)

    def forward(self, input_ids):
        return self.embeddings(input_ids).to(to_torch_dtype(
            self.config.dtype))


class _ErnieHeadStage(nn.Module):
    """The pipe's last layer: the task's branch and its pretraining head
    (``_MLMHead`` for NLU, a bias-free ``[task_hidden, vocab]`` ``head``
    for NLG)."""

    def __init__(self, config, task, device):
        super().__init__()
        self.task = task
        c = config
        self.branch = ErnieTaskBranch(config, task == "nlg", device)
        self.head = (_MLMHead(c.task_hidden_size, c.vocab_size,
                              c.layer_norm_eps, c.hidden_act, device)
                     if task == "nlu" else
                     _head(c.task_hidden_size, c.vocab_size, device, False))

    def forward(self, x):
        return self.head(self.branch(x))


class _ErniePipeLoss:
    """The pipe's ``loss_fn(logits, labels, count=None)``: fp32
    cross-entropy averaged over the predicted tokens (``count``, the
    whole batch's, when the pipeline gives it); NLG predicts the next
    token (logits ``:-1`` against labels ``1:``)."""

    def __init__(self, task):
        self.shift = task == "nlg"

    def _labels(self, labels):
        return labels[:, 1:] if self.shift else labels

    def token_count(self, labels):
        return (self._labels(labels) != -100).sum()

    def __call__(self, logits, labels, count=None):
        if self.shift:
            logits = logits[:, :-1]
        labels = self._labels(labels)
        per = F.cross_entropy(logits.to(torch.float32),
                              labels.unsqueeze(-1), reduction="none")
        return masked_token_mean(per, labels, -100, count=count)


class ErnieForPretrainingPipe(PipelineLayer):
    """The pipeline-parallel ERNIE (the reference's
    ``ErnieForPretrainingPipe``): the trunk blocks are the repeated run,
    split over the stages; ``_ErnieEmbeddingStage`` and
    ``_ErnieHeadStage`` are the head and the tail. ``task`` fixes the
    trunk's mask and the objective: ``"nlg"`` (causal, next-token LM)
    or ``"nlu"`` (bidirectional, masked LM); labels ``[b, s]``. Each
    layer's weights are drawn as ``ErnieForPretraining``'s are, from a
    generator seeded ``seed + <index>`` on their global shapes and cut,
    so every stage and mp layout builds the same model. Under mp each
    stage holds its tensor-parallel pieces: the embedding stage's vocab
    rows, the blocks' heads and FFN columns, the head's vocab columns
    (its logits gathered for the loss, as in the reference)."""

    def __init__(self, config: ErnieConfig, task="nlg", *, device="cuda",
                 seed=0, **kwargs):
        if task not in ("nlu", "nlg"):
            raise ValueError(f"task must be 'nlu' or 'nlg', got {task!r}")
        _check_even(config)
        dev = resolve_device(device)
        descs = ([LayerDesc(_ErnieEmbeddingStage, config, dev)]
                 + [LayerDesc(ErnieTrunkBlock, config, dev,
                              causal=task == "nlg")
                    for _ in range(config.num_hidden_layers)]
                 + [LayerDesc(_ErnieHeadStage, config, task, dev)])
        super().__init__(layers=descs, loss_fn=_ErniePipeLoss(task),
                         recompute_interval=1 if config.recompute else 0,
                         **kwargs)
        self.config = config
        self.task = task
        for idx, module in self.named_children():
            _init_weights(module, torch.Generator(device=dev).manual_seed(
                seed + int(idx)), dev)
