"""Losses (counterpart of ``paddle_tpu/nn/functional/loss.py``)."""
from __future__ import annotations

import torch

from ...amp.auto_cast import cast_inputs

__all__ = ["cross_entropy", "chunked_softmax_cross_entropy"]

_NEG = -1e30  # the reference's masked-logit fill


def cross_entropy(input, label, ignore_index=-100,  # noqa: A002
                  reduction="mean"):
    """Softmax cross-entropy over the last dim of ``input`` with integer
    class labels (``label`` of input's leading shape, or with a trailing
    1). log_softmax, then the picked log-probability; ignored labels
    give 0. ``reduction``: ``"none"`` (per token) or ``"mean"`` over the
    non-ignored labels. Soft labels, class weights, label smoothing and
    ``"sum"`` are not ported (the Llama loss uses none of them). A black
    op under ``auto_cast``: the logits in fp32."""
    (input,) = cast_inputs("cross_entropy", input)  # noqa: A001
    if reduction not in ("none", "mean"):
        raise ValueError(f"reduction must be 'none' or 'mean', got "
                         f"{reduction!r}")
    logp = torch.log_softmax(input, dim=-1)
    lab = label
    if lab.dim() == input.dim():  # trailing 1 dim
        lab = lab.squeeze(-1)
    lab = lab.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    picked = torch.gather(logp, -1, safe[..., None]).squeeze(-1)
    loss = torch.where(valid, -picked, torch.zeros((), dtype=logp.dtype,
                                                   device=logp.device))
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp(min=1)
    return loss


def _chunk(w, c0, chunk):
    """Vocab columns ``[c0, c0 + chunk)`` of ``w`` ``[H, V]``; the last,
    ragged chunk is padded with zero columns to ``chunk`` (a copy of that
    chunk only, as the reference pads, ``loss.py:288-291``)."""
    wc = w[:, c0:c0 + chunk]
    if wc.shape[1] < chunk:
        wc = torch.nn.functional.pad(wc, (0, chunk - wc.shape[1]))
    return wc


def _chunk_logits(hd, w, c0, chunk, v):
    """fp32 logits of one chunk ``[N, chunk]``, the padded columns at
    ``_NEG``. The product runs in the operands' dtype (a bf16 product is
    rounded to bf16 once, as the plain path's logits are)."""
    logits = torch.matmul(hd, _chunk(w, c0, chunk)).to(torch.float32)
    if c0 + chunk > v:
        col = torch.arange(c0, c0 + chunk, device=hd.device)
        logits = torch.where(col < v, logits,
                             torch.full((), _NEG, device=hd.device))
    return logits


class _ChunkedCE(torch.autograd.Function):
    """Per-token CE of ``softmax(hd @ w)`` over vocab chunks: the forward
    keeps each row's running max, sum and picked logit; the backward
    recomputes each chunk's logits and turns ``softmax - onehot`` into
    that chunk's ``dW`` columns and a share of ``dh``. No ``[N, V]``
    tensor is ever live: at most one ``[N, chunk]`` chunk of logits."""

    @staticmethod
    def forward(ctx, hd, w, lab, chunk):
        n, v = hd.shape[0], w.shape[1]
        dev = hd.device
        m = torch.full((n,), _NEG, dtype=torch.float32, device=dev)
        s = torch.zeros(n, dtype=torch.float32, device=dev)
        ll = torch.zeros(n, dtype=torch.float32, device=dev)
        for c0 in range(0, v, chunk):
            logits = _chunk_logits(hd, w, c0, chunk, v)
            m_new = torch.maximum(m, logits.amax(-1))
            s = s * torch.exp(m - m_new) \
                + torch.exp(logits - m_new[:, None]).sum(-1)
            m = m_new
            in_chunk = (lab >= c0) & (lab < c0 + chunk)
            picked = torch.gather(
                logits, 1, torch.clamp(lab - c0, 0, chunk - 1)[:, None])[:, 0]
            ll = ll + torch.where(in_chunk, picked, 0.0)
        lse = m + torch.log(torch.clamp(s, min=1e-30))
        valid = (lab >= 0) & (lab < v)
        ctx.save_for_backward(hd, w, lab, lse)
        ctx.chunk = chunk
        return torch.where(valid, lse - ll, 0.0)

    @staticmethod
    def backward(ctx, g):
        hd, w, lab, lse = ctx.saved_tensors
        chunk, v = ctx.chunk, w.shape[1]
        g = torch.where((lab >= 0) & (lab < v), g.to(torch.float32), 0.0)
        dh = torch.zeros(hd.shape, dtype=torch.float32, device=hd.device)
        dw = torch.empty_like(w)
        rows = torch.arange(hd.shape[0], device=hd.device)
        for c0 in range(0, v, chunk):
            logits = _chunk_logits(hd, w, c0, chunk, v)
            dlog = torch.exp(logits - lse[:, None]) * g[:, None]
            in_chunk = (lab >= c0) & (lab < c0 + chunk)
            col = torch.clamp(lab - c0, 0, chunk - 1)
            dlog[rows, col] -= torch.where(in_chunk, g, 0.0)
            dlog = dlog.to(hd.dtype)
            dh += torch.matmul(dlog, _chunk(w, c0, chunk).t())
            cw = min(chunk, v - c0)
            dw[:, c0:c0 + cw] = torch.matmul(hd.t(), dlog[:, :cw])
        return dh.to(hd.dtype), dw, None, None


def chunked_softmax_cross_entropy(hidden, weight, label, chunk_size):
    """Per-token CE of ``softmax(hidden @ weight)`` without the ``[N, V]``
    fp32 logits (the reference's ``chunked_softmax_cross_entropy``, op
    ``chunked_lm_ce``: gray under ``auto_cast``). hidden ``[..., H]``,
    weight ``[H, V]``, label ``[...]`` int; returns the fp32 per-token
    loss of label's shape, 0 where the label is outside ``[0, V)``. The
    reference rematerialises each chunk in its backward
    (``jax.checkpoint`` in a ``scan``); here the autograd Function's
    backward does, and the chunk products stay ``torch.matmul``."""
    if chunk_size <= 0:
        raise ValueError(
            f"chunked_softmax_cross_entropy: chunk_size must be > 0, "
            f"got {chunk_size}")
    hidden, weight = cast_inputs("chunked_lm_ce", hidden, weight)
    hd = hidden.reshape(-1, hidden.shape[-1])
    lab = label.reshape(-1).long()
    chunk = int(min(chunk_size, weight.shape[1]))
    return _ChunkedCE.apply(hd, weight, lab, chunk).reshape(label.shape)
