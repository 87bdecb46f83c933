"""The model-parallel loss at degree 1.

Counterpart of ``ParallelCrossEntropy`` and ``masked_token_mean`` in
``paddle_tpu/distributed/fleet/meta_parallel/parallel_layers/
mp_layers.py``. On one card the vocab is not sharded, so the loss is the
reference's math without its sharding constraint.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["ParallelCrossEntropy", "masked_token_mean"]


class ParallelCrossEntropy(nn.Module):
    """Per-token softmax cross-entropy ``[..., 1]``: the fp32 log-sum-exp
    minus the picked fp32 logit, 0 where the label is ``ignore_index``."""

    def __init__(self, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, input, label):  # noqa: A002
        lg = input.to(torch.float32)
        mx = torch.amax(lg, dim=-1, keepdim=True)
        lse = torch.log(torch.sum(torch.exp(lg - mx), dim=-1,
                                  keepdim=True)) + mx
        lb = label if label.dim() == lg.dim() - 1 else label.squeeze(-1)
        safe = torch.where(lb < 0, torch.zeros_like(lb), lb).long()
        picked = torch.gather(lg, -1, safe[..., None])
        loss = (lse - picked)[..., 0]
        loss = torch.where(lb == self.ignore_index,
                           torch.zeros((), device=lg.device), loss)
        return loss[..., None]


def masked_token_mean(loss, labels, ignore_index=-100):
    """Mean of a per-token loss over the tokens whose label is not
    ``ignore_index``: the sum in fp32 over the count of valid labels
    (at least 1), never over the total token count."""
    cnt = torch.clamp((labels != ignore_index).sum(), min=1) \
        .to(torch.float32)
    return (torch.sum(loss.to(torch.float32)) / cnt).to(loss.dtype)
