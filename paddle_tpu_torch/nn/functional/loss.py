"""Losses (counterpart of ``paddle_tpu/nn/functional/loss.py``)."""
from __future__ import annotations

import torch

__all__ = ["cross_entropy"]


def cross_entropy(input, label, ignore_index=-100,  # noqa: A002
                  reduction="mean"):
    """Softmax cross-entropy over the last dim of ``input`` with integer
    class labels (``label`` of input's leading shape, or with a trailing
    1). log_softmax, then the picked log-probability; ignored labels
    give 0. ``reduction``: ``"none"`` (per token) or ``"mean"`` over the
    non-ignored labels. Soft labels, class weights, label smoothing and
    ``"sum"`` are not ported (the Llama loss uses none of them)."""
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
