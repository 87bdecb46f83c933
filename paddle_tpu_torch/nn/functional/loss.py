"""Losses (counterpart of ``paddle_tpu/nn/functional/loss.py``).

The reference computes every loss through ``apply`` as plain XLA: no
Pallas kernel. Here each is torch ops, its inputs cast by
``amp.auto_cast`` under the reference's op name, its reduction by the
reference's ``_reduce`` (``loss.py:17``): ``"mean"``, ``"sum"``, and
anything else per element. The recurrences (``ctc_loss``,
``rnnt_loss``, ``edit_distance``) are loops over time of batched torch
ops on the device. ``chunked_softmax_cross_entropy`` keeps the Llama
loss's path: an autograd Function over vocab chunks.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ...amp.auto_cast import cast_inputs
from ...tensor._common import tensors

__all__ = ["cross_entropy", "softmax_with_cross_entropy", "nll_loss",
           "mse_loss", "l1_loss", "smooth_l1_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "kl_div",
           "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_embedding_loss", "triplet_margin_loss",
           "multi_label_soft_margin_loss", "soft_margin_loss",
           "square_error_cost", "log_loss", "ctc_loss",
           "sigmoid_focal_loss", "huber_loss", "edit_distance",
           "hsigmoid_loss", "poisson_nll_loss", "gaussian_nll_loss",
           "multi_margin_loss", "triplet_margin_with_distance_loss",
           "dice_loss", "npair_loss", "rnnt_loss", "margin_cross_entropy",
           "chunked_softmax_cross_entropy"]

_NEG = -1e30  # the reference's masked-logit fill
_F = torch.nn.functional


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross-entropy over ``axis`` of ``input`` by the reference's
    rules (``loss.py:25-87``). A black op under ``auto_cast``: the
    logits (and a float label or weight) in fp32.

    - ``use_softmax=False`` takes ``input`` as probabilities: the log of
      ``max(input, 1e-30)``;
    - soft labels (``soft_label``, or a float label of input's shape):
      ``-sum(label * logp)`` over ``axis``, the label smoothed toward
      ``1 / k`` by ``label_smoothing``; no weight, no ignored index;
    - hard labels (label of input's shape without ``axis``, or with it
      of size 1): ``-logp`` at the label, with ``label_smoothing``
      ``(1 - s) * -logp[label] + s * -mean(logp)``, times the class
      ``weight`` at the label; ``ignore_index`` gives 0, and ``"mean"``
      divides by the summed weights of the valid labels (their count
      without ``weight``, at least 1).
    """
    input, label, weight = cast_inputs("cross_entropy",  # noqa: A001
                                       *tensors(input, label, weight))
    ax = axis % input.dim()
    logp = torch.log_softmax(input, dim=ax) if use_softmax \
        else torch.log(input.clamp(min=1e-30))
    if soft_label or (label.dim() == input.dim()
                      and label.shape == input.shape
                      and label.is_floating_point()):
        tgt = label
        if label_smoothing > 0:
            tgt = tgt * (1 - label_smoothing) \
                + label_smoothing / input.shape[ax]
        return _reduce(-(tgt * logp).sum(ax), reduction)
    lab = label.squeeze(ax) if label.dim() == input.dim() else label
    lab = lab.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    picked = torch.gather(logp, ax, safe.unsqueeze(ax)).squeeze(ax)
    if label_smoothing > 0:
        loss = (1 - label_smoothing) * -picked \
            - label_smoothing * logp.mean(ax)
    else:
        loss = -picked
    if weight is not None:
        w_at = weight[safe]
        loss = loss * w_at
    loss = torch.where(valid, loss, torch.zeros((), dtype=loss.dtype,
                                                device=loss.device))
    if reduction == "mean":
        if weight is not None:
            return loss.sum() / (w_at * valid).sum()
        return loss.sum() / valid.sum().clamp(min=1)
    if reduction == "sum":
        return loss.sum()
    return loss


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """:func:`cross_entropy` per element with ``axis`` kept (size 1);
    with ``return_softmax`` also the softmax of ``logits``.
    ``numeric_stable_mode`` is accepted (always stable)."""
    from ...tensor.manipulation import unsqueeze
    from .activation import softmax

    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    loss = unsqueeze(loss, axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100,  # noqa: A002
             reduction="mean", name=None):
    """``-input[n, label[n], ...]`` (log-probabilities over dim 1), the
    class ``weight`` at the label, 0 at ``ignore_index``; ``"mean"`` over
    the valid labels' weights."""
    logp, label, weight = cast_inputs("nll_loss",
                                      *tensors(input, label, weight))
    lab = label.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    loss = -torch.gather(logp, 1, safe.unsqueeze(1)).squeeze(1)
    if weight is not None:
        w_at = weight[safe]
        loss = loss * w_at
    loss = torch.where(valid, loss, torch.zeros((), dtype=loss.dtype,
                                                device=loss.device))
    if reduction == "mean":
        denom = (w_at * valid).sum() if weight is not None \
            else valid.sum().clamp(min=1)
        return loss.sum() / denom
    if reduction == "sum":
        return loss.sum()
    return loss


def mse_loss(input, label, reduction="mean", name=None):  # noqa: A002
    a, b = cast_inputs("mse_loss", *tensors(input, label))
    return _reduce((a - b) ** 2, reduction)


def l1_loss(input, label, reduction="mean", name=None):  # noqa: A002
    a, b = cast_inputs("l1_loss", *tensors(input, label))
    return _reduce((a - b).abs(), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0,  # noqa: A002
                   name=None):
    """``0.5 d^2 / delta`` below ``delta``, ``d - 0.5 delta`` above."""
    a, b = cast_inputs("smooth_l1_loss", *tensors(input, label))
    d = (a - b).abs()
    return _reduce(torch.where(d < delta, 0.5 * d * d / delta,
                               d - 0.5 * delta), reduction)


def binary_cross_entropy(input, label, weight=None,  # noqa: A002
                         reduction="mean", name=None):
    """``-(t log p + (1 - t) log(1 - p))``, p clipped to ``[1e-12, 1 -
    1e-7]``, times ``weight``."""
    p, t, weight = cast_inputs("binary_cross_entropy",
                               *tensors(input, label, weight))
    p = p.clamp(1e-12, 1 - 1e-7)
    loss = -(t * torch.log(p) + (1 - t) * torch.log1p(-p))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """``max(z, 0) - z t + log(1 + exp(-|z|))``; with ``pos_weight``
    ``-(pw t log sigmoid(z) + (1 - t) log sigmoid(-z))``; times
    ``weight`` (the op ``bce_with_logits``)."""
    z, t, weight, pos_weight = cast_inputs(
        "bce_with_logits", *tensors(logit, label, weight, pos_weight))
    if pos_weight is not None:
        loss = -(pos_weight * t * _F.logsigmoid(z)
                 + (1 - t) * _F.logsigmoid(-z))
    else:
        loss = z.clamp(min=0) - z * t + torch.log1p(torch.exp(-z.abs()))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", log_target=False,  # noqa: A002
           name=None):
    """``t (log t - input)`` (0 where ``t <= 0``), or ``exp(t) (t -
    input)`` with ``log_target``; ``"batchmean"`` divides the sum by
    the batch size."""
    logp, t = cast_inputs("kl_div", *tensors(input, label))
    if log_target:
        loss = torch.exp(t) * (t - logp)
    else:
        loss = t * (torch.log(t.clamp(min=1e-12)) - logp)
        loss = torch.where(t > 0, loss, torch.zeros((), dtype=loss.dtype,
                                                    device=loss.device))
    if reduction == "batchmean":
        return loss.sum() / logp.shape[0]
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0,  # noqa: A002
                        reduction="mean", name=None):
    a, b, t = cast_inputs("margin_ranking_loss",
                          *tensors(input, other, label))
    return _reduce((-t * (a - b) + margin).clamp(min=0.0), reduction)


def hinge_embedding_loss(input, label, margin=1.0,  # noqa: A002
                         reduction="mean", name=None):
    """``input`` where ``label == 1``, else ``max(0, margin - input)``."""
    a, t = cast_inputs("hinge_embedding_loss", *tensors(input, label))
    return _reduce(torch.where(t == 1, a, (margin - a).clamp(min=0.0)),
                   reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    """``1 - cos`` where ``label == 1``, else ``max(0, cos - margin)``;
    ``cos`` over the last dim, the norms' product clamped at 1e-12."""
    a, b, t = cast_inputs("cosine_embedding_loss",
                          *tensors(input1, input2, label))
    cos = (a * b).sum(-1) / (torch.linalg.vector_norm(a, dim=-1)
                             * torch.linalg.vector_norm(b, dim=-1)
                             ).clamp(min=1e-12)
    return _reduce(torch.where(t == 1, 1 - cos,
                               (cos - margin).clamp(min=0.0)), reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0,  # noqa: A002
                        p=2.0, epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    """``max(0, d(a, pos) - d(a, neg) + margin)``, ``d`` the p-norm of
    the difference plus ``epsilon``; with ``swap`` the smaller of
    ``d(a, neg)`` and ``d(pos, neg)``."""
    a, pos, neg = cast_inputs("triplet_margin_loss",
                              *tensors(input, positive, negative))

    def dist(u, w):
        return torch.linalg.vector_norm(u - w + epsilon, ord=p, dim=-1)
    dp, dn = dist(a, pos), dist(a, neg)
    if swap:
        dn = torch.minimum(dn, dist(pos, neg))
    return _reduce((dp - dn + margin).clamp(min=0.0), reduction)


def multi_label_soft_margin_loss(input, label, weight=None,  # noqa: A002
                                 reduction="mean", name=None):
    z, t, weight = cast_inputs("multi_label_soft_margin_loss",
                               *tensors(input, label, weight))
    loss = -(t * _F.logsigmoid(z) + (1 - t) * _F.logsigmoid(-z))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss.mean(-1), reduction)


def soft_margin_loss(input, label, reduction="mean", name=None):  # noqa: A002
    z, t = cast_inputs("soft_margin_loss", *tensors(input, label))
    return _reduce(torch.log1p(torch.exp(-t * z)), reduction)


def square_error_cost(input, label):  # noqa: A002
    a, b = cast_inputs("square_error_cost", *tensors(input, label))
    return (a - b) ** 2


def log_loss(input, label, epsilon=1e-4, name=None):  # noqa: A002
    p, t = cast_inputs("log_loss", *tensors(input, label))
    return -t * torch.log(p + epsilon) - (1 - t) * torch.log(1 - p + epsilon)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC by the alpha recursion in log space (``loss.py:326-373``):
    ``log_probs`` ``[T, B, C]``, ``labels`` ``[B, L]``; the extended
    sequence ``blank l1 blank ... blank`` of ``2L + 1`` states, one step
    a time step as a few batched ops (a loop over T, as the reference's
    ``scan``), the log-likelihood read at each row's last frame and last
    two states. ``"mean"`` averages the losses divided by the label
    lengths (at least 1); ``norm_by_times`` is accepted and ignored, as
    in the reference. A black op under ``auto_cast``."""
    lp, lab, in_len, lab_len = cast_inputs(
        "ctc_loss", *tensors(log_probs, labels, input_lengths,
                             label_lengths))
    steps, b, _ = lp.shape
    n_lab = lab.shape[1]
    dev = lp.device
    ext = torch.full((b, 2 * n_lab + 1), blank, dtype=torch.long,
                     device=dev)
    ext[:, 1::2] = lab.long()
    neg = torch.full((), _NEG, dtype=lp.dtype, device=dev)
    prev2 = _F.pad(ext[:, :-2], (2, 0), value=-1)
    can_skip = (ext != blank) & (ext != prev2)
    rows = torch.arange(b, device=dev)
    alpha = torch.full(ext.shape, _NEG, dtype=lp.dtype, device=dev)
    alpha = torch.cat([lp[0, rows, ext[:, 0]][:, None],
                       (lp[0, rows, ext[:, 1]] if n_lab > 0
                        else neg.expand(b))[:, None], alpha[:, 2:]], dim=1)
    alphas = [alpha]
    for t in range(1, steps):
        shift1 = _F.pad(alpha[:, :-1], (1, 0), value=_NEG)
        shift2 = torch.where(can_skip, _F.pad(alpha[:, :-2], (2, 0),
                                              value=_NEG), neg)
        merged = torch.logaddexp(torch.logaddexp(alpha, shift1), shift2)
        alpha = merged + torch.gather(lp[t], 1, ext)
        alphas.append(alpha)
    last = torch.stack(alphas)[in_len.long() - 1, rows]  # [B, S]
    send = 2 * lab_len.long()
    p_blank = torch.gather(last, 1, send[:, None])[:, 0]
    p_label = torch.gather(last, 1, (send - 1).clamp(min=0)[:, None])[:, 0]
    loss = -torch.logaddexp(p_blank, torch.where(lab_len > 0, p_label, neg))
    if reduction == "mean":
        return (loss / lab_len.to(lp.dtype).clamp(min=1)).mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    """``a_t (1 - p_t)^gamma`` times the logits' BCE, divided by
    ``normalizer``."""
    z, t, normalizer = cast_inputs("sigmoid_focal_loss",
                                   *tensors(logit, label, normalizer))
    p = torch.sigmoid(z)
    ce = z.clamp(min=0) - z * t + torch.log1p(torch.exp(-z.abs()))
    p_t = p * t + (1 - p) * (1 - t)
    a_t = alpha * t + (1 - alpha) * (1 - t)
    loss = a_t * (1 - p_t) ** gamma * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def huber_loss(input, label, delta=1.0, reduction="mean",  # noqa: A002
               name=None):
    """``0.5 r^2`` where ``|r| <= delta``, else ``delta (|r| - 0.5
    delta)``."""
    a, b = cast_inputs("huber_loss", *tensors(input, label))
    r = (a - b).abs()
    return _reduce(torch.where(r <= delta, 0.5 * r * r,
                               delta * (r - 0.5 * delta)), reduction)


def _repack(a, ignored):
    """The rows of ``a`` without the ``ignored`` tokens, right-padded
    with 0, and their lengths (on the host, as the reference repacks)."""
    a = a.detach().cpu().numpy()
    rows = [r[~np.isin(r, ignored)] for r in a]
    lens = np.asarray([len(r) for r in rows], np.int64)
    out = np.zeros((len(rows), lens.max() if len(rows) else 0), a.dtype)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out, lens


def edit_distance(input, label, normalized=True,  # noqa: A002
                  ignored_tokens=None, input_length=None, label_length=None,
                  name=None):
    """Levenshtein distance of each hypothesis row to its reference row
    (``loss.py:404``): ``(distance [b, 1] float32, sequence_num [1])``,
    divided by the reference length (at least 1) when ``normalized``.
    The one-row recurrence runs over the hypothesis tokens; within a
    row, ``row[j] = min(sub, del, row[j - 1] + 1)`` is a running
    minimum, ``j + cummin(v[k] - k)``. Lengths default to the widths;
    ``ignored_tokens`` are dropped on the host first. No gradient."""
    hyp, ref = tensors(input, label)
    dev = hyp.device
    if ignored_tokens:
        (hyp, hl), (ref, rl) = (_repack(t, ignored_tokens)
                                for t in (hyp, ref))
        hyp, ref, hl, rl = (torch.from_numpy(a).to(dev)
                            for a in (hyp, ref, hl, rl))
    else:
        hl = input_length if input_length is not None \
            else torch.full((hyp.shape[0],), hyp.shape[1])
        rl = label_length if label_length is not None \
            else torch.full((ref.shape[0],), ref.shape[1])
        hl, rl = (torch.as_tensor(v).to(dev) for v in (hl, rl))
    hl, rl = hl.long().reshape(-1), rl.long().reshape(-1)
    b, n_ref = hyp.shape[0], ref.shape[1]
    cols = torch.arange(n_ref + 1, dtype=torch.float32, device=dev)
    row = cols.expand(b, n_ref + 1)
    for i in range(hyp.shape[1]):
        sub = row[:, :-1] + (ref != hyp[:, i:i + 1]).to(torch.float32)
        v = torch.cat([row[:, :1] + 1.0,
                       torch.minimum(sub, row[:, 1:] + 1.0)], dim=1)
        new = cols + torch.cummin(v - cols, dim=1).values
        row = torch.where((i < hl)[:, None], new, row)
    dist = torch.gather(row, 1, rl[:, None])
    dist = torch.where(hl[:, None] == 0, rl[:, None].to(torch.float32), dist)
    dist = torch.where((rl[:, None] == 0) & (hl[:, None] > 0),
                       hl[:, None].to(torch.float32), dist)
    if normalized:
        dist = dist / rl[:, None].to(torch.float32).clamp(min=1.0)
    return dist, torch.full((1,), b, dtype=torch.int32, device=dev)


@functools.lru_cache(maxsize=32)
def _simple_code_tables(num_classes):
    """The reference's SimpleCode tables (``loss.py:497``): for class c,
    code ``c + num_classes``; walking its bits from the top gives the
    path's node ``(code >> k) - 1`` and branch bit. Built once a
    ``num_classes`` on the host (numpy)."""
    max_len = int(np.ceil(np.log2(max(num_classes, 2))))
    tbl = np.full((num_classes, max_len), -1, np.int64)
    bits = np.zeros((num_classes, max_len), np.float32)
    for c in range(num_classes):
        code = c + num_classes
        length = code.bit_length() - 1
        for j in range(length):
            tbl[c, j] = (code >> (length - j)) - 1
            bits[c, j] = (code >> (length - 1 - j)) & 1
    return tbl, bits


def hsigmoid_loss(input, label, num_classes, weight, bias=None,  # noqa: A002
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid loss (``loss.py:515``): the sum over the
    label's path of internal nodes of the logits' BCE against the branch
    bits, ``[b, 1]``. The default tree is the reference's SimpleCode
    (:func:`_simple_code_tables`); ``path_table``/``path_code``
    ``[b, L]`` (-1 padded) give a custom one."""
    x, w, bias = cast_inputs("hsigmoid_loss", *tensors(input, weight, bias))
    lab = torch.as_tensor(label).to(x.device).reshape(-1).long()
    if path_table is None:
        tbl, bits = (torch.from_numpy(a).to(x.device)
                     for a in _simple_code_tables(int(num_classes)))
        ptab, pcode = tbl[lab], bits[lab]
    else:
        ptab = torch.as_tensor(path_table).to(x.device).long()
        pcode = torch.as_tensor(path_code).to(x.device)
    valid = (ptab >= 0).to(x.dtype)
    idx = ptab.clamp(min=0)
    logits = torch.einsum("bd,bld->bl", x, w[idx])
    if bias is not None:
        logits = logits + bias.reshape(-1)[idx]
    per_node = logits.clamp(min=0) - logits * pcode.to(x.dtype) \
        + torch.log1p(torch.exp(-logits.abs()))
    return (per_node * valid).sum(1, keepdim=True)


def poisson_nll_loss(input, label, log_input=True, full=False,  # noqa: A002
                     epsilon=1e-8, reduction="mean", name=None):
    """``exp(x) - t x`` (``log_input``) or ``x - t log(x + epsilon)``;
    ``full`` adds Stirling's term where ``t > 1``."""
    x, t = cast_inputs("poisson_nll_loss", *tensors(input, label))
    out = torch.exp(x) - t * x if log_input \
        else x - t * torch.log(x + epsilon)
    if full:
        stirling = t * torch.log(t) - t + 0.5 * torch.log(2 * np.pi * t)
        out = out + torch.where(t > 1, stirling,
                                torch.zeros((), dtype=x.dtype,
                                            device=x.device))
    return _reduce(out, reduction)


def gaussian_nll_loss(input, label, variance, full=False,  # noqa: A002
                      epsilon=1e-6, reduction="mean", name=None):
    """``0.5 (log var + (t - mu)^2 / var)``, var clamped at ``epsilon``;
    ``full`` adds ``0.5 log(2 pi)``."""
    mu, t, var = cast_inputs("gaussian_nll_loss",
                             *tensors(input, label, variance))
    var = var.clamp(min=epsilon)
    out = 0.5 * (torch.log(var) + (t - mu) ** 2 / var)
    if full:
        out = out + 0.5 * float(np.log(np.float32(2 * np.pi)))
    return _reduce(out, reduction)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,  # noqa: A002
                      reduction="mean", name=None):
    """``sum_{c != t} max(0, margin - x_t + x_c)^p / C`` per row of
    ``input`` ``[N, C]``, times ``weight[t]``."""
    x, t, weight = cast_inputs("multi_margin_loss",
                               *tensors(input, label, weight))
    n, c = x.shape
    t = t.reshape(-1).long()
    m = (margin - torch.gather(x, 1, t[:, None]) + x).clamp(min=0.0) ** p
    if weight is not None:
        m = m * weight[t][:, None]
    m = m * (1 - _F.one_hot(t, c).to(x.dtype))
    return _reduce(m.sum(1) / c, reduction)


def triplet_margin_with_distance_loss(input, positive, negative,  # noqa: A002
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    """``max(0, d(a, pos) - d(a, neg) + margin)`` with a caller's
    ``distance_function`` (default: the Euclidean distance over the last
    dim); with ``swap`` the smaller of ``d(a, neg)`` and ``d(pos,
    neg)``."""
    if distance_function is None:
        def distance_function(a, b):
            return ((a - b) ** 2).sum(-1).sqrt()
    d_ap = distance_function(input, positive)
    d_an = distance_function(input, negative)
    if swap:
        d_an = torch.minimum(d_an, distance_function(positive, negative))
    hinge = torch.relu(d_ap - d_an + margin)
    if reduction == "none":
        return hinge
    (hinge,) = cast_inputs("reduce_" + reduction, hinge)
    return hinge.mean() if reduction == "mean" else hinge.sum()


def dice_loss(input, label, epsilon=1e-5, name=None):  # noqa: A002
    """``1 - (2 |x t| + eps) / (|x| + |t| + eps)`` per sample, averaged;
    ``input`` ``[..., C]`` probabilities, ``label`` ``[..., 1]``."""
    x, t = cast_inputs("dice_loss", *tensors(input, label))
    onehot = _F.one_hot(t.squeeze(-1).long(), x.shape[-1]).to(x.dtype)
    red = tuple(range(1, x.dim()))
    inter = (x * onehot).sum(red)
    union = x.sum(red) + onehot.sum(red)
    return (1.0 - (2.0 * inter + epsilon) / (union + epsilon)).mean()


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    """N-pair loss: the softmax CE of ``anchor @ positive.T`` against
    the same-label targets, both ways, averaged, plus ``l2_reg / 4`` of
    the mean squared norms."""
    a, p, lab = cast_inputs("npair_loss", *tensors(anchor, positive, labels))
    lab = lab.reshape(-1)
    sim = a @ p.T
    tgt = (lab[:, None] == lab[None, :]).to(a.dtype)
    tgt = tgt / tgt.sum(1, keepdim=True).clamp(min=1.0)
    xent_r = -(tgt * torch.log_softmax(sim, 1)).sum(1).mean()
    xent_c = -(tgt * torch.log_softmax(sim.T, 1)).sum(1).mean()
    reg = l2_reg * ((a * a).sum(1).mean() + (p * p).sum(1).mean()) * 0.25
    return (xent_r + xent_c) / 2.0 + reg


def rnnt_loss(input, label, input_lengths, label_lengths,  # noqa: A002
              blank=0, fastemit_lambda=0.001, reduction="mean", name=None):
    """RNN-Transducer loss over the ``[T, U + 1]`` lattice
    (``loss.py:678-760``): ``input`` ``[B, T, U + 1, C]`` logits
    (log-softmax in fp32), ``label`` ``[B, U]``. Row by row over T: the
    row's recurrence ``a(u) = logaddexp(b(u), a(u - 1) + e(u - 1))`` is
    solved in closed form, ``Ecum + logcumsumexp(b - Ecum)``, as the
    reference solves it. FastEmit scales the emit arcs by ``1 +
    fastemit_lambda`` in log space."""
    logits, lab, in_len, lab_len = cast_inputs(
        "rnnt_loss", *tensors(input, label, input_lengths, label_lengths))
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    b, steps, u1, _ = lp.shape
    dev = lp.device
    lab = lab.long()
    blank_lp = lp[..., blank]  # [B, T, U + 1]
    emit_lp = torch.gather(lp[:, :, :u1 - 1], -1, lab[:, None, :, None]
                           .expand(b, steps, u1 - 1, 1))[..., 0]
    if fastemit_lambda:
        emit_lp = emit_lp + float(np.log1p(fastemit_lambda))

    def row_solve(b_row, e_row):
        ecum = torch.cat([torch.zeros_like(e_row[:, :1]),
                          e_row.cumsum(-1)], dim=-1)
        return ecum + torch.logcumsumexp(b_row - ecum, dim=-1)
    first = torch.full((b, u1), _NEG, device=dev)
    first[:, 0] = 0.0
    alpha = row_solve(first, emit_lp[:, 0])
    alphas = [alpha]
    for t in range(1, steps):
        alpha = row_solve(alpha + blank_lp[:, t - 1], emit_lp[:, t])
        alphas.append(alpha)
    rows = torch.arange(b, device=dev)
    t_idx, u_idx = in_len.long() - 1, lab_len.long()
    a_end = torch.stack(alphas)[t_idx, rows, u_idx]
    loss = -(a_end + blank_lp[rows, t_idx, u_idx])
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _group_size(group):
    if hasattr(group, "nranks"):
        return group.nranks
    from ...distributed.parallel import get_world_size

    return get_world_size()


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    """Combined-margin softmax CE (ArcFace family, ``loss.py:761-787``):
    the target cosine ``cos(theta)`` becomes ``cos(margin1 * theta +
    margin2) - margin3``, all logits times ``scale``; with
    ``return_softmax`` also the softmax. A black op under ``auto_cast``.

    The reference ignores ``group`` because its arrays are global. Here
    a ``group`` of more than one rank (a ``distributed.Group``) means
    the classes are sharded over it: this rank's ``logits`` are ``[N,
    C_local]`` (``C_local`` may differ between ranks; the offsets come
    from an all-gather of the counts) and ``label`` holds global class
    ids. The margin is applied on the rank that owns the target, the
    log-softmax takes one MAX and one SUM all-reduce over the group,
    the loss is the same on every rank, ``return_softmax`` gives this
    rank's shard, and the gradient of the local logits is that slice of
    the whole logits' gradient."""
    sharded = group is not None and group is not False \
        and _group_size(group) > 1
    x, t = cast_inputs("margin_cross_entropy", *tensors(logits, label))
    c = x.shape[1]
    t = t.reshape(-1).long()
    if sharded:
        if not hasattr(group, "_pair"):
            raise TypeError(
                f"margin_cross_entropy over {group!r}: a group of more "
                f"than one rank must be a distributed.Group (the classes "
                f"are sharded over its ranks)")
        return _margin_ce_sharded(x, t, margin1, margin2, margin3, scale,
                                  group._pair(), return_softmax, reduction)
    cos_t = torch.gather(x, 1, t[:, None]).clamp(-1.0, 1.0)
    cos_m = torch.cos(margin1 * torch.arccos(cos_t) + margin2) - margin3
    adj = x + _F.one_hot(t, c).to(x.dtype) * (cos_m - cos_t)
    logp = torch.log_softmax(adj * scale, dim=1)
    loss = _reduce(-torch.gather(logp, 1, t[:, None])[:, 0], reduction)
    return (loss, torch.exp(logp)) if return_softmax else loss


def _margin_ce_sharded(x, t, margin1, margin2, margin3, scale, group,
                       return_softmax, reduction):
    """:func:`margin_cross_entropy` on this rank's classes ``x`` ``[N,
    C_local]`` of the classes sharded over ``group`` (``(ranks, process
    group)``); ``t`` the global targets."""
    import torch.distributed as dist

    from ...distributed import _comm

    c = x.shape[1]
    counts = _comm.all_gather_list(
        torch.tensor([c], dtype=torch.int64, device=x.device),
        group)
    c0 = int(sum(int(k) for k in counts[:group[0].index(dist.get_rank())]))
    local = t - c0
    mine = (local >= 0) & (local < c)
    idx = torch.where(mine, local, torch.zeros_like(local))[:, None]
    # the owner's target cosine (0 elsewhere keeps arccos finite there)
    cos_t = torch.where(mine[:, None], torch.gather(x, 1, idx),
                        torch.zeros((), dtype=x.dtype, device=x.device))
    cos_t = cos_t.clamp(-1.0, 1.0)
    cos_m = torch.cos(margin1 * torch.arccos(cos_t) + margin2) - margin3
    hot = _F.one_hot(idx[:, 0], c).to(x.dtype) * mine[:, None].to(x.dtype)
    z = (x + hot * (cos_m - cos_t)) * scale
    # log-sum-exp over the group: the max is a constant shift; the sum
    # and the target's logit are all-reduced forward and passed through
    # backward (every rank differentiates the same loss)
    m = torch.amax(z.detach(), dim=1, keepdim=True)
    m = _comm.all_reduce(m.contiguous(), group, dist.ReduceOp.MAX)
    se = _comm.reduce_from(torch.exp(z - m).sum(1, keepdim=True), group)
    lse = m + torch.log(se)
    picked = _comm.reduce_from(
        torch.where(mine[:, None], torch.gather(z, 1, idx),
                    torch.zeros((), dtype=z.dtype, device=z.device)), group)
    loss = _reduce((lse - picked)[:, 0], reduction)
    return (loss, torch.exp(z - lse)) if return_softmax else loss


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
    tensor is ever live: at most one ``[N, chunk]`` chunk of logits.
    Over a ``group`` ``w`` is this rank's vocab columns (from global
    column ``v0`` on, of ``v_all``): the running max, sum and picked
    logit over its chunks take one MAX and two SUM all-reduces, and
    ``dh`` is this rank's part (the caller sums it over the group)."""

    @staticmethod
    def forward(ctx, hd, w, lab, chunk, group=None, v0=0, v_all=None):
        n, v = hd.shape[0], w.shape[1]
        dev = hd.device
        valid = (lab >= 0) & (lab < (v if v_all is None else v_all))
        lab = lab - v0
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
        if group is not None:
            import torch.distributed as dist

            from ...distributed import _comm

            m_all = _comm.all_reduce(m.clone(), group, dist.ReduceOp.MAX)
            s = _comm.all_reduce(s * torch.exp(m - m_all), group)
            m = m_all
            ll = _comm.all_reduce(ll, group)
        lse = m + torch.log(torch.clamp(s, min=1e-30))
        ctx.save_for_backward(hd, w, lab, lse, valid)
        ctx.chunk = chunk
        return torch.where(valid, lse - ll, 0.0)

    @staticmethod
    def backward(ctx, g):
        hd, w, lab, lse, valid = ctx.saved_tensors
        chunk, v = ctx.chunk, w.shape[1]
        g = torch.where(valid, g.to(torch.float32), 0.0)
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
        return dh.to(hd.dtype), dw, None, None, None, None, None


def chunked_softmax_cross_entropy(hidden, weight, label, chunk_size,
                                  name=None):
    """Per-token CE of ``softmax(hidden @ weight)`` without the ``[N, V]``
    fp32 logits (the reference's ``chunked_softmax_cross_entropy``, op
    ``chunked_lm_ce``: gray under ``auto_cast``). hidden ``[..., H]``,
    weight ``[H, V]``, label ``[...]`` int; returns the fp32 per-token
    loss of label's shape, 0 where the label is outside ``[0, V)``. The
    reference rematerialises each chunk in its backward
    (``jax.checkpoint`` in a ``scan``); here the autograd Function's
    backward does, and the chunk products stay ``torch.matmul``."""
    return chunked_ce_over(hidden, weight, label, chunk_size)


def chunked_ce_over(hidden, weight, label, chunk_size, group=None):
    """:func:`chunked_softmax_cross_entropy` over the vocab columns of a
    column-parallel head. ``group`` (``(ranks, process group)``, the
    head's mp group): ``weight`` is this rank's equal share of the vocab
    columns, ``label`` holds global ids, and the loss is the whole
    vocabulary's on every rank (a MAX and two SUM all-reduces of ``[N]``
    rows); the head is never gathered, and ``hidden``'s gradient is
    summed over the group. ``None`` or one rank is the plain form."""
    if chunk_size <= 0:
        raise ValueError(
            f"chunked_softmax_cross_entropy: chunk_size must be > 0, "
            f"got {chunk_size}")
    hidden, weight = cast_inputs("chunked_lm_ce", hidden, weight)
    hd = hidden.reshape(-1, hidden.shape[-1])
    lab = label.reshape(-1).long()
    chunk = int(min(chunk_size, weight.shape[1]))
    if group is None or len(group[0]) == 1:
        return _ChunkedCE.apply(hd, weight, lab, chunk).reshape(label.shape)
    import torch.distributed as dist

    from ...distributed import _comm

    n, v = len(group[0]), weight.shape[1]
    v0 = group[0].index(dist.get_rank()) * v
    hd = _comm.copy_to(hd, group)
    return _ChunkedCE.apply(hd, weight, lab, chunk, group, v0,
                            n * v).reshape(label.shape)
