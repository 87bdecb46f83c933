"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``).

Each clip maps ``[(param, grad)]`` to ``[(param, clipped grad)]`` and
is applied by ``Optimizer.step`` before the update. Norms are taken in
fp32; a clipped gradient keeps its dtype. A parameter with
``need_clip = False`` passes through unclipped (and, for the global
norm, uncounted).

A tensor-parallel parameter (one that records a ``_dist_layout``, under
mp > 1) holds a piece of the global gradient: its norm is the global
tensor's, each part's squares summed over exactly the axes that cut it
and a part no axis cuts counted once (``distributed.shard.
global_sq_norms``), as the reference's norms over global arrays are; so
is a gradient that ZeRO cut to this rank's slice (``shard.grad_layout``,
its mp cut and ZeRO's: a K/V segment mp replicates is summed over the
ZeRO axis alone) and an expert's over its axis. Under pp > 1 each
stage holds its own parameters, so :class:`ClipGradByGlobalNorm` sums
the squared norm over the pp group too, counting a weight shared by two
stages once (its later copies are marked ``_pp_shared_dup``).

:func:`clip_grad_norm_` and :func:`clip_grad_value_` clip the ``.grad``
of each parameter in place, as the reference's utilities do
(``clip.py:75, 96``).
"""
from __future__ import annotations

import torch

from ..distributed import _comm
from ..distributed.shard import grad_layout

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_", "clip_grad_value_"]


def _skip(p, g):
    return g is None or not getattr(p, "need_clip", True)


def _pp_group():
    """The pp group's ``(ranks, process group)`` under pp > 1, else
    None: each stage holds its own parameters."""
    from ..distributed.fleet.base.topology import get_hcg

    hcg = get_hcg()
    if hcg is None or hcg.get_pipe_parallel_world_size() == 1:
        return None
    return hcg.get_pipe_parallel_group()._pair()


def _sq_norms(pairs):
    """Each gradient's squared fp32 norm, of the global tensor for a
    tensor-parallel parameter."""
    from ..distributed.shard import global_sq_norms

    return global_sq_norms([grad_layout(p) for p, _ in pairs],
                           [g for _, g in pairs])


class ClipGradBase:
    """The base of the clips: ``clip(params_grads)`` gives the clipped
    ``[(param, grad)]``."""

    def __call__(self, params_grads):
        raise NotImplementedError

    def __repr__(self):  # by settings (a train step's graph key reads it)
        return f"{type(self).__name__}({vars(self)})"


class ClipGradByValue(ClipGradBase):
    """Clamp every gradient element to ``[min, max]`` (``min`` defaults
    to ``-max``)."""

    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    @torch.no_grad()
    def __call__(self, params_grads):
        return [(p, g if _skip(p, g) else g.clamp(self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Scale each gradient to an L2 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    @torch.no_grad()
    def __call__(self, params_grads):
        kept = [(p, g) for p, g in params_grads if not _skip(p, g)]
        dist_norms = {}
        if any(grad_layout(p) is not None for p, _ in kept):
            dist_norms = {id(p): torch.sqrt(s) for (p, _), s in
                          zip(kept, _sq_norms(kept))}
        out = []
        for p, g in params_grads:
            if _skip(p, g):
                out.append((p, g))
                continue
            norm = dist_norms.get(id(p))
            if norm is None:
                norm = torch.linalg.vector_norm(g.to(torch.float32))
            scale = torch.clamp(self.clip_norm / norm.clamp(min=1e-12),
                                max=1.0)
            out.append((p, (g * scale).to(g.dtype)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale all gradients by ``min(clip_norm / global_norm, 1)``, the
    global norm over every clipped gradient in fp32."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    @torch.no_grad()
    def __call__(self, params_grads):
        pp = _pp_group()
        sq = _sq_norms([(p, g) for p, g in params_grads if not _skip(p, g)
                        and not getattr(p, "_pp_shared_dup", False)])
        if not sq and pp is None:
            return params_grads
        total = torch.stack(sq).sum() if sq else torch.zeros(
            (), device=params_grads[0][0].device)
        if pp is not None:
            total = _comm.all_reduce(total, pp)
        global_norm = torch.sqrt(total)
        scale = torch.clamp(self.clip_norm / global_norm.clamp(min=1e-12),
                            max=1.0)
        return [(p, g if _skip(p, g) else (g * scale).to(g.dtype))
                for p, g in params_grads]


def _with_grads(parameters):
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    return [p for p in parameters if p.grad is not None]


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every ``.grad`` by ``min(max_norm / (total + 1e-6), 1)``,
    ``total`` the ``norm_type`` norm (fp32) over all of them; returns
    ``total``. ``error_if_nonfinite`` raises ``RuntimeError`` when
    ``total`` is nan or inf (the reference ignores it)."""
    params = _with_grads(parameters)
    if not params:
        return torch.zeros(())
    grads = [p.grad for p in params]
    norm_type = float(norm_type)
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max().to(torch.float32)
                             for g in grads]).max()
    else:
        total = torch.stack([
            (g.to(torch.float32).abs() ** norm_type).sum() for g in grads
        ]).sum() ** (1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError(f"the total norm of order {norm_type} of the "
                           f"gradients is not finite")
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in grads:
        g.copy_(g * scale)
    return total


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    """Clamp every ``.grad`` to ``[-clip_value, clip_value]``."""
    for p in _with_grads(parameters):
        p.grad.clamp_(-clip_value, clip_value)
