"""``paddle.incubate.autograd`` (counterpart of
``paddle_tpu/incubate/autograd.py``): the functional derivatives,
:class:`Hessian`, the prim-mode flag and :func:`forward_grad`.

The reference's prim mode lowers ops to primitives; the flag only
records it there and here. The reference's ``forward_grad`` raises (its
tape records reverse mode only); the port computes it on the recorded
graph by the double-vjp rule: with ``g(u) = J^T u``, ``J v`` is the
gradient of ``g(u) . v`` with respect to ``u``.
"""
from __future__ import annotations

import torch

from ..autograd.functional import Jacobian, hessian, jvp, vjp  # noqa: F401
from ..autograd.tape import grad  # noqa: F401

__all__ = ["Jacobian", "Hessian", "jvp", "vjp", "grad", "forward_grad",
           "enable_prim", "disable_prim", "prim_enabled"]


class Hessian:
    """The Hessian of a scalar ``func`` at ``xs``, computed when made;
    ``H[idx]`` indexes it."""

    def __init__(self, func, xs, is_batched=False):
        if is_batched:
            raise NotImplementedError(
                "batched Hessian: call it on each sample, as the "
                "reference asks")
        self._h = hessian(func, xs)

    def __getitem__(self, idx):
        return self._h[idx]

    @property
    def shape(self):
        return list(self._h.shape)


_prim = [False]


def enable_prim():
    _prim[0] = True


def disable_prim():
    _prim[0] = False


def prim_enabled():
    return _prim[0]


def forward_grad(outputs, inputs, grad_inputs=None):
    """``J v`` of ``outputs`` (computed, their graph kept) with respect
    to ``inputs`` along ``grad_inputs`` (None: ones); one tensor for a
    tensor ``outputs``, else a list."""
    single_out = isinstance(outputs, torch.Tensor)
    outs = [outputs] if single_out else list(outputs)
    ins = [inputs] if isinstance(inputs, torch.Tensor) else list(inputs)
    if grad_inputs is None:
        vs = [torch.ones_like(x) for x in ins]
    else:
        vs = [grad_inputs] if isinstance(grad_inputs, torch.Tensor) \
            else list(grad_inputs)
    us = [torch.zeros_like(o, requires_grad=True) for o in outs]
    with torch.enable_grad():
        g = torch.autograd.grad(outs, ins, us, create_graph=True,
                                allow_unused=True)
        pairs = [(a, v) for a, v in zip(g, vs)
                 if a is not None and a.requires_grad]
        jv = torch.autograd.grad(
            [a for a, _ in pairs], us, [v for _, v in pairs],
            allow_unused=True, retain_graph=True) if pairs else [None] * len(us)
    jv = [torch.zeros_like(o) if j is None else j.detach()
          for o, j in zip(outs, jv)]
    return jv[0] if single_out else jv
