"""The grad switches and ``paddle.grad`` over torch's autograd.

Counterpart of ``paddle_tpu/autograd/tape.py``. The reference records a
tape of ``jax.vjp`` pullbacks; the port's tensors are torch's, whose
autograd records the graph, so this module keeps only the reference's
entry points and their rules:

- :class:`no_grad` and :class:`enable_grad` work as context managers and
  as decorators; :func:`set_grad_enabled` sets the mode, as the
  reference's setter does, and :func:`set_grad_enabled_ctx` sets it and
  puts the mode before back when used as a context manager;
- :func:`grad` seeds ones for an output without a cotangent (of any
  shape), raises ``NotImplementedError`` for ``create_graph=True``
  (``tape.py:296``) and the reference's ``RuntimeError`` for an input
  the outputs do not reach unless ``allow_unused``;
- :func:`run_backward` sweeps several roots at once, so roots that share
  intermediates consume the graph once.
"""
from __future__ import annotations

import torch

__all__ = ["no_grad", "enable_grad", "is_grad_enabled", "set_grad_enabled",
           "set_grad_enabled_ctx", "grad", "run_backward"]


class no_grad(torch.no_grad):  # noqa: N801 - the reference's spelling
    """Record no graph inside the block or the decorated function."""


class enable_grad(torch.enable_grad):  # noqa: N801
    """Record the graph inside the block or the decorated function (in
    a backward, for example, which runs without)."""


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(mode: bool) -> None:
    """Turn graph recording on or off from here on."""
    torch._C._set_grad_enabled(bool(mode))


def set_grad_enabled_ctx(mode: bool):
    """Set the mode now; as a context manager, put the mode before back
    on exit."""
    return torch.set_grad_enabled(bool(mode))


def _roots(outputs, cotangents):
    """``outputs`` and their cotangents as lists, ones where a cotangent
    is None."""
    if isinstance(outputs, torch.Tensor):
        outputs = [outputs]
    outputs = list(outputs)
    if cotangents is None:
        cotangents = [None] * len(outputs)
    elif isinstance(cotangents, torch.Tensor):
        cotangents = [cotangents]
    if len(cotangents) != len(outputs):
        raise ValueError(f"{len(cotangents)} cotangents for "
                         f"{len(outputs)} outputs")
    return outputs, [torch.ones_like(t) if g is None else
                     torch.as_tensor(g, dtype=t.dtype, device=t.device)
                     for t, g in zip(outputs, cotangents)]


def run_backward(tensors, grad_tensors=None, retain_graph=False):
    """Backward from every root of ``tensors`` in one sweep, adding into
    the leaves' ``.grad``; a missing cotangent is ones of its root's
    shape."""
    roots, cts = _roots(tensors, grad_tensors)
    torch.autograd.backward(roots, cts, retain_graph=bool(retain_graph))


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, allow_unused=False):
    """The gradients of ``outputs`` with respect to ``inputs``, leaving
    every ``.grad`` as it is: one tensor for a tensor ``inputs``, else a
    list (None for an unused input under ``allow_unused``)."""
    if create_graph:
        raise NotImplementedError(
            "create_graph=True is not supported, as in the reference's "
            "eager tape; use paddle_tpu_torch.autograd.functional "
            "(vjp/jvp/hessian) for higher-order gradients.")
    single = isinstance(inputs, torch.Tensor)
    inputs = [inputs] if single else list(inputs)
    roots, cts = _roots(outputs, grad_outputs)
    got = torch.autograd.grad(roots, inputs, cts,
                              retain_graph=bool(retain_graph),
                              allow_unused=True)
    if not allow_unused and any(g is None for g in got):
        raise RuntimeError(
            "One of the differentiated tensors appears to not have been "
            "used in the graph. Set allow_unused=True if this is the "
            "desired behavior.")
    got = [None if g is None else g.detach() for g in got]
    return got[0] if single else got
