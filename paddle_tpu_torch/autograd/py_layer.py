"""PyLayer: user-defined forward and backward over
``torch.autograd.Function``.

Counterpart of ``paddle_tpu/autograd/py_layer.py``. A ``PyLayer``
subclass defines ``forward(ctx, *args, **kwargs)`` and
``backward(ctx, *grads)`` as static methods; ``apply`` runs the forward
without recording a graph and hands the backward one cotangent per
output. Each subclass gets its own ``torch.autograd.Function`` the first
time it is applied. The ``ctx`` both methods see is a
:class:`PyLayerContext` over torch's: ``ctx.saved_tensor()`` is a method
and ``ctx.needs_input_grad`` a tuple over the positional arguments, as in
the reference, and attributes set on it in the forward are there in the
backward.

The backward returns one gradient for each tensor argument (None for
none). A gradient whose shape is not its input's raises ``RuntimeError``
naming the layer and both shapes; the reference stores such a gradient.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable  # noqa: F401

__all__ = ["PyLayer", "PyLayerContext", "once_differentiable"]


class PyLayerContext:
    """The ``ctx`` of a :class:`PyLayer`'s forward and backward."""

    def __init__(self, ctx):
        self._ctx = ctx

    def save_for_backward(self, *tensors):
        self._ctx.save_for_backward(*tensors)

    def saved_tensor(self):
        """The tensors of :meth:`save_for_backward`, as a tuple."""
        return tuple(self._ctx.saved_tensors)

    @property
    def needs_input_grad(self):
        return tuple(self._ctx.needs_input_grad[1:])


def _function(layer):
    """The ``torch.autograd.Function`` of the ``PyLayer`` subclass
    ``layer``. Its first argument carries the keyword arguments."""

    def forward(ctx, kwargs, *args):
        pctx = PyLayerContext(ctx)
        ctx.pyctx = pctx
        ctx.inputs = [(i, tuple(a.shape)) for i, a in enumerate(args)
                      if isinstance(a, torch.Tensor)]
        ctx.n_args = len(args)
        return layer.forward(pctx, *args, **kwargs)

    def backward(ctx, *grads):
        got = layer.backward(ctx.pyctx, *grads)
        got = tuple(got) if isinstance(got, (tuple, list)) else (got,)
        if len(got) > len(ctx.inputs):
            raise RuntimeError(
                f"{layer.__name__}.backward returned {len(got)} gradients "
                f"for {len(ctx.inputs)} tensor inputs")
        out = [None] * ctx.n_args
        for (i, shape), g in zip(ctx.inputs, got):
            if g is not None and tuple(g.shape) != shape:
                raise RuntimeError(
                    f"{layer.__name__}.backward returned a gradient of "
                    f"shape {list(g.shape)} for input {i} of shape "
                    f"{list(shape)}")
            out[i] = g
        return (None, *out)

    return type(layer.__name__, (torch.autograd.Function,),
                {"forward": staticmethod(forward),
                 "backward": staticmethod(backward)})


class PyLayer:
    """Subclass it with ``forward(ctx, ...)`` and ``backward(ctx,
    *grads)`` static methods; call ``Layer.apply(*args, **kwargs)``."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        fn = cls.__dict__.get("_torch_function")
        if fn is None:
            fn = _function(cls)
            cls._torch_function = fn
        return fn.apply(kwargs, *args)
