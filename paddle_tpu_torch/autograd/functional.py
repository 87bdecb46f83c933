"""Functional derivatives: ``vjp``, ``jvp``, ``Jacobian``, ``jacobian``,
``hessian`` and ``vhp`` over ``torch.func``.

Counterpart of ``paddle_tpu/autograd/functional.py``, with its signatures
and its output layout: ``xs`` is a tensor or a list of them, and a
result has one entry per input (the tensor itself for a tensor ``xs``,
a list for a list; ``hessian`` a list of lists). A Jacobian has the
output's shape followed by the input's. ``v`` None means ones. The
results hold no graph.
"""
from __future__ import annotations

import torch
import torch.func as tf

__all__ = ["vjp", "jvp", "Jacobian", "jacobian", "hessian", "vhp"]


def _xs(xs):
    single = isinstance(xs, torch.Tensor)
    return single, ((xs,) if single else tuple(xs))


def _vs(v, like, single):
    if v is None:
        return tuple(torch.ones_like(x) for x in like)
    return (v,) if single else tuple(v)


def _detach(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_detach(o) for o in x)
    return x.detach() if isinstance(x, torch.Tensor) else x


def _one_or_list(got, single):
    got = _detach(list(got))
    return got[0] if single else got


def vjp(func, xs, v=None):
    """``(func(xs), v^T J)``; ``v`` None is ones of the output."""
    single, args = _xs(xs)
    out, pullback = tf.vjp(func, *args)
    if v is None:
        ct = tuple(torch.ones_like(o) for o in out) \
            if isinstance(out, tuple) else torch.ones_like(out)
    else:
        ct = tuple(v) if isinstance(out, tuple) else v
    return _detach(out), _one_or_list(pullback(ct), single)


def jvp(func, xs, v=None):
    """``(func(xs), J v)``; ``v`` None is ones of each input."""
    single, args = _xs(xs)
    out, tangent = tf.jvp(func, args, _vs(v, args, single))
    return _detach(out), _detach(tangent)


def _jacobians(func, args):
    return tf.jacrev(func, argnums=tuple(range(len(args))))(*args)


class Jacobian:
    """The Jacobian of ``func`` at ``xs``, computed when made: ``J[idx]``
    indexes it (for a list ``xs``, ``J[i]`` is the one of input ``i``);
    ``shape`` and ``numpy()`` are the first input's."""

    def __init__(self, func, xs, is_batched=False):
        single, args = _xs(xs)
        jac = _detach(_jacobians(func, args))
        self._jac = jac[0] if single else jac
        self._single = single

    def __getitem__(self, idx):
        return self._jac[idx]

    @property
    def shape(self):
        j = self._jac if self._single else self._jac[0]
        return list(j.shape)

    def numpy(self):
        return (self._jac if self._single else self._jac[0]).cpu().numpy()


def jacobian(func, xs, create_graph=False, allow_unused=False):
    """``func``'s Jacobian with respect to each input."""
    single, args = _xs(xs)
    return _one_or_list(_jacobians(func, args), single)


def hessian(func, xs, create_graph=False, allow_unused=False):
    """The Hessian of a scalar ``func``: a tensor for a tensor ``xs``,
    else the blocks ``[[d2f / dxi dxj]]``."""
    single, args = _xs(xs)
    h = _detach(tf.hessian(func, argnums=tuple(range(len(args))))(*args))
    if single:
        return h[0][0]
    return [list(row) for row in h]


def vhp(func, xs, v=None):
    """``(func(xs), v^T H)`` of a scalar ``func``; ``v`` None is ones."""
    single, args = _xs(xs)
    grads = tf.grad(func, argnums=tuple(range(len(args))))
    _, hv = tf.jvp(grads, args, _vs(v, args, single))
    with torch.no_grad():
        out = func(*args)
    return _detach(out), _one_or_list(hv, single)
