"""``apply``: the reference's op-dispatch entry, as the port needs it.

Counterpart of ``paddle_tpu/ops/dispatch.py:208``. There every eager op
runs through ``apply(op_name, fn, operands, **static)``: the AMP hook
casts the operands by the op's name, a registered Pallas kernel may take
the op over, and the tape records a VJP. In the port torch's autograd
records the graph and the kernels are called by name where a function
needs one, so ``apply`` keeps only the cast: it has no registry.
"""
from __future__ import annotations

from ..amp.auto_cast import cast_inputs

__all__ = ["apply"]


def apply(op_name, fn, operands, n_outputs=None, **static):
    """``fn(*operands, **static)`` with ``operands`` cast by
    ``amp.auto_cast``'s policy under ``op_name``. ``n_outputs`` is
    accepted for the reference's signature; the outputs are whatever
    ``fn`` returns."""
    return fn(*cast_inputs(op_name, *operands), **static)
