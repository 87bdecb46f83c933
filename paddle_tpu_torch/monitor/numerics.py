"""Numerics sentinel: first-bad-step NaN/Inf isolation for the train step.

Counterpart of ``paddle_tpu/monitor/numerics.py``. Two phases, as there:

1. a cheap guard on every step while armed: ``jit.TrainStep`` reduces
   :func:`finite_all` over the loss and every gradient to one boolean on
   the device and reads that one value on the host before it updates;
2. on the first failure, :func:`isolate` replays the batch eagerly on
   the intact pre-step parameters with the step's own random numbers
   and names the first non-finite leaf in causal order: the loss, then
   each gradient, then each parameter's update and optimizer state
   (computed on copies), by the model's parameter names.

The raised :class:`NonFiniteError` carries the reference's ``step``,
``leaf`` and ``kind``. Arming follows the reference: ``enable()`` /
``PT_NANCHECK=1`` globally, or ``TrainStep(nan_check=True)`` per step.
"""
from __future__ import annotations

import os

import torch

__all__ = ["NonFiniteError", "enable", "disable", "enabled", "finite_all",
           "isolate"]

_enabled = os.environ.get("PT_NANCHECK", "") not in ("", "0")


class NonFiniteError(RuntimeError):
    """The sentinel tripped: ``step`` (1-based train-step index), ``leaf``
    (named path of the first non-finite leaf, e.g. ``grad/lm_head.weight``)
    and ``kind`` (``loss`` | ``grad`` | ``param`` | ``opt_state`` |
    ``unknown``)."""

    def __init__(self, step: int, leaf: str, kind: str):
        self.step = step
        self.leaf = leaf
        self.kind = kind
        super().__init__(
            f"non-finite value at train step {step}: first bad leaf "
            f"{leaf!r} ({kind}). The offending batch was replayed with "
            f"per-leaf checks; params were NOT updated by this step.")


def enabled() -> bool:
    return _enabled


def enable() -> None:
    """Arm the sentinel for every ``TrainStep`` whose ``nan_check`` is
    None (idempotent)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def finite_all(tensors):
    """One boolean tensor on the tensors' device: every floating tensor
    in ``tensors`` is finite (integer tensors are skipped). Each tensor's
    largest magnitude (``torch._foreach_norm`` at order inf, which NaN
    and inf carry through and no finite value overflows) is read in one
    pass, without a boolean copy of the tensor."""
    floats = [t for t in tensors
              if isinstance(t, torch.Tensor) and t.is_floating_point()]
    if not floats:
        return torch.ones((), dtype=torch.bool)
    peaks = torch._foreach_norm(floats, float("inf"), dtype=torch.float32)
    return torch.isfinite(torch.stack(peaks)).all()


def _finite(t) -> bool:
    return t is None or not t.is_floating_point() \
        or bool(torch.isfinite(t).all())


def isolate(train_step, batch, rng_state, lr) -> tuple:
    """Replay ``batch`` eagerly on the pre-step parameters (the caller has
    not updated them) with the random state ``rng_state`` the step
    started from, and return ``(leaf_name, kind)`` of the first
    non-finite leaf in causal order. The optimizer's parameters, states
    and masters are left as they were: updates are computed on copies;
    the model's buffers, which the replayed forward updates (BatchNorm's
    running statistics), are put back."""
    from ..framework import random

    model, opt = train_step._model, train_step._opt
    names = {id(p): n for n, p in model.named_parameters()}
    params = [p for p in opt._parameter_list if p.requires_grad]

    def name_of(p, i):
        return names.get(id(p), f"param[{i}]")

    saved = [p.grad for p in params]
    buffers = list(model.buffers())
    held = [b.detach().clone() for b in buffers]
    try:
        random.set_state(rng_state)
        for p in params:
            p.grad = None
        with train_step._amp_scope():
            loss = train_step._loss_fn(model, *batch)
        if not _finite(loss.detach()):
            return ("loss", "loss")
        loss.backward()
        grads = [p.grad for p in params]
    except Exception as e:  # noqa: BLE001 — the diagnosis must not crash
        return (f"<replay failed: {type(e).__name__}>", "unknown")
    finally:
        replay = [p.grad for p in params]
        for p, g in zip(params, saved):
            p.grad = g
        with torch.no_grad():
            for b, h in zip(buffers, held):
                b.copy_(h)
    for i, (p, g) in enumerate(zip(params, grads)):
        if not _finite(g):
            return (f"grad/{name_of(p, i)}", "grad")
    trial = opt._trial_updates(list(zip(params, replay)), lr)
    for i, (p, (work, state)) in enumerate(zip(params, trial)):
        if work is None:
            continue
        if not _finite(work):
            return (f"param/{name_of(p, i)}", "param")
        for k in sorted(state):
            if not _finite(state[k]):
                return (f"opt_state/{name_of(p, i)}/{k}", "opt_state")
    return ("<unlocated>", "unknown")
