"""One training step: forward, backward, clip and optimizer update.

Counterpart of ``paddle_tpu/jit/train_step.py``. The reference traces
the whole step into one jitted XLA program with donated buffers;
PyTorch runs eagerly, so here the step is the same sequence of calls
and the optimizer updates in place. Not ported (ROADMAP queue A):
``donate``, ``nan_check``, ``AsyncStepper``, the executable cache key
and ``memory_analysis``.
"""
from __future__ import annotations

__all__ = ["TrainStep"]


class TrainStep:
    """``step = TrainStep(model, opt, lambda m, x, y: m(x, y))``;
    ``loss = step(x, y)``.

    ``loss_fn(model, *batch)`` returns the scalar loss (default:
    ``model(*batch)`` is the loss). Each call reads the optimizer's rate
    (``optimizer.get_lr()``: a scheduler's current value, kept as
    ``last_lr``; stepping the scheduler stays the caller's job, as in the
    reference), clears the gradients, computes the loss, runs
    ``backward()``, then ``optimizer.step()``, which applies the
    optimizer's ``grad_clip`` before updating at that rate, and returns
    the loss detached."""

    def __init__(self, model, optimizer, loss_fn=None):
        self._model = model
        self._opt = optimizer
        self._loss_fn = loss_fn or (lambda m, *batch: m(*batch))
        self.last_lr = None

    def __call__(self, *batch):
        self.last_lr = self._opt.get_lr()
        self._opt.clear_grad()
        loss = self._loss_fn(self._model, *batch)
        loss.backward()
        self._opt.step()
        return loss.detach()
