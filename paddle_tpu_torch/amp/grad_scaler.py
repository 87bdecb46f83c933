"""Dynamic loss scaling: ``GradScaler`` (counterpart of
``paddle_tpu/amp/grad_scaler.py``).

``scale`` multiplies the loss; ``unscale_`` divides every gradient by the
scale in place and sets ``found_inf`` from one device-side reduction over
all of them (one host read, in ``step``); ``step`` skips the update when
a gradient is not finite; ``update`` doubles the scale after
``incr_every_n_steps`` good steps and halves it (not below 1) after
``decr_every_n_nan_or_inf`` bad ones, with the reference's counters.
Needed for float16, whose largest value is 65504; under bfloat16 a
disabled scaler is the identity.
"""
from __future__ import annotations

import torch

__all__ = ["GradScaler", "AmpScaler"]


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5,
                 incr_every_n_steps=2000, decr_every_n_nan_or_inf=1,
                 use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return self._scale

    def scale(self, var):
        """The loss times the scale (``var`` itself when disabled)."""
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide the optimizer's gradients by the scale in place and note
        whether any is not finite."""
        if not self._enable or self._unscaled:
            return
        grads = [g for _, g in optimizer._params_grads()]
        found = False
        if grads:
            torch._foreach_div_(grads, self._scale)
            finite = torch.stack([torch.isfinite(g).all() for g in grads])
            found = not bool(finite.all())  # the one host read
        self._found_inf = found
        self._unscaled = True

    def step(self, optimizer):
        """``unscale_`` (unless done), then ``optimizer.step()`` unless a
        gradient was not finite."""
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._unscaled = False

    def update(self):
        """Adapt the scale after a step (dynamic scaling only)."""
        if not self._enable or not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def minimize(self, optimizer, scaled_loss):
        """``scaled_loss.backward()``, :meth:`step`, :meth:`update`."""
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def state_dict(self):
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every_n_steps,
            "decr_every_n_nan_or_inf": self._decr_every_n,
            "incr_count": self._good_steps,
            "decr_count": self._bad_steps,
            "use_dynamic_loss_scaling": self._dynamic,
        }

    def load_state_dict(self, state):
        self._scale = float(state.get("scale", self._scale))
        self._good_steps = int(state.get("incr_count", 0))
        self._bad_steps = int(state.get("decr_count", 0))
        self._dynamic = bool(
            state.get("use_dynamic_loss_scaling", self._dynamic))

    set_state_dict = load_state_dict


AmpScaler = GradScaler
