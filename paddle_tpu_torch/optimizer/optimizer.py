"""Optimizers with the Paddle constructor names.

Counterpart of ``paddle_tpu/optimizer/optimizer.py`` (``Optimizer``,
``SGD``, ``Adam``, ``AdamW``). The reference writes each rule as a pure
function and jits it into the train step with the parameter and state
buffers donated; here the same rule runs eagerly under ``no_grad`` and
updates parameters, masters and moments in place, which is what the
donation achieves there. The arithmetic follows the reference step for
step:

- the step count is kept per parameter (``_step_counts``) and drives the
  bias correction;
- AdamW's decoupled decay ``work * (1 - lr * wd)`` is applied before the
  Adam update, and ``epsilon`` is added to ``sqrt(v_hat)``;
- ``multi_precision`` keeps an fp32 master (and fp32 moments) for every
  bf16/fp16 parameter, casts the gradient to fp32, and writes
  ``master.to(param dtype)`` back into the parameter; without it the
  gradient is cast to the parameter's dtype;
- ``grad_clip`` (``nn.ClipGradBy*``) runs on all gradients first.

No Pallas kernel stands behind these updates in the reference, so none
is written here: each step runs a handful of ``torch._foreach_*`` ops
over all parameters at one step count, which fuse the reference's
expressions (``addcmul``, ``addcdiv``) and so round at slightly other
places.
"""
from __future__ import annotations

import torch

__all__ = ["Optimizer", "SGD", "Adam", "AdamW"]

_LOW_PRECISION = (torch.bfloat16, torch.float16)


class Optimizer:
    """Base class: the eager step loop over the parameters; subclasses
    give ``_init_state`` and ``_update``."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError("parameters is required: the port's "
                             "optimizers have no global program to search")
        self._learning_rate = float(learning_rate)
        self._parameter_list = list(parameters)
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        if weight_decay is None:
            self._weight_decay = 0.0
        elif isinstance(weight_decay, (int, float)):
            self._weight_decay = float(weight_decay)
        else:  # an L2Decay-like object with _coeff
            self._weight_decay = float(getattr(weight_decay, "_coeff", 0.0))
        self._accumulators: dict = {}
        self._master_weights: dict = {}
        self._step_counts: dict = {}

    def get_lr(self):
        return self._learning_rate

    # -- the rule (subclasses) ------------------------------------------------

    def _init_state(self, work) -> dict:
        return {}

    def _update(self, works, grads, states, lr, step):
        """Update ``works`` (parameters or their fp32 masters) and their
        ``states`` in place, all at the 1-based count ``step``; one call
        covers every parameter at that count, with ``torch._foreach_*``
        ops."""
        raise NotImplementedError

    def _decays(self, param) -> bool:
        """Whether AdamW's decoupled decay applies to ``param``."""
        return False

    def _coupled_decay(self, grads, works):
        """L2 decay folded into the gradients (``weight_decay`` of SGD and
        Adam)."""
        if self._weight_decay:
            return torch._foreach_add(grads, works, alpha=self._weight_decay)
        return grads

    # -- eager step -----------------------------------------------------------

    @torch.no_grad()
    def step(self):
        """Clip the gradients (``grad_clip``), then update every
        parameter that has one."""
        params_grads = [(p, p.grad) for p in self._parameter_list
                        if p.requires_grad and p.grad is not None]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        lr = self.get_lr()
        by_step: dict = {}  # step count -> (works, grads, states)
        decayed, masters = [], []
        for p, g in params_grads:
            if g is None:
                continue
            key = id(p)
            step = self._step_counts.get(key, 0) + 1
            self._step_counts[key] = step
            if p.dtype in _LOW_PRECISION and self._multi_precision:
                work = self._master_weights.get(key)
                if work is None:
                    work = p.detach().to(torch.float32)
                    self._master_weights[key] = work
                g = g.to(torch.float32)
                masters.append((p, work))
            else:
                work = p
                g = g.to(p.dtype)
            state = self._accumulators.get(key)
            if state is None:
                state = self._accumulators[key] = self._init_state(work)
            if self._decays(p):
                decayed.append(work)
            works, grads, states = by_step.setdefault(step, ([], [], []))
            works.append(work)
            grads.append(g)
            states.append(state)
        if decayed:  # AdamW: before the Adam update
            torch._foreach_mul_(decayed, 1.0 - lr * self._decoupled_wd)
        for step, (works, grads, states) in by_step.items():
            self._update(works, grads, states, lr, step)
        for p, work in masters:
            p.copy_(work)  # rounds the fp32 master to p's dtype

    def clear_grad(self, set_to_zero=False):
        """Drop every gradient (or zero it in place)."""
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None


class SGD(Optimizer):
    """``param - lr * (grad + weight_decay * param)``."""

    def _update(self, works, grads, states, lr, step):
        torch._foreach_add_(works, self._coupled_decay(grads, works),
                            alpha=-lr)


class Adam(Optimizer):
    """Adam with bias correction by the parameter's own step count."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _init_state(self, work):
        return {"moment1": torch.zeros_like(work),
                "moment2": torch.zeros_like(work)}

    def _update(self, works, grads, states, lr, step):
        grads = self._coupled_decay(grads, works)
        b1, b2 = self._beta1, self._beta2
        m = [s["moment1"] for s in states]
        v = [s["moment2"] for s in states]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
        # work -= lr * m_hat / (sqrt(v_hat) + eps), the hats by 1 - beta**step
        denom = torch._foreach_div(v, 1 - b2 ** step)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self._epsilon)
        torch._foreach_addcdiv_(works, m, denom, value=-lr / (1 - b1 ** step))


class AdamW(Adam):
    """Adam with decoupled weight decay: ``work *= 1 - lr * weight_decay``
    before the Adam update, skipped for a parameter when
    ``apply_decay_param_fun(name)`` is false (``name``: the parameter's
    ``name`` attribute, or ``""`` without one, as in the reference)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        self._decoupled_wd = float(getattr(weight_decay, "_coeff",
                                           weight_decay))
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decays(self, param):
        if not self._decoupled_wd:
            return False
        fn = self._apply_decay_param_fun
        return fn is None or bool(fn(getattr(param, "name", None) or ""))
