"""Optimizers with the Paddle constructor names.

Counterpart of ``paddle_tpu/optimizer/optimizer.py`` (``Optimizer``,
``SGD``, ``Momentum``, ``Adagrad``, ``Adam``, ``AdamW``, ``Adamax``,
``RMSProp``, ``Lamb``, ``Adadelta``, ``L2Decay``, ``L1Decay``). The
reference writes each rule as a pure function and jits it into the train
step with the parameter and state buffers donated; here the same rule
runs eagerly under ``no_grad`` and updates parameters, masters and
states in place, which is what the donation achieves there. The
arithmetic follows the reference step for step:

- ``learning_rate`` is a float or an ``lr.LRScheduler``, read once per
  ``step()`` through :meth:`Optimizer.get_lr`;
- the step count is kept per parameter (``_step_counts``) and drives the
  bias corrections; ``_global_step`` counts ``step()`` calls;
- a parameter's ``optimize_attr["learning_rate"]`` scales the rate for
  it, and its ``regularizer`` (``L1Decay``: ``coeff * sign(param)``,
  ``L2Decay``: ``coeff * param``, added to the gradient) replaces the
  optimizer-level ``weight_decay``, which adds ``coeff * param`` whatever
  its type, as the reference reads only its coefficient. Lamb takes
  neither; AdamW's decoupled decay ``work * (1 - lr * wd)`` comes before
  the Adam update;
- ``multi_precision`` keeps an fp32 master (and fp32 states) for every
  bf16/fp16 parameter, casts the gradient to fp32, and writes
  ``master.to(param dtype)`` back into the parameter; without it the
  gradient is cast to the parameter's dtype;
- ``grad_clip`` (``nn.ClipGradBy*``) runs on all gradients first;
- a parameter's name (AdamW's ``apply_decay_param_fun`` and Lamb's
  ``exclude_from_weight_decay_fn`` receive it; ``state_dict`` keys
  start with it) comes from ``parameters`` given as ``(name, param)``
  pairs, as ``model.named_parameters()`` yields them: a torch
  ``Parameter`` has no settable ``name``, where the reference reads
  ``ParamAttr(name=...)``. Without one the name is ``""`` for the
  functions and ``param_{i}`` in ``state_dict``, as there.

No Pallas kernel stands behind these updates in the reference, so none
is written here: each step runs a handful of ``torch._foreach_*`` ops
over all parameters that share a step count, a rate, a regularizer and
the rule's own per-parameter setting, which fuse the reference's
expressions (``addcmul``, ``addcdiv``) and so round at slightly other
places. Lamb's trust ratio is a norm per parameter
(``torch._foreach_norm``), never one over the group.

ZeRO (``distributed.sharding.group_sharded_parallel``) sets
``_zero``, the plan that gives each parameter's gradient slice
(``_params_grads``), maps a parameter-shaped tensor to the part this
rank updates (``_zero.part``: a view of its slice under ``os`` and
``os_g``; under ``p_g_os`` the parameter is its slice already) and puts
the parameters back together after the update. Masters and states are
then made on slices, so the ``_foreach`` groups run over slices;
``state_dict`` gathers them whole. With ``_initial_state_placement``
set (offload, ``_offload_state``) the masters and states are kept where
it puts them (pinned host memory on CUDA); each parameter's are copied
to the device just before its own update and written back and dropped
just after it, so the device holds one parameter's at a time.

Capturable: ``jit.TrainStep`` captures the step as a CUDA graph, which
would freeze any Python number in it. While ``_dev_scalars`` holds a
float64 ``[lr, step]`` buffer on the device, ``step()`` reads the rate
and the step count from it (``_Group.lr`` and ``_Group.step`` are then
0-dim tensors, and the rules' rate and bias-correction factors are
device arithmetic: ``_add_scaled_`` and ``_addcdiv_scaled_`` take a
tensor factor), and the caller writes the buffer before each replay.
Eagerly (``_dev_scalars`` None) the factors stay Python floats and the
results are what they were. The captured step's factors are float64 on
the device instead of the host, then fp32 as in the eager kernels.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..distributed.shard import grad_layout
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adagrad", "Adam", "AdamW",
           "Adamax", "RMSProp", "Lamb", "Adadelta", "L2Decay", "L1Decay"]

_LOW_PRECISION = (torch.bfloat16, torch.float16)


class L2Decay:
    """``coeff * param`` added to the gradient."""

    def __init__(self, coeff=0.0):
        self._coeff = coeff


class L1Decay:
    """``coeff * sign(param)`` added to the gradient (as a parameter's
    ``regularizer``; at the optimizer level only ``coeff`` is read)."""

    def __init__(self, coeff=0.0):
        self._coeff = coeff


class _Group(NamedTuple):
    """What the parameters updated by one ``_update`` call share."""
    step: object   # the 1-based update count (an int, or a 0-dim tensor)
    lr: object     # the rate times the parameter's optimize_attr factor
    reg: tuple     # ("l1" | "l2", coeff), or () for the optimizer's decay
    key: object    # the rule's own per-parameter setting (_rule_key)


def _factor(c):
    """A rule's scalar factor as a ``_foreach`` op takes it: a Python
    float, or a 0-dim fp32 tensor when it was computed on the device."""
    return c.to(torch.float32) if isinstance(c, torch.Tensor) else c


def _add_scaled_(xs, ys, c):
    """``xs += c * ys`` for a float or a 0-dim tensor ``c``."""
    if isinstance(c, torch.Tensor):
        torch._foreach_add_(xs, torch._foreach_mul(ys, _factor(c)))
    else:
        torch._foreach_add_(xs, ys, alpha=c)


def _addcdiv_scaled_(xs, a, b, c):
    """``xs += c * a / b`` for a float or a 0-dim tensor ``c``. ``b`` is
    the caller's scratch: a tensor ``c`` is folded into it (``b / c``),
    so the update stays one fused ``addcdiv`` pass."""
    if isinstance(c, torch.Tensor):
        torch._foreach_div_(b, _factor(c))
        torch._foreach_addcdiv_(xs, a, b)
    else:
        torch._foreach_addcdiv_(xs, a, b, value=c)


def _regularizer(p):
    reg = getattr(p, "regularizer", None)
    if reg is None:
        return ()
    coeff = float(getattr(reg, "_coeff", 0.0))
    return ("l1" if isinstance(reg, L1Decay) else "l2", coeff)


class Optimizer:
    """Base class: the eager step loop over the parameters; subclasses
    give ``_init_state`` and ``_update``."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError("parameters is required: the port's "
                             "optimizers have no global program to search")
        self._learning_rate = learning_rate \
            if isinstance(learning_rate, LRScheduler) \
            else float(learning_rate)
        self._names: dict = {}  # id(param) -> name, when given
        self._parameter_list = []
        for p in parameters:
            if isinstance(p, tuple):
                name, p = p
                self._names[id(p)] = name
            self._parameter_list.append(p)
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
        self._global_step = 0
        self._dev_scalars = None  # [lr, step] on the device while captured
        # ZeRO's hooks (distributed.sharding.group_sharded_parallel; see
        # the module note): the plan, and where new state is kept
        self._zero = None
        self._initial_state_placement = None
        self._work_layout: dict = {}  # id(work) -> its layout, in a step

    @property
    def _offload_state(self):
        """Whether masters and states are kept off the device and staged
        to it one parameter at a time."""
        return self._initial_state_placement is not None

    def _name(self, p):
        """The parameter's name, or ``""`` (the reference's ``p.name or
        ""``)."""
        return self._names.get(id(p), "")

    # -- lr -------------------------------------------------------------------

    def get_lr(self):
        """The current rate: the scheduler's value, or the float."""
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return self._learning_rate

    def set_lr(self, value):
        """Set a float rate; raises when the rate is a scheduler."""
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError(
                "optimizer's learning rate is an LRScheduler; call "
                "scheduler.step()/set state instead")
        self._learning_rate = float(value)

    # -- the rule (subclasses) ------------------------------------------------

    def _init_state(self, work) -> dict:
        return {}

    def _rule_key(self, param):
        """The rule's own per-parameter setting, hashable (AdamW: whether
        the decoupled decay applies; Lamb: its weight decay)."""
        return None

    def _update(self, works, grads, states, group: _Group):
        """Update ``works`` (parameters or their fp32 masters) and their
        ``states`` in place; one call covers every parameter of
        ``group``, with ``torch._foreach_*`` ops."""
        raise NotImplementedError

    def _coupled_decay(self, grads, works, group: _Group):
        """Regularization folded into the gradients: the parameter's
        regularizer, else the optimizer's L2 ``weight_decay``."""
        if group.reg:
            kind, coeff = group.reg
            decay = torch._foreach_sign(works) if kind == "l1" else works
            return torch._foreach_add(grads, decay, alpha=coeff)
        if self._weight_decay:
            return torch._foreach_add(grads, works, alpha=self._weight_decay)
        return grads

    # -- eager step -----------------------------------------------------------

    def _part(self, p):
        """The part of parameter ``p`` (detached) this rank updates: all
        of it, or under ZeRO's ``os``/``os_g`` a view of its slice
        (``_zero.part``)."""
        t = p.detach()
        return t if self._zero is None else self._zero.part(p, t)

    def _keep(self, t):
        """A new state or master as it is kept between steps
        (``_initial_state_placement``: offload's host copy)."""
        place = self._initial_state_placement
        return t if place is None else place(t)

    def _params_grads(self):
        """``(param, gradient)`` for every trainable parameter that has
        one; under ZeRO each gradient is this rank's slice."""
        if self._zero is not None:
            return self._zero.params_grads(self._parameter_list)
        return [(p, p.grad) for p in self._parameter_list
                if p.requires_grad and p.grad is not None]

    def _work(self, p, g, create=True):
        """(the tensor the rule updates, the gradient as the rule takes
        it, the state, whether the first is a master): the fp32 master
        and an fp32 gradient for a bf16/fp16 parameter under
        ``multi_precision``, else the parameter (its slice's view under
        ZeRO) and the gradient in its dtype. States and masters are made
        at first use (``create``; a captured step finds them made) and
        kept by ``_keep``; under offload the ones returned are their
        device copies, which :meth:`_park` writes back: the caller holds
        them for one parameter's update only."""
        key = id(p)
        master = p.dtype in _LOW_PRECISION and self._multi_precision
        if master:
            work = self._master_weights.get(key)
            if work is None:
                work = self._part(p).to(torch.float32)
                if create:
                    self._master_weights[key] = self._keep(work)
            g = g.to(torch.float32)
        else:
            work, g = self._part(p), g.to(p.dtype)
        state = self._accumulators.get(key)
        if state is None:
            state = self._init_state(work)
            if create:
                self._accumulators[key] = {k: self._keep(v)
                                           for k, v in state.items()}
        if self._offload_state:
            dev = p.device
            work = work.to(dev, non_blocking=True)
            state = {k: v.to(dev, non_blocking=True)
                     for k, v in state.items()}
        return work, g, state, master

    def _park(self, p, work, state):
        """Offload: write a parameter's updated master and states back to
        where they are kept."""
        kept = self._accumulators[id(p)]
        for k, v in state.items():
            if kept[k] is not v:
                kept[k].copy_(v)
        m = self._master_weights.get(id(p))
        if m is not None and m is not work:
            m.copy_(work)

    def _lr_of(self, p, lr, rates):
        """The rate for ``p``: ``lr`` times its optimize_attr factor (one
        device tensor per factor, kept in ``rates``, while captured)."""
        attrs = getattr(p, "optimize_attr", None)
        f = float(attrs.get("learning_rate", 1.0)) if attrs else 1.0
        if not isinstance(lr, torch.Tensor):
            return lr * f if attrs else lr
        if f not in rates:
            rates[f] = lr * f if f != 1.0 else lr
        return rates[f]

    @torch.no_grad()
    def step(self):
        """Clip the gradients (``grad_clip``), then update every
        parameter that has one (under ZeRO: this rank's slices, then the
        parameters put back together; under offload one parameter at a
        time, its state staged to the device and back)."""
        params_grads = self._params_grads()
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self._global_step += 1
        dev = self._dev_scalars
        lr = self.get_lr() if dev is None else dev[0]
        rates: dict = {}
        groups: dict = {}  # _Group -> [(param, grad)]
        self._work_layout = {}
        for p, g in params_grads:
            if g is None:
                continue
            key = id(p)
            step = self._step_counts.get(key, 0) + 1
            self._step_counts[key] = step
            group = _Group(step if dev is None else dev[1],
                           self._lr_of(p, lr, rates), _regularizer(p),
                           self._rule_key(p))
            groups.setdefault(group, []).append((p, g))
        batches = [(group, [pg]) for group, pgs in groups.items()
                   for pg in pgs] if self._offload_state \
            else list(groups.items())
        for group, pgs in batches:
            self._apply(group, pgs)
        if self._zero is not None:
            self._zero.publish([p for p, g in params_grads if g is not None])

    def _apply(self, group, pgs):
        """One ``_update`` of ``group``'s ``(param, grad)`` pairs: their
        work tensors and states made (under offload staged to the
        device), updated, each master rounded into its parameter, and
        under offload written back. The staged copies die on return."""
        items = []
        for p, g in pgs:
            work, g, state, master = self._work(p, g)
            self._work_layout[id(work)] = grad_layout(p)
            items.append((p, work, g, state, master))
        _, works, grads, states, _ = zip(*items)
        self._update(list(works), list(grads), list(states), group)
        for p, work, _, state, master in items:
            if master:  # rounds the fp32 master to p's dtype
                self._part(p).copy_(work)
            if self._offload_state:
                self._park(p, work, state)

    @torch.no_grad()
    def _trial_updates(self, params_grads, lr):
        """What :meth:`step` would make of ``params_grads`` at rate
        ``lr``, computed on copies: a ``(work, state)`` pair for each
        parameter, ``(None, None)`` where its gradient is None. The
        optimizer is left as it was (the nan_check replay's last
        phase)."""
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((None, None))
                continue
            work, g, state, _ = self._work(p, g, create=False)
            work = work.detach().clone()
            self._work_layout[id(work)] = grad_layout(p)
            state = {k: v.clone() for k, v in state.items()}
            group = _Group(self._step_counts.get(id(p), 0) + 1,
                           self._lr_of(p, lr, {}), _regularizer(p),
                           self._rule_key(p))
            self._update([work], [g], [state], group)
            out.append((work, state))
        return out

    def clear_grad(self, set_to_zero=False):
        """Drop every gradient (or zero it in place), ZeRO's slices
        too."""
        if self._zero is not None:
            self._zero.clear_grads(set_to_zero)
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()``, then :meth:`step`."""
        loss.backward()
        self.step()
        return None, None

    # -- checkpoint -----------------------------------------------------------

    def state_dict(self):
        """A snapshot of the optimizer, keyed as the reference keys it:
        ``{name}.{state}`` (each state tensor, copied),
        ``{name}.master_weight``, ``{name}.step_count``, ``global_step``,
        and ``LR_Scheduler`` (the scheduler's ``state_dict``) when the
        rate is a scheduler. ``name`` is the name the parameter was
        given with (``(name, param)`` pairs), else ``param_{i}`` by its
        place in ``parameters``. Under ZeRO every tensor is the whole
        one, its slices all-gathered (collective: every rank calls it),
        as the reference's global arrays are."""
        sd = {}
        full = (lambda p, v: v.detach().clone()) if self._zero is None \
            else self._zero.full
        for i, p in enumerate(self._parameter_list):
            name = self._name(p) or f"param_{i}"
            for k, v in self._accumulators.get(id(p), {}).items():
                sd[f"{name}.{k}"] = full(p, v)
            mw = self._master_weights.get(id(p))
            if mw is not None:
                sd[f"{name}.master_weight"] = full(p, mw)
            sc = self._step_counts.get(id(p))
            if sc is not None:
                sd[f"{name}.step_count"] = sc
        sd["global_step"] = self._global_step
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    def set_state_dict(self, state_dict):
        """Load :meth:`state_dict`'s keys (copies, on each parameter's
        device, cut to this rank's slice under ZeRO and kept where
        ``_keep`` keeps them); a state the dict lacks starts as
        ``_init_state`` makes it, and a parameter with states but no step
        count takes the global step."""
        self._global_step = int(state_dict.get("global_step", 0))
        if "LR_Scheduler" in state_dict \
                and isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])

        def load(v, p):
            t = torch.as_tensor(v).detach().to(p.device, copy=True)
            return t if self._zero is None else self._zero.cut(p, t)

        for i, p in enumerate(self._parameter_list):
            name = self._name(p) or f"param_{i}"
            mk = f"{name}.master_weight"
            if mk in state_dict:
                self._master_weights[id(p)] = self._keep(
                    load(state_dict[mk], p))
            work = self._master_weights.get(id(p), self._part(p))
            st = self._init_state(work)
            found = False
            for k in st:
                if f"{name}.{k}" in state_dict:
                    st[k] = load(state_dict[f"{name}.{k}"], p)
                    found = True
            if found:
                self._accumulators[id(p)] = {k: self._keep(v)
                                             for k, v in st.items()}
            sk = f"{name}.step_count"
            if sk in state_dict:
                self._step_counts[id(p)] = int(state_dict[sk])
            elif found:
                self._step_counts[id(p)] = self._global_step


def _states(states, key):
    return [s[key] for s in states]


class SGD(Optimizer):
    """``param - lr * (grad + decay)``."""

    def _update(self, works, grads, states, group):
        _add_scaled_(works, self._coupled_decay(grads, works, group),
                     -group.lr)


class Momentum(Optimizer):
    """``v = momentum * v + grad``; ``param - lr * v``, or with
    ``use_nesterov`` ``param - lr * (grad + momentum * v)``."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_state(self, work):
        return {"velocity": torch.zeros_like(work)}

    def _update(self, works, grads, states, group):
        grads = self._coupled_decay(grads, works, group)
        v = _states(states, "velocity")
        torch._foreach_mul_(v, self._momentum)
        torch._foreach_add_(v, grads)
        if self._nesterov:
            _add_scaled_(works, torch._foreach_add(
                grads, v, alpha=self._momentum), -group.lr)
        else:
            _add_scaled_(works, v, -group.lr)


class Adagrad(Optimizer):
    """``moment += grad^2``; ``param - lr * grad / (sqrt(moment) +
    epsilon)``; the moment starts at ``initial_accumulator_value``."""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_state(self, work):
        return {"moment": torch.full_like(work, self._init_acc)}

    def _update(self, works, grads, states, group):
        grads = self._coupled_decay(grads, works, group)
        m = _states(states, "moment")
        torch._foreach_addcmul_(m, grads, grads)
        denom = torch._foreach_sqrt(m)
        torch._foreach_add_(denom, self._epsilon)
        _addcdiv_scaled_(works, grads, denom, -group.lr)


class Adam(Optimizer):
    """Adam with bias correction by the parameter's own step count;
    ``amsgrad`` divides by the running maximum of the second moment
    (kept as ``moment2_max``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, amsgrad=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._amsgrad = amsgrad

    def _init_state(self, work):
        s = {"moment1": torch.zeros_like(work),
             "moment2": torch.zeros_like(work)}
        if self._amsgrad:
            s["moment2_max"] = torch.zeros_like(work)
        return s

    def _update(self, works, grads, states, group):
        grads = self._coupled_decay(grads, works, group)
        b1, b2, step = self._beta1, self._beta2, group.step
        m = _states(states, "moment1")
        v = _states(states, "moment2")
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
        if self._amsgrad:
            v = _states(states, "moment2_max")
            torch._foreach_maximum_(v, _states(states, "moment2"))
        # work -= lr * m_hat / (sqrt(v_hat) + eps), the hats by 1 - beta**step
        denom = torch._foreach_div(v, _factor(1 - b2 ** step))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self._epsilon)
        _addcdiv_scaled_(works, m, denom, -group.lr / (1 - b1 ** step))


class AdamW(Adam):
    """Adam with decoupled weight decay: ``work *= 1 - lr * weight_decay``
    before the Adam update, skipped for a parameter when
    ``apply_decay_param_fun(name)`` is false (``name``: see the module
    note; ``""`` without one, as in the reference)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 amsgrad=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name,
                         amsgrad)
        self._decoupled_wd = float(getattr(weight_decay, "_coeff",
                                           weight_decay))
        self._apply_decay_param_fun = apply_decay_param_fun

    def _rule_key(self, param):
        if not self._decoupled_wd:
            return False
        fn = self._apply_decay_param_fun
        return fn is None or bool(fn(self._name(param)))

    def _update(self, works, grads, states, group):
        if group.key:
            torch._foreach_mul_(works,
                                _factor(1.0 - group.lr * self._decoupled_wd))
        super()._update(works, grads, states, group)


class Adamax(Optimizer):
    """``m = b1 m + (1 - b1) g``, ``u = max(b2 u, |g|)``; ``param - lr /
    (1 - b1^step) * m / (u + epsilon)``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_state(self, work):
        return {"moment": torch.zeros_like(work),
                "inf_norm": torch.zeros_like(work)}

    def _update(self, works, grads, states, group):
        grads = self._coupled_decay(grads, works, group)
        b1 = self._beta1
        m = _states(states, "moment")
        u = _states(states, "inf_norm")
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(u, self._beta2)
        torch._foreach_maximum_(u, torch._foreach_abs(grads))
        denom = torch._foreach_add(u, self._epsilon)
        _addcdiv_scaled_(works, m, denom, -group.lr / (1 - b1 ** group.step))


class RMSProp(Optimizer):
    """``ms = rho ms + (1 - rho) g^2``; ``mom = momentum * mom + lr * g /
    sqrt(ms + epsilon)``; ``param - mom``. ``centered`` also keeps
    ``mean_grad`` and divides by ``sqrt(ms - mean_grad^2 + epsilon)``."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_state(self, work):
        s = {"mean_square": torch.zeros_like(work),
             "momentum": torch.zeros_like(work)}
        if self._centered:
            s["mean_grad"] = torch.zeros_like(work)
        return s

    def _update(self, works, grads, states, group):
        grads = self._coupled_decay(grads, works, group)
        rho = self._rho
        ms = _states(states, "mean_square")
        torch._foreach_mul_(ms, rho)
        torch._foreach_addcmul_(ms, grads, grads, value=1 - rho)
        if self._centered:
            mg = _states(states, "mean_grad")
            torch._foreach_mul_(mg, rho)
            torch._foreach_add_(mg, grads, alpha=1 - rho)
            denom = torch._foreach_addcmul(ms, mg, mg, value=-1.0)
            torch._foreach_add_(denom, self._epsilon)
        else:
            denom = torch._foreach_add(ms, self._epsilon)
        torch._foreach_sqrt_(denom)
        mom = _states(states, "momentum")
        torch._foreach_mul_(mom, self._momentum)
        _addcdiv_scaled_(mom, grads, denom, group.lr)
        torch._foreach_sub_(works, mom)


class Lamb(Optimizer):
    """Layerwise adaptive large-batch steps: Adam's ``r = m_hat /
    (sqrt(v_hat) + epsilon)``, ``update = r + wd * param`` (``wd`` 0 for
    a parameter whose name ``exclude_from_weight_decay_fn`` accepts),
    then ``param - lr * trust * update`` with ``trust = ||param|| /
    ||update||`` of this parameter alone (1 where either norm is 0), in
    fp32 and cast to the parameter's (or master's) dtype; for a
    tensor-parallel parameter both norms are the global tensor's. Under
    ``multi_precision`` ``param`` is the fp32 master throughout."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_state(self, work):
        return {"moment1": torch.zeros_like(work),
                "moment2": torch.zeros_like(work)}

    def _rule_key(self, param):
        fn = self._exclude_fn
        if fn is not None and fn(self._name(param)):
            return 0.0
        return self._lamb_wd

    def _layouts(self, works):
        """The layout of each work's parameter (its tensor-parallel or
        ZeRO slice, ``shard.grad_layout``), None for a whole one: the
        trust ratio's norms are the global tensors'."""
        return [self._work_layout.get(id(w)) for w in works]

    def _update(self, works, grads, states, group):
        b1, b2, step = self._beta1, self._beta2, group.step
        m = _states(states, "moment1")
        v = _states(states, "moment2")
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
        denom = torch._foreach_div(v, _factor(1 - b2 ** step))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self._epsilon)
        update = torch._foreach_div(m, _factor(1 - b1 ** step))
        torch._foreach_div_(update, denom)
        if group.key:
            torch._foreach_add_(update, works, alpha=group.key)
        layouts = self._layouts(works)
        if any(lay is not None for lay in layouts):
            from ..distributed.shard import global_sq_norms

            w_norm = torch.sqrt(torch.stack(global_sq_norms(layouts, works)))
            u_norm = torch.sqrt(torch.stack(global_sq_norms(layouts,
                                                            update)))
        else:
            w_norm = torch.stack(torch._foreach_norm(works, 2,
                                                     dtype=torch.float32))
            u_norm = torch.stack(torch._foreach_norm(update, 2,
                                                     dtype=torch.float32))
        trust = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            1.0)
        torch._foreach_mul_(update, [t.to(w.dtype) for t, w in
                                     zip(trust.unbind(), works)])
        _add_scaled_(works, update, -group.lr)


class Adadelta(Optimizer):
    """``asg = rho asg + (1 - rho) g^2``; ``upd = sqrt(asu + epsilon) /
    sqrt(asg + epsilon) * g``; ``asu = rho asu + (1 - rho) upd^2``;
    ``param - lr * upd``."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = rho, epsilon

    def _init_state(self, work):
        return {"avg_squared_grad": torch.zeros_like(work),
                "avg_squared_update": torch.zeros_like(work)}

    def _update(self, works, grads, states, group):
        grads = self._coupled_decay(grads, works, group)
        rho, eps = self._rho, self._epsilon
        asg = _states(states, "avg_squared_grad")
        asu = _states(states, "avg_squared_update")
        torch._foreach_mul_(asg, rho)
        torch._foreach_addcmul_(asg, grads, grads, value=1 - rho)
        upd = torch._foreach_add(asu, eps)
        torch._foreach_sqrt_(upd)
        den = torch._foreach_add(asg, eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, grads)
        torch._foreach_mul_(asu, rho)
        torch._foreach_addcmul_(asu, upd, upd, value=1 - rho)
        _add_scaled_(works, upd, -group.lr)
