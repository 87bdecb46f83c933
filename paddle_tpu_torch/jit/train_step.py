"""One training step: forward, backward, clip and optimizer update, as
one CUDA graph per batch signature on the card.

Counterpart of ``paddle_tpu/jit/train_step.py``. The reference traces
the whole step into one XLA program per signature (shapes, dtypes,
``training``, ``nan_check``) through ``exec_cache.get_or_compile``; the
port captures it as one CUDA graph per signature through
``jit/exec_cache.get_or_capture``:

- the first call of a signature on CUDA is an eager step on the capture
  stream (the warm-up a capture needs: it makes the optimizer's states
  and masters, outside the graph's pool), then the capture; every later
  call copies the batch into the graph's static inputs, writes the rate
  and the step count into the optimizer's device scalars
  (``optimizer._dev_scalars``; one pinned copy) and replays. The graph
  drops the gradients and its backward makes them anew in the graph's
  pool, at the same addresses every replay, where ``param.grad`` finds
  them. A call whose parameters, gradients, masters or states are no
  longer the tensors the graph binds (after ``clear_grad()`` or
  ``set_state_dict``) captures the signature again. Watched kernel
  wrappers' launch counts are added back per replay (``exec_cache``'s
  protocol); the eager first step counts its own launches. The model's
  buffers (BatchNorm's running statistics) are updated in place by the
  forward, inside the graph, and are among the addresses checked;
- a step that draws random numbers (in-kernel attention dropout, whose
  seed words are launch arguments a graph would freeze, or
  ``F.dropout``) runs eagerly on CUDA at every call: BERT and ERNIE
  train eagerly, the Llama on graphs. So does a step that runs a
  collective over gloo on CUDA tensors (gloo carries them through the
  host; ``distributed._comm.host_staged``); NCCL collectives are
  captured with the step. A step whose optimizer ZeRO shards
  (``group_sharded_parallel`` at world size > 1: its hooks drop and
  stash gradients, and offload copies through the host) is eager too;
  at world size 1 ZeRO is the identity and the step is captured;
- on the CPU every call is eager.

The ``auto_cast`` state is not part of the signature, as in the
reference: a signature's first call records the state it ran under, and
every later call of that signature runs under that state, on the CPU as
on CUDA (a graph captured outside ``auto_cast`` replays in fp32 inside
it).

``donate``: the port updates parameters, masters and optimizer states
in place whatever the flag says, which is what the reference's donation
achieves; ``optimizer.state_dict()`` returns copies, so a held
``state_dict`` stays valid (the reference's donation invalidates it).
The flag is kept and keyed.

``nan_check`` (``monitor/numerics.py``): the step keeps a copy of
everything it writes in place (the model's buffers before the forward;
parameters, masters, optimizer states before the update), runs the
update, and reduces one finite flag over the loss, the gradients and
every tensor the step wrote, as the reference's flag covers the loss,
the gradients, the new parameters and the new states. The host reads
that flag (the one host read a step); when it fails, the copies are
written back, states the step made are dropped and the step counter is
put back, so the buffers, parameters, masters and states are
bit-identical to before the call (the reference rebinds none of them,
``train_step.py:494-512``), and
:func:`numerics.isolate` replays the batch on them with the step's own
random state to name the first bad leaf (``param/...`` or
``opt_state/...`` for a value born in the update). On CUDA the copy,
the update and the flag are in the step's one graph; the copies live
in its pool. The price is one read and one write of the parameters,
masters and states a step, and their size in memory.
"""
from __future__ import annotations

import itertools
import time
import weakref
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from ..amp.auto_cast import _pushed, amp_state
from ..distributed import _comm
from ..framework import random
from ..monitor import numerics
from . import exec_cache

__all__ = ["TrainStep", "AsyncStepper", "MemoryAnalysis"]

_serial = itertools.count()


class MemoryAnalysis(NamedTuple):
    """The reference's ``memory_analysis`` fields, in bytes.
    ``temp_size_in_bytes``: what the graph's pool grew by when the
    signature was captured (its activations; None where nothing was
    captured: on the CPU, or for an eager signature); arguments:
    parameters, gradients, masters, optimizer states and the batch;
    outputs: the loss and flag; alias: what is updated in place
    (parameters, masters, states and the model's buffers)."""
    argument_size_in_bytes: int
    output_size_in_bytes: int
    alias_size_in_bytes: int
    temp_size_in_bytes: int | None
    generated_code_size_in_bytes: int


class _Sig:
    """What one batch signature holds: the amp state its first call ran
    under, and on CUDA its graph entries (None: eager), their cache keys,
    the addresses they bind and the pool growth of its capture."""
    __slots__ = ("amp", "graphs", "keys", "bind", "temp")

    def __init__(self, amp):
        self.amp = amp
        self.graphs = None
        self.keys = []
        self.bind = None
        self.temp = None


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


class TrainStep:
    """``step = TrainStep(model, opt, lambda m, x, y: m(x, y))``;
    ``loss = step(x, y)``.

    ``loss_fn(model, *batch)`` returns the scalar loss (default:
    ``model(*batch)`` is the loss). Each call reads the optimizer's rate
    (``optimizer.get_lr()``, kept as ``last_lr``; stepping a scheduler
    stays the caller's job, as in the reference), drops the gradients,
    computes the loss, runs ``backward()`` and the optimizer's update
    (``grad_clip`` first), and returns the loss detached (a copy, on the
    model's device). Batch items may be tensors or arrays; they are
    moved to the model's device."""

    def __init__(self, model, optimizer, loss_fn=None, donate=False,
                 nan_check=None):
        self._model = model
        self._opt = optimizer
        self._loss_fn = loss_fn or (lambda m, *batch: m(*batch))
        self._donate = bool(donate)
        self._nan_check = nan_check
        self._cache: dict = {}  # signature -> _Sig
        self._active = None     # the _Sig of the call in progress
        self._serial = next(_serial)
        self._buf = None        # the device scalars (_scalars)
        self._keys: list = []
        self.last_lr = None
        weakref.finalize(self, _drop_all, self._keys)

    # -- signature ------------------------------------------------------------

    @property
    def _device(self):
        return next(iter(self._model.parameters())).device

    def _batch(self, batch):
        """The batch's tensors on the model's device (arrays become
        tensors; None stays None, as an absent mask)."""
        dev = self._device
        out = []
        for b in batch:
            if b is None:
                out.append(None)
                continue
            t = b if isinstance(b, torch.Tensor) \
                else torch.as_tensor(np.asarray(b))
            out.append(t.to(dev, non_blocking=t.is_pinned()))
        return out

    def _nan_active(self) -> bool:
        if self._nan_check is not None:
            return bool(self._nan_check)
        return numerics.enabled()

    def _signature(self, batch):
        nan = self._nan_active()
        return (tuple(None if t is None else (tuple(t.shape), str(t.dtype))
                      for t in batch),
                bool(getattr(self._model, "training", True)), nan), nan

    def _amp_scope(self):
        """The amp state of the signature in progress (see the module
        note)."""
        return _pushed(self._active.amp)

    # -- the step's parts -------------------------------------------------------

    def _grads(self, batch):
        """Forward and backward, the gradients dropped first."""
        self._opt.clear_grad()
        with self._amp_scope():
            loss = self._loss_fn(self._model, *batch)
        loss.backward()
        return loss.detach()

    def _params(self):
        return [p for p in self._opt._parameter_list if p.requires_grad]

    def _buffers(self):
        """The model's buffers, which its forward may update in place
        (BatchNorm's running statistics)."""
        return list(self._model.buffers())

    def _live(self):
        """Every tensor the step writes in place: the model's buffers
        first, then each parameter, its master and its states."""
        opt = self._opt
        out = self._buffers()
        for p in self._params():
            out.append(p)
            if id(p) in opt._master_weights:
                out.append(opt._master_weights[id(p)])
            out.extend(v for _, v in sorted(
                opt._accumulators.get(id(p), {}).items()))
        return out

    def _held_grads(self, batch):
        """Forward and backward under nan_check: copies of the buffers
        the forward will update, then :meth:`_grads`. Returns (loss,
        the buffers' copies)."""
        held = [b.detach().clone() for b in self._buffers()]
        return self._grads(batch), held

    def _checked_update(self, loss, held):
        """The update under nan_check: copies of what it will overwrite
        (after ``held``, the buffers' copies from before the forward),
        the update, and one finite flag over the loss, the gradients and
        everything the step wrote. Returns (flag, live, copies)."""
        grads = [g for _, g in self._opt._params_grads()]
        live = self._live()
        copies = held + [t.detach().clone() for t in live[len(held):]]
        self._opt.step()
        flag = numerics.finite_all([loss] + grads + live)
        return flag, live, copies

    def _undo(self, live, copies, counters, made):
        """Put the model and the optimizer back as they were before a
        failed step: the copies written back, the states and masters it
        made dropped, the step counts restored."""
        opt = self._opt
        with torch.no_grad():
            torch._foreach_copy_(live, copies)
        opt._global_step, opt._step_counts = counters[0], dict(counters[1])
        for store, had in zip((opt._accumulators, opt._master_weights),
                              made):
            for k in set(store) - had:
                del store[k]

    def _counters(self):
        opt = self._opt
        return ((opt._global_step, dict(opt._step_counts)),
                (set(opt._accumulators), set(opt._master_weights)))

    def _fail(self, batch, rng, lr):
        """The flag failed and the update is undone: name the leaf and
        raise; the step counter stays where it was."""
        leaf, kind = numerics.isolate(self, batch, rng, lr)
        raise numerics.NonFiniteError(self._opt._global_step + 1, leaf, kind)

    def _eager(self, batch, nan, lr):
        if not nan:
            loss = self._grads(batch)
            self._opt.step()
            return loss
        rng = random.get_state()
        loss, held = self._held_grads(batch)
        counters, made = self._counters()
        flag, live, copies = self._checked_update(loss, held)
        if not bool(flag):
            self._undo(live, copies, counters, made)
            self._fail(batch, rng, lr)
        return loss

    # -- CUDA graphs ----------------------------------------------------------

    def _key(self, sig, part):
        """The exec-cache key: the reference's fields, plus this step's
        serial number, since the graph binds this step's parameters,
        gradients, states and scalar buffer."""
        model, opt = self._model, self._opt
        config = getattr(model, "config", None)
        return {
            "kind": "train_step", "part": part, "owner": self._serial,
            "model": type(model).__module__ + "." + type(model).__qualname__,
            "config": None if config is None
            else repr(sorted(vars(config).items())),
            "params": tuple((n, exec_cache.array_spec(p))
                            for n, p in model.named_parameters()
                            if p.requires_grad),
            "opt": (type(opt).__qualname__, opt._multi_precision,
                    repr(opt._grad_clip)),
            "donate": self._donate, "batch": sig[0], "training": sig[1],
            "nan_check": sig[2],
        }

    def _scalars(self):
        """This step's ``[lr, step]`` float64 buffer on the device, which
        its graphs' updates read (``optimizer._dev_scalars`` while
        captured)."""
        if self._buf is None:
            self._buf = torch.zeros(2, dtype=torch.float64,
                                    device=self._device)
        return self._buf

    def _bindings(self):
        """The addresses a captured step binds: each parameter's, its
        gradient's, master's and states', and the model's buffers'. A
        replay checks them: after ``clear_grad()``, ``set_state_dict``
        or a reassigned parameter or buffer the signature is captured
        again instead of replaying into memory its tensors no longer
        own."""
        opt = self._opt

        def ptr(t):
            return None if t is None else t.data_ptr()

        return tuple(
            (ptr(p), ptr(p.grad), ptr(opt._master_weights.get(id(p))),
             tuple(ptr(v) for _, v in sorted(
                 opt._accumulators.get(id(p), {}).items())))
            for p in self._params()) + tuple(
                ptr(b) for b in self._buffers())

    def _counted(self):
        """The ids of the parameters a captured update steps; raises when
        their step counts differ (one captured step updates them all at
        one count)."""
        ids = [id(p) for p in self._params() if p.grad is not None]
        counts = {self._opt._step_counts.get(i, 0) for i in ids}
        if len(counts) > 1:
            raise RuntimeError(
                f"TrainStep: the parameters are at different step counts "
                f"{sorted(counts)}; a captured step updates them together")
        return ids

    def _capture(self, rec, sig, batch, nan):
        """Capture the signature's graphs after its eager first step."""
        from ..ops.cuda import flash_attention as fa
        from ..ops.cuda import head_flash as hf
        from ..ops.cuda import paged_attention as pa

        counters = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
                    hf.hb_fwd, hf.hb_bwd_dq, hf.hb_bwd_dkv,
                    pa.paged_attend, pa.paged_attend_int8)
        opt = self._opt
        inputs = {f"b{i}": t.clone() for i, t in enumerate(batch)
                  if t is not None}
        buf = self._scalars()
        n = len(batch)
        snap = (opt._global_step, dict(opt._step_counts))

        def whole(**st):
            batch = [st.get(f"b{i}") for i in range(n)]
            if nan:
                loss, held = self._held_grads(batch)
                flag, _, copies = self._checked_update(loss, held)
                return loss, flag, copies
            loss = self._grads(batch)
            opt.step()
            return loss

        label = f"train_step/{type(self._model).__name__}"
        # a capture empties the allocator's cache as it begins; empty it
        # first, so that the growth read below is the graph pool's alone
        torch.cuda.synchronize(self._device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self._device)
        opt._dev_scalars = buf
        try:
            key = self._key(sig, "step")
            self._keys.append(key)
            rec.keys.append(key)
            graphs = {"step": exec_cache.get_or_capture(
                key, whole, inputs, label, counters, warmup=False)}
        finally:
            opt._dev_scalars = None
            opt._global_step, opt._step_counts = snap[0], snap[1]
        rec.temp = torch.cuda.memory_reserved(self._device) - reserved
        rec.graphs = graphs
        rec.bind = self._bindings()

    def _first_cuda(self, rec, sig, batch, nan, lr):
        dev = self._device
        side = exec_cache.side_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        marks = (random.draws(), _comm.host_staged())
        with torch.cuda.stream(side):
            loss = self._eager(batch, nan, lr)
        torch.cuda.current_stream(dev).wait_stream(side)
        if (random.draws(), _comm.host_staged()) == marks:
            self._counted()
            self._capture(rec, sig, batch, nan)
        return loss

    def _advance(self):
        """Host bookkeeping of one captured update: the step counts, and
        the rate and step written for the replay."""
        opt = self._opt
        ids = self._counted()
        for i in ids:
            opt._step_counts[i] = opt._step_counts.get(i, 0) + 1
        opt._global_step += 1
        step = opt._step_counts[ids[0]] if ids else opt._global_step
        host = torch.tensor([float(opt.get_lr()), float(step)],
                            dtype=torch.float64).pin_memory()
        self._scalars().copy_(host, non_blocking=True)

    def _replay(self, rec, batch, nan, lr):
        entry = rec.graphs["step"]
        for i, t in enumerate(batch):
            if t is not None:
                entry.inputs[f"b{i}"].copy_(t, non_blocking=True)
        if not nan:
            self._advance()
            return entry.replay().clone()
        counters, made = self._counters()
        live = self._live()
        self._advance()
        loss, flag, copies = entry.replay()
        loss = loss.clone()
        if not bool(flag):
            self._undo(live, copies, counters, made)
            self._fail(batch, random.get_state(), lr)
        return loss

    # -- the call ---------------------------------------------------------------

    def __call__(self, *batch):
        batch = self._batch(batch)
        sig, nan = self._signature(batch)
        lr = self._opt.get_lr()
        self.last_lr = lr
        rec = self._cache.get(sig)
        first = rec is None
        if first:
            rec = _Sig(amp_state())
        self._active = rec
        if self._device.type != "cuda" or self._opt._zero is not None:
            self._cache[sig] = rec
            return self._eager(batch, nan, lr)
        if not first and rec.graphs is not None \
                and rec.bind != self._bindings():
            for key in rec.keys:  # capture again, on the current tensors
                exec_cache.drop(key)
            rec.keys, rec.graphs, first = [], None, True
        if first:
            loss = self._first_cuda(rec, sig, batch, nan, lr)
            self._cache[sig] = rec
            return loss
        if rec.graphs is None:
            return self._eager(batch, nan, lr)
        return self._replay(rec, batch, nan, lr)

    # -- introspection ----------------------------------------------------------

    @property
    def compiled_count(self):
        """Signatures seen (one graph set each on CUDA)."""
        return len(self._cache)

    def exec_cache_key(self, *batch):
        """The exec-cache key this batch's signature captures under."""
        sig, _ = self._signature(self._batch(batch))
        return self._key(sig, "step")

    def memory_analysis(self, *batch):
        """Byte accounting of the step for this batch signature
        (:class:`MemoryAnalysis`, the reference's field names); the pool
        growth is read only from a signature already captured."""
        tensors = self._batch(batch)
        sig, _ = self._signature(tensors)
        rec = self._cache.get(sig)
        opt = self._opt
        params = self._params()
        states = [v for p in params
                  for v in opt._accumulators.get(id(p), {}).values()]
        masters = [opt._master_weights[id(p)] for p in params
                   if id(p) in opt._master_weights]
        grads = [p.grad for p in params if p.grad is not None]
        alias = (_nbytes(params) + _nbytes(states) + _nbytes(masters)
                 + _nbytes(self._buffers()))
        tensors = [t for t in tensors if t is not None]
        return MemoryAnalysis(
            argument_size_in_bytes=alias + _nbytes(grads) + _nbytes(tensors),
            output_size_in_bytes=4 + (1 if sig[2] else 0),
            alias_size_in_bytes=alias,
            temp_size_in_bytes=None if rec is None else rec.temp,
            generated_code_size_in_bytes=0)


def _drop_all(keys):
    for k in keys:
        exec_cache.drop(k)


class AsyncStepper:
    """Bounded in-flight stepping over a :class:`TrainStep` (counterpart
    of the reference's ``AsyncStepper``).

    Each call dispatches one step and returns its loss as a device tensor
    without waiting for it; at most ``max_in_flight`` steps stay
    unfenced: past the bound the oldest step's CUDA event (recorded after
    its loss) is waited on, and the wait is added to ``host_blocked_s``.
    On the CPU a step is done when it returns."""

    def __init__(self, train_step, max_in_flight=2):
        if max_in_flight < 1:
            raise ValueError(
                f"AsyncStepper: max_in_flight must be >= 1 "
                f"(got {max_in_flight})")
        self._step = train_step
        self._max = int(max_in_flight)
        self._inflight: deque = deque()
        self.host_blocked_s = 0.0

    @staticmethod
    def _fence(item):
        _, event = item
        if event is not None:
            event.synchronize()

    def __call__(self, *batch):
        loss = self._step(*batch)
        event = None
        if loss.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(loss.device))
        self._inflight.append((loss, event))
        if len(self._inflight) > self._max:
            t0 = time.perf_counter()
            self._fence(self._inflight.popleft())
            self.host_blocked_s += time.perf_counter() - t0
        return loss

    def drain(self):
        """Fence every step in flight; returns the last loss (or None)."""
        last = self._inflight[-1][0] if self._inflight else None
        t0 = time.perf_counter()
        while self._inflight:
            self._fence(self._inflight.popleft())
        self.host_blocked_s += time.perf_counter() - t0
        return last

    @property
    def in_flight(self):
        return len(self._inflight)

    @property
    def max_in_flight(self):
        return self._max

    @property
    def compiled_count(self):
        return self._step.compiled_count

    def memory_analysis(self, *batch):
        return self._step.memory_analysis(*batch)
