"""hapi: the Keras-like high-level ``Model`` (counterpart of
``paddle_tpu/hapi/model.py``).

``fit`` drives :class:`~paddle_tpu_torch.jit.TrainStep` through an
:class:`~paddle_tpu_torch.jit.AsyncStepper`: on the card every batch is
one CUDA-graph replay, and the per-step loss stays on the device; the
logs carry lazy scalars that are read to the host (one transfer) every
``log_freq`` steps and at the end of an epoch. Callbacks, metrics, the
DataLoader and ``save``/``load`` keep the reference's surface.

Differences from the reference, by design:

- ``prepare(optimizer)`` without a ``loss`` builds the train step too:
  the network then receives the whole batch and returns its own loss
  (a causal LM given ids and labels). The reference builds no step
  without a loss, and its ``fit`` stops at its ``prepare`` assertion.

As in the reference, ``prepare(amp_configs=...)`` and
``fit(accumulate_grad_batches=...)`` are accepted and have no effect:
mixed precision is the caller's ``amp.auto_cast`` around the calls, and
every batch is one update.

Not ported: ``checkpoint_dir``, ``resume_from`` and ``nan_policy``
(resilience, ROADMAP queue A.6), ``shard_plan`` (A.6) and
``device_prefetch`` (A.7): passing one raises ``NotImplementedError``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..io.reader import DataLoader
from ..jit.train_step import AsyncStepper, TrainStep
from .callbacks import config_callbacks

__all__ = ["Model"]


def _to_tensor_list(batch):
    items = batch if isinstance(batch, (list, tuple)) else [batch]
    return [b if isinstance(b, torch.Tensor)
            else torch.as_tensor(np.asarray(b)) for b in items]


def _fetch_scalars(tensors):
    """One host transfer for a list of device scalars."""
    flat = torch.stack([t.detach().reshape(-1)[0].to(torch.float32)
                        for t in tensors])
    return [float(v) for v in flat.cpu().tolist()]


class _LazyLoss:
    """A deferred training loss: number-like, read to the host on first
    use (the reference's ``_LazyLoss``)."""

    __slots__ = ("_tensor", "_value")

    def __init__(self, tensor):
        self._tensor = tensor
        self._value = None

    def _materialize(self):
        if self._value is None:
            self._value = _fetch_scalars([self._tensor])[0]
        return self._value

    def __float__(self):
        return self._materialize()

    def __array__(self, dtype=None, copy=None):
        a = np.asarray(self._materialize())
        return a.astype(dtype) if dtype is not None else a

    def item(self):
        return self._materialize()

    def __lt__(self, other):
        return self._materialize() < other

    def __le__(self, other):
        return self._materialize() <= other

    def __gt__(self, other):
        return self._materialize() > other

    def __ge__(self, other):
        return self._materialize() >= other

    def __eq__(self, other):
        return self._materialize() == other

    def __hash__(self):
        return object.__hash__(self)

    def __repr__(self):
        return (f"{self._value!r}" if self._value is not None
                else "<lazy device scalar>")


def _materialize_logs(logs):
    """``logs`` with every lazy scalar read to the host in one
    transfer."""
    out = dict(logs)
    todo = {k: v for k, v in logs.items()
            if isinstance(v, (torch.Tensor, _LazyLoss))}
    done = {k: v._value for k, v in todo.items()
            if isinstance(v, _LazyLoss) and v._value is not None}
    out.update(done)
    todo = {k: v for k, v in todo.items() if k not in done}
    if todo:
        vals = _fetch_scalars([v._tensor if isinstance(v, _LazyLoss) else v
                               for v in todo.values()])
        out.update(zip(todo, vals))
    return out


_NOT_PORTED = {"checkpoint_dir": "A.6 (resilience)",
               "resume_from": "A.6 (resilience)",
               "nan_policy": "A.6 (resilience)",
               "shard_plan": "A.6 (distributed)",
               "device_prefetch": "A.7 (io/prefetch.py)"}


class Model:
    """``paddle.Model(network, inputs=None, labels=None)``."""

    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._train_step = None
        self.stop_training = False

    # -- setup --
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is None:
            self._metrics = []
        elif isinstance(metrics, (list, tuple)):
            self._metrics = list(metrics)
        else:
            self._metrics = [metrics]
        if optimizer is not None:
            self._train_step = TrainStep(self.network, optimizer,
                                         self._loss_fn)
        return self

    def _split(self, batch):
        n_in = len(batch) - 1 if len(batch) > 1 else 1
        return batch[:n_in], batch[n_in:]

    def _loss_fn(self, net, *batch):
        if self._loss is None:  # the network computes its own loss
            return net(*batch)
        inputs, labels = self._split(batch)
        outs = net(*inputs)
        loss = self._loss(outs, *labels)
        return loss.mean() if loss.dim() else loss

    # -- per-batch ops --
    def train_batch(self, inputs, labels=None, update=True):
        """One step; returns ``[loss]`` as a host array."""
        batch = _to_tensor_list(inputs) + (
            _to_tensor_list(labels) if labels is not None else [])
        loss = self._train_step(*batch)
        return [loss.detach().cpu().numpy()]

    @torch.no_grad()
    def _eval_batch_lazy(self, inputs, labels=None):
        """Forward and loss with the loss left on the device; the metrics
        update on the host. Returns the mean loss tensor or None."""
        batch = _to_tensor_list(inputs)
        labels = _to_tensor_list(labels) if labels is not None else []
        dev = next(iter(self.network.parameters())).device
        batch = [t.to(dev) for t in batch]
        labels = [t.to(dev) for t in labels]
        if self._loss is None and labels:
            outs = loss = self.network(*batch, *labels)
        else:
            outs = self.network(*batch)
            loss = None
            if self._loss is not None and labels:
                loss = self._loss(outs, *labels)
                loss = loss.mean() if loss.dim() else loss
        for m in self._metrics:
            m.update(*[np.asarray(x) for x in m.compute(outs, *labels)])
        return loss

    def eval_batch(self, inputs, labels=None):
        loss = self._eval_batch_lazy(inputs, labels)
        return [] if loss is None else [float(loss)]

    @torch.no_grad()
    def predict_batch(self, inputs):
        dev = next(iter(self.network.parameters())).device
        outs = self.network(*[t.to(dev) for t in _to_tensor_list(inputs)])
        if isinstance(outs, (list, tuple)):
            return [o.detach().cpu().numpy() for o in outs]
        return [outs.detach().cpu().numpy()]

    # -- loops --
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None, max_in_flight=2,
            device_prefetch=0, nan_check=None, resume_from=None,
            checkpoint_dir=None, checkpoint_keep=None, nan_policy=None,
            shard_plan=None):
        """``paddle.Model.fit``: ``epochs`` over ``train_data`` (a Dataset
        or a DataLoader) through the prepared train step, at most
        ``max_in_flight`` steps ahead of the host; losses are read every
        ``log_freq`` steps; ``num_iters`` stops an epoch after that many
        batches; ``nan_check`` arms the numerics sentinel for this fit
        (restored after); ``eval_data`` is evaluated every ``eval_freq``
        epochs; ``save_dir`` saves every ``save_freq`` epochs and at the
        end (``ModelCheckpoint``)."""
        assert self._train_step is not None, "call prepare() first"
        for name, value in (("checkpoint_dir", checkpoint_dir),
                            ("resume_from", resume_from),
                            ("nan_policy", nan_policy),
                            ("shard_plan", shard_plan),
                            ("device_prefetch", device_prefetch or None)):
            if value is not None:
                raise NotImplementedError(
                    f"fit({name}=...) is not ported (ROADMAP queue "
                    f"{_NOT_PORTED[name]})")
        loader = train_data if isinstance(train_data, DataLoader) else \
            DataLoader(train_data, batch_size=batch_size, shuffle=shuffle,
                       drop_last=drop_last, num_workers=num_workers)
        try:
            steps = len(loader)
        except TypeError:
            steps = None
        cbks = config_callbacks(
            callbacks, model=self, epochs=epochs, steps=steps,
            batch_size=batch_size, verbose=verbose, save_freq=save_freq,
            save_dir=save_dir, metrics=[m.name() for m in self._metrics],
            log_freq=log_freq)
        self.stop_training = False
        cbks.on_train_begin()
        self.network.train()
        stepper = AsyncStepper(self._train_step, max_in_flight=max_in_flight)
        prev_nan_check = self._train_step._nan_check
        if nan_check is not None:
            self._train_step._nan_check = bool(nan_check)
        try:
            for epoch in range(epochs):
                cbks.on_epoch_begin(epoch)
                it = 0
                logs = {}
                for step, batch in enumerate(loader):
                    cbks.on_train_batch_begin(step)
                    tensors = _to_tensor_list(batch)
                    loss = stepper(*tensors)
                    logs = {"loss": _LazyLoss(loss)}
                    if step % log_freq == 0:
                        logs = _materialize_logs(logs)
                    cbks.on_train_batch_end(step, logs)
                    it += 1
                    if num_iters is not None and it >= num_iters:
                        break
                stepper.drain()
                logs = _materialize_logs(logs)
                cbks.on_epoch_end(epoch, logs)
                if eval_data is not None and (epoch + 1) % eval_freq == 0:
                    self.evaluate(eval_data, batch_size=batch_size,
                                  verbose=verbose, callbacks=callbacks)
                    self.network.train()
                if self.stop_training:
                    break
        except BaseException as e:  # noqa: BLE001 — tell callbacks, re-raise
            cbks.on_train_error(f"{type(e).__name__}: {e}")
            raise
        finally:
            self._train_step._nan_check = prev_nan_check
        cbks.on_train_end()

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        loader = eval_data if isinstance(eval_data, DataLoader) else \
            DataLoader(eval_data, batch_size=batch_size, shuffle=False,
                       num_workers=num_workers)
        cbks = config_callbacks(callbacks, model=self, verbose=verbose,
                                mode="eval")
        self.network.eval()
        for m in self._metrics:
            m.reset()
        losses = []
        cbks.on_eval_begin()
        for batch in loader:
            inputs, labels = self._split(_to_tensor_list(batch))
            res = self._eval_batch_lazy(inputs, labels)
            if res is not None:
                losses.append(res)
        logs = {}
        if losses:
            logs["loss"] = float(np.mean(_fetch_scalars(losses)))
        for m in self._metrics:
            acc = m.accumulate()
            names = m.name()
            if isinstance(names, (list, tuple)):
                vals = acc if isinstance(acc, (list, tuple)) else [acc]
                logs.update(zip(names, vals))
            else:
                logs[names] = acc
        cbks.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = test_data if isinstance(test_data, DataLoader) else \
            DataLoader(test_data, batch_size=batch_size, shuffle=False,
                       num_workers=num_workers)
        self.network.eval()
        outputs = []
        for batch in loader:
            batch = _to_tensor_list(batch)
            n_in = (len(self._inputs) if self._inputs
                    else len(batch) - 1 if len(batch) > 1 else 1)
            outputs.append(self.predict_batch(batch[:n_in]))
        if stack_outputs and outputs:
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(len(outputs[0]))]
        return outputs

    # -- persistence: path.pdparams (network) and path.pdopt (optimizer) --
    def save(self, path, training=True):
        dirname = os.path.dirname(path)
        if dirname:
            os.makedirs(dirname, exist_ok=True)
        torch.save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            torch.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        dev = next(iter(self.network.parameters())).device
        self.network.load_state_dict(
            torch.load(path + ".pdparams", map_location=dev))
        opt_path = path + ".pdopt"
        if (not reset_optimizer and self._optimizer is not None
                and os.path.exists(opt_path)):
            self._optimizer.set_state_dict(
                torch.load(opt_path, map_location=dev))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)
