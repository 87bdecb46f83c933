"""hapi callbacks (counterpart of ``paddle_tpu/hapi/callbacks.py``):
``Callback``, ``CallbackList``, ``ProgBarLogger``, ``ModelCheckpoint``,
``EarlyStopping``, ``LRSchedulerCallback``, ``ReduceLROnPlateau`` and
``config_callbacks``, with the reference's decisions. Not ported
(ROADMAP queue A.7): ``MonitorCallback``, the SLO bridge, ``VisualDL``
and ``WandbCallback``.
"""
from __future__ import annotations

import os
import time

import numpy as np


class Callback:
    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_train_error(self, error=None):
        """Fired (before the exception re-raises) when the fit loop dies —
        the hook that lets sinks flush a terminal record instead of
        leaving a truncated artifact. ``on_train_end`` is NOT called on
        the error path (parity: the reference only ends clean runs)."""
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if not name.startswith("on_"):
            raise AttributeError(name)

        def call(*args, **kwargs):
            for c in self.callbacks:
                getattr(c, name)(*args, **kwargs)

        return call


class ProgBarLogger(Callback):
    """Parity: hapi ProgBarLogger (per-epoch step/loss/metric lines)."""

    def __init__(self, log_freq=1, verbose=2):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._t0 = time.time()
        if self.verbose and self.epoch is not None:
            print(f"Epoch {epoch + 1}/{self.params.get('epochs')}")

    def on_train_batch_end(self, step, logs=None):
        logs = logs or {}
        if self.verbose > 1 and step % self.log_freq == 0:
            ips = (step + 1) / max(time.time() - self._t0, 1e-9)
            items = " - ".join(
                f"{k}: {np.asarray(v).item():.4f}"
                if np.ndim(v) == 0 or np.size(v) == 1 else f"{k}: {v}"
                for k, v in logs.items() if k != "batch_size")
            print(f"step {step + 1}/{self.steps or '?'} - {items}"
                  f" - {ips:.2f} step/s")

    def on_eval_end(self, logs=None):
        if self.verbose:
            logs = logs or {}
            items = " - ".join(
                f"{k}: {np.asarray(v).item():.4f}"
                if np.ndim(v) == 0 or np.size(v) == 1 else f"{k}: {v}"
                for k, v in logs.items() if k != "batch_size")
            print(f"Eval - {items}")


class ModelCheckpoint(Callback):
    """Parity: hapi ModelCheckpoint (save every N epochs)."""

    def __init__(self, save_freq=1, save_dir=None):
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    """Parity: hapi EarlyStopping."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        self.verbose = verbose
        if mode == "auto":
            mode = "min" if "loss" in monitor or "err" in monitor else "max"
        self.mode = mode
        self.stopped_epoch = 0
        self.wait = 0
        self.best = None
        self.stop_training = False

    def _better(self, cur, best):
        if self.mode == "min":
            return cur < best - self.min_delta
        return cur > best + self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        if self.monitor not in logs:
            return
        cur = float(np.asarray(logs[self.monitor]).reshape(-1)[0])
        if self.best is None or self._better(cur, self.best):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stop_training = True
                self.model.stop_training = True


class LRSchedulerCallback(Callback):
    """Parity: hapi LRScheduler callback — steps the optimizer's scheduler."""

    def __init__(self, by_step=True, by_epoch=False):
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler

        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if isinstance(lr, LRScheduler) else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()


def config_callbacks(callbacks=None, model=None, batch_size=None, epochs=None,
                     steps=None, verbose=2, save_freq=1, save_dir=None,
                     metrics=None, mode="train", log_freq=1):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        # cadence matches fit's loss-materialization windows, so the
        # printed values are host floats already — no extra device sync
        cbks.append(ProgBarLogger(log_freq=log_freq, verbose=verbose))
    if not any(isinstance(c, LRSchedulerCallback) for c in cbks):
        cbks.append(LRSchedulerCallback())
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks.append(ModelCheckpoint(save_freq, save_dir))
    lst = CallbackList(cbks)
    lst.set_model(model)
    lst.set_params({
        "batch_size": batch_size, "epochs": epochs, "steps": steps,
        "verbose": verbose, "metrics": metrics or [],
    })
    return lst


class ReduceLROnPlateau(Callback):
    """Parity: hapi ReduceLROnPlateau (`hapi/callbacks.py:1172`): shrink
    the optimizer LR by ``factor`` after ``patience`` epochs without
    improvement on ``monitor``."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0.0):
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        if mode == "auto":
            mode = "min" if "loss" in monitor or "err" in monitor else "max"
        self.mode = mode
        self.min_delta = abs(min_delta)
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.cooldown_counter = 0
        self.wait = 0
        self.best = None

    def _better(self, cur, best):
        if self.mode == "min":
            return cur < best - self.min_delta
        return cur > best + self.min_delta

    def _epoch_end(self, logs):
        logs = logs or {}
        if self.monitor not in logs:
            return
        cur = float(np.asarray(logs[self.monitor]).reshape(-1)[0])
        if self.cooldown_counter > 0:
            # cooldown epochs never count toward patience (Keras/paddle)
            self.cooldown_counter -= 1
            self.wait = 0
            if self.best is None or self._better(cur, self.best):
                self.best = cur
            return
        if self.best is None or self._better(cur, self.best):
            self.best = cur
            self.wait = 0
            return
        self.wait += 1
        if self.wait >= self.patience:
            opt = getattr(self.model, "_optimizer", None)
            if opt is None:
                return
            try:
                old = float(opt.get_lr())
            except Exception:
                return
            new = max(old * self.factor, self.min_lr)
            if new < old:
                opt.set_lr(new)
                if self.verbose:
                    print(f"ReduceLROnPlateau: lr {old:.3e} -> {new:.3e}")
            self.cooldown_counter = self.cooldown
            self.wait = 0

    # exactly one hook counts per epoch: train logs feed plain monitors,
    # eval logs feed 'eval_*' monitors (both fire every epoch when eval
    # data is present, so using both would double-count patience)
    def on_epoch_end(self, epoch, logs=None):
        if not self.monitor.startswith("eval_"):
            self._epoch_end(logs)

    def on_eval_end(self, logs=None):
        if not self.monitor.startswith("eval_"):
            return
        logs = logs or {}
        val = logs.get(self.monitor,
                       logs.get(self.monitor[len("eval_"):]))
        if val is not None:
            self._epoch_end({self.monitor: val})
