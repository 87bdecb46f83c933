"""The port's ``hapi.Model``, ``io`` and ``metric`` held against the JAX
package's on the CPU (a small fp32 classifier, weights copied across,
data from numpy seeds):

- ``fit`` over 3 epochs: the loss of every batch (read at each
  ``on_train_batch_end``) within 1e-5, the epoch-end and ``evaluate``
  logs within 1e-5, ``predict`` outputs within 1e-5 (relative and
  absolute), ``train_batch`` / ``eval_batch`` / ``predict_batch`` too;
- the order of every callback event a fit with ``eval_data`` fires,
  equal to the reference's;
- ``EarlyStopping`` (stops after the same epoch, same best) and
  ``ReduceLROnPlateau`` (the same rate after every epoch) decide as the
  reference does;
- ``save``/``load`` round trip (parameters and optimizer state, then
  the same predictions and the same next step);
- ``DataLoader`` batches in the same order under the same
  ``np.random`` seed (shuffled, ``drop_last`` both ways, a
  ``random_split`` subset, ``WeightedRandomSampler``), and the datasets'
  indexing;
- ``Accuracy`` (top-1 and top-2), ``Precision``, ``Recall``, ``Auc`` and
  ``accuracy`` equal to the reference's on the same inputs;
- what ``fit`` does not port raises, naming its ROADMAP item;
- ``fit(accumulate_grad_batches=2)`` and ``prepare(amp_configs="O1")``
  give the loss history of neither, in both packages (the reference
  accepts both and ignores them).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import hapi as jhapi
from paddle_tpu import io as jio
from paddle_tpu import metric as jmetric
from paddle_tpu import nn as jnn
from paddle_tpu_torch import hapi, io, metric
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.optimizer import lr as tlr

TOL = 1e-5


def _data(n=40, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype(np.float32)
    y = (x[:, :1] + x[:, 1:2] > 0).astype(np.int64) \
        + (x[:, 2:3] > 1).astype(np.int64)
    return x, y


def _nets():
    pt.seed(0)
    j1, j2 = jnn.Linear(4, 16), jnn.Linear(16, 3)
    jnet = jnn.Sequential(j1, jnn.ReLU(), j2)
    t1, t2 = Linear(4, 16, device="cpu"), Linear(16, 3, device="cpu")
    with torch.no_grad():
        for j, t in ((j1, t1), (j2, t2)):
            t.weight.copy_(torch.from_numpy(np.array(j.weight.numpy())))
            t.bias.copy_(torch.from_numpy(np.array(j.bias.numpy())))
    return jnet, torch.nn.Sequential(t1, torch.nn.ReLU(), t2)


def _models(lr=0.01, metrics=False):
    jnet, tnet = _nets()
    jm = jhapi.Model(jnet).prepare(
        pt.optimizer.Adam(learning_rate=lr, parameters=jnet.parameters()),
        loss=lambda o, l: pt.nn.functional.cross_entropy(o, l),
        metrics=jmetric.Accuracy() if metrics else None)
    tm = hapi.Model(tnet).prepare(
        Adam(learning_rate=lr, parameters=tnet.parameters()),
        loss=lambda o, l: TF.cross_entropy(o, l),
        metrics=metric.Accuracy() if metrics else None)
    return jm, tm


class _Recorder:
    """Callback mixin recording every event (name, step/epoch) and every
    batch loss."""

    def _make(base):
        class Rec(base):
            def __init__(self):
                self.events, self.losses = [], []

            def __getattribute__(self, name):
                if name.startswith("on_"):
                    def hook(*a, **k):
                        arg = a[0] if a and isinstance(a[0], int) else None
                        self.events.append((name, arg))
                        logs = (k.get("logs") if "logs" in k else
                                a[1] if len(a) > 1 else None)
                        if name == "on_train_batch_end":
                            self.losses.append(float(logs["loss"]))
                    return hook
                return object.__getattribute__(self, name)
        return Rec()


def test_fit_evaluate_predict_match_reference():
    x, y = _data()
    jm, tm = _models(metrics=True)
    jrec = _Recorder._make(jhapi.Callback)
    trec = _Recorder._make(hapi.Callback)
    jm.fit(jio.TensorDataset([x, y]), eval_data=jio.TensorDataset([x, y]),
           batch_size=8, epochs=3, shuffle=False, verbose=0,
           callbacks=[jrec], log_freq=2)
    tm.fit(io.TensorDataset([x, y]), eval_data=io.TensorDataset([x, y]),
           batch_size=8, epochs=3, shuffle=False, verbose=0,
           callbacks=[trec], log_freq=2)
    assert len(trec.losses) == 15
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=0, atol=TOL)
    assert trec.events == jrec.events
    je = jm.evaluate(jio.TensorDataset([x, y]), batch_size=8, verbose=0)
    te = tm.evaluate(io.TensorDataset([x, y]), batch_size=8, verbose=0)
    assert te.keys() == je.keys()
    for k in je:
        np.testing.assert_allclose(te[k], je[k], rtol=0, atol=TOL)
    jp = jm.predict(jio.TensorDataset([x, y]), batch_size=8,
                    stack_outputs=True)
    tp = tm.predict(io.TensorDataset([x, y]), batch_size=8,
                    stack_outputs=True)
    # logits after 15 Adam steps: the summation orders' drift is relative
    np.testing.assert_allclose(tp[0], jp[0], rtol=TOL, atol=TOL)
    jb = jm.train_batch([x[:8]], [y[:8]])
    tb = tm.train_batch([x[:8]], [y[:8]])
    np.testing.assert_allclose(tb[0], jb[0], rtol=0, atol=TOL)
    np.testing.assert_allclose(tm.eval_batch([x[:8]], [y[:8]]),
                               jm.eval_batch([x[:8]], [y[:8]]), atol=TOL)
    np.testing.assert_allclose(tm.predict_batch([x[:8]])[0],
                               jm.predict_batch([x[:8]])[0], rtol=TOL,
                               atol=TOL)


def test_early_stopping_and_plateau_decide_as_reference():
    x, y = _data()
    xe, ye = _data(16, seed=7)
    decisions = []
    for lib, io_, pkg in ((jhapi, jio, "jax"), (hapi, io, "port")):
        jm, tm = _models(lr=0.05)
        model = jm if pkg == "jax" else tm
        es = lib.EarlyStopping(monitor="loss", patience=1, min_delta=0.05)
        rp = lib.ReduceLROnPlateau(monitor="loss", factor=0.5, patience=1,
                                   min_delta=0.02, verbose=0)
        rates = []

        class Rate(lib.Callback):
            def on_epoch_end(self, epoch, logs=None):
                rates.append(model._optimizer.get_lr())

        model.fit(io_.TensorDataset([x, y]),
                  eval_data=io_.TensorDataset([xe, ye]), batch_size=8,
                  epochs=8, shuffle=False, verbose=0,
                  callbacks=[es, rp, Rate()])
        decisions.append((es.best, es.wait, es.stop_training, rp.wait,
                          rp.best, rates))
    (jb, jw, js, jrw, jrb, jr), (tb, tw, ts, trw, trb, tr) = decisions
    assert (tw, ts, trw) == (jw, js, jrw)
    assert len(tr) == len(jr) and np.allclose(tr, jr, rtol=0, atol=1e-12)
    assert abs(tb - jb) < TOL and abs(trb - jrb) < TOL


def test_save_load_round_trip(tmp_path):
    x, y = _data()
    _, tm = _models()
    tm.fit(io.TensorDataset([x, y]), batch_size=8, epochs=1, verbose=0)
    tm.save(str(tmp_path / "ckpt" / "m"))
    _, tm2 = _models()
    tm2.load(str(tmp_path / "ckpt" / "m"))
    for a, b in zip(tm.parameters(), tm2.parameters()):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(tm2.predict_batch([x])[0],
                                  tm.predict_batch([x])[0])
    a = tm.train_batch([x[:8]], [y[:8]])[0]
    b = tm2.train_batch([x[:8]], [y[:8]])[0]
    np.testing.assert_array_equal(a, b)


def _batches(loader):
    return [[np.asarray(f) for f in batch] for batch in loader]


@pytest.mark.parametrize("drop_last", [False, True])
def test_dataloader_order_matches_reference(drop_last):
    x, y = _data(37)
    out = []
    for io_ in (jio, io):
        np.random.seed(3)
        loader = io_.DataLoader(io_.TensorDataset([x, y]), batch_size=8,
                                shuffle=True, drop_last=drop_last)
        assert len(loader) == (4 if drop_last else 5)
        got = _batches(loader) + _batches(loader)  # two epochs
        sub = io_.random_split(io_.TensorDataset([x, y]), [30, 7])
        got.append([np.asarray(sub[1][i][0]) for i in range(7)])
        ws = io_.WeightedRandomSampler(np.arange(1, 11), 6)
        got.append([np.asarray(list(ws))])
        out.append(got)
    assert len(out[0]) == len(out[1])
    for a, b in zip(*out):
        for fa, fb in zip(a, b):
            np.testing.assert_array_equal(fb, fa)


def test_datasets_index_as_reference():
    x, y = _data(10)
    for io_ in (jio, io):
        comp = io_.ComposeDataset([io_.TensorDataset([x]),
                                   io_.TensorDataset([y])])
        cat = io_.ConcatDataset([io_.TensorDataset([x]),
                                 io_.TensorDataset([x[:3]])])
        assert len(comp) == 10 and len(cat) == 13
        np.testing.assert_array_equal(np.asarray(cat[11][0]), x[1])
        np.testing.assert_array_equal(np.asarray(comp[4][1]), y[4])
        sub = io_.Subset(io_.TensorDataset([x]), [5, 2])
        np.testing.assert_array_equal(np.asarray(sub[1][0]), x[2])


def test_metrics_match_reference():
    rng = np.random.RandomState(2)
    pred = rng.rand(20, 4).astype(np.float32)
    label = rng.randint(0, 4, (20, 1)).astype(np.int64)
    for topk in ((1,), (1, 2)):
        ja, ta = jmetric.Accuracy(topk=topk), metric.Accuracy(topk=topk)
        jc = ja.compute(pt.to_tensor(pred), pt.to_tensor(label))
        tc = ta.compute(torch.from_numpy(pred), torch.from_numpy(label))
        np.testing.assert_array_equal(tc, jc)
        assert ta.update(tc) == ja.update(jc)
        assert ta.accumulate() == ja.accumulate()
        assert ta.name() == ja.name()
    prob = rng.rand(30).astype(np.float32)
    lab = rng.randint(0, 2, 30).astype(np.int64)
    for cls in ("Precision", "Recall", "Auc"):
        jmet, tmet = getattr(jmetric, cls)(), getattr(metric, cls)()
        for lo in (0, 15):
            jmet.update(prob[lo:lo + 15], lab[lo:lo + 15])
            tmet.update(torch.from_numpy(prob[lo:lo + 15]),
                        torch.from_numpy(lab[lo:lo + 15]))
        assert tmet.accumulate() == pytest.approx(jmet.accumulate(),
                                                  abs=1e-12)
        assert tmet.name() == jmet.name()
    want = float(jmetric.accuracy(pt.to_tensor(pred), pt.to_tensor(label),
                                  k=2).numpy())
    got = float(metric.accuracy(torch.from_numpy(pred),
                                torch.from_numpy(label), k=2))
    assert got == pytest.approx(want, abs=1e-7)


def test_lr_scheduler_callback_steps_the_schedule():
    x, y = _data()
    _, tnet = _nets()
    sched = tlr.StepDecay(0.01, step_size=2, gamma=0.5)
    tm = hapi.Model(tnet).prepare(
        Adam(learning_rate=sched, parameters=tnet.parameters()),
        loss=lambda o, l: TF.cross_entropy(o, l))
    tm.fit(io.TensorDataset([x, y]), batch_size=8, epochs=1, verbose=0)
    assert sched.last_epoch == 5 and sched() == 0.01 * 0.5 ** 2


def test_fit_options_not_ported_raise(tmp_path):
    x, y = _data()
    _, tm = _models()
    for kw in (dict(checkpoint_dir=str(tmp_path)), dict(resume_from="x"),
               dict(nan_policy="skip"), dict(shard_plan="p.json"),
               dict(device_prefetch=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tm.fit(io.TensorDataset([x, y]), batch_size=8, verbose=0, **kw)
    with pytest.raises(NotImplementedError, match="num_workers"):
        io.DataLoader(io.TensorDataset([x, y]), num_workers=2)


def test_fit_without_loss_takes_the_network_loss():
    """A network that returns its own loss from (inputs, labels): the
    port builds the step without ``loss=`` (a causal LM's form)."""
    x, y = _data()
    _, tnet = _nets()

    class WithLoss(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = tnet

        def forward(self, xb, yb):
            return TF.cross_entropy(self.net(xb), yb)

    model = WithLoss()
    tm = hapi.Model(model).prepare(Adam(0.01, parameters=model.parameters()))
    losses = []

    class Rec(hapi.Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(float(logs["loss"]))

    tm.fit(io.TensorDataset([x, y]), batch_size=8, epochs=2, shuffle=False,
           verbose=0, callbacks=[Rec()], accumulate_grad_batches=1)
    assert len(losses) == 10 and losses[-1] < losses[0]
    assert tm.evaluate(io.TensorDataset([x, y]), batch_size=8,
                       verbose=0)["loss"] < losses[0]
    # accumulate_grad_batches is accepted and ignored, as in the
    # reference: every batch is one update, in both packages
    _hold_ignored_knob(fit_kw={"accumulate_grad_batches": 2})


def _history(jax_side, prepare_kw=None, fit_kw=None):
    """The per-batch loss history of a 2-epoch fit of a fresh model pair
    (the reference's or the port's side)."""
    x, y = _data()
    jm, tm = _models()
    m, ds, base = (jm, jio.TensorDataset([x, y]), jhapi.Callback) \
        if jax_side else (tm, io.TensorDataset([x, y]), hapi.Callback)
    if prepare_kw:
        m.prepare(m._optimizer, loss=m._loss, **prepare_kw)
    rec = _Recorder._make(base)
    m.fit(ds, batch_size=8, epochs=2, shuffle=False, verbose=0,
          callbacks=[rec], **(fit_kw or {}))
    return rec.losses


def _hold_ignored_knob(prepare_kw=None, fit_kw=None):
    """With the knob, each package's history equals its own history
    without it (bit for bit) and the port's equals the reference's."""
    for jax_side in (True, False):
        plain = _history(jax_side)
        assert len(plain) == 10
        assert _history(jax_side, prepare_kw, fit_kw) == plain, jax_side
    np.testing.assert_allclose(_history(False, prepare_kw, fit_kw),
                               _history(True, prepare_kw, fit_kw),
                               rtol=0, atol=TOL)


def test_amp_configs_is_accepted_and_ignored():
    """``prepare(amp_configs="O1")`` gives the history of no amp_configs,
    in both packages, as the reference ignores the argument."""
    _hold_ignored_knob(prepare_kw={"amp_configs": "O1"})
