"""C.14: the port's ``io.DataLoader`` hands out the reference's 32-bit
dtypes (int64 as int32, float64 as float32, complex128 as complex64),
whatever the samples are: numpy arrays and scalars, Python numbers or
torch tensors, alone or in dicts, tuples and lists.

A float32 model is then fed a numpy-default dataset unchanged, as in the
reference: ``hapi.Model.fit`` on a float64 dataset gives the reference's
losses, and the ops that reach torch ops wanting int64 indices
(``F.cross_entropy``, ``F.nll_loss``, ``F.one_hot``, ``gather``,
``metric.Accuracy``) take int32 labels and give the reference's values.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu import hapi as jhapi
from paddle_tpu import io as jio
from paddle_tpu.framework import dtype as jdtype
from paddle_tpu_torch import hapi, io
from paddle_tpu_torch.framework import dtype as tdtype
from paddle_tpu_torch.framework.device import using_device

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    with using_device("cpu"):
        yield


SAMPLES = {
    "float64": lambda i, r: r.rand(4),
    "int64": lambda i, r: np.int64(i),
    "int64_array": lambda i, r: np.arange(3, dtype=np.int64) + i,
    "python_int": lambda i, r: i,
    "python_float": lambda i, r: float(i) / 3,
    "complex128": lambda i, r: r.rand(2) + 1j * r.rand(2),
    "float32": lambda i, r: r.rand(4).astype(np.float32),
    "bool": lambda i, r: np.array([i % 2 == 0]),
    "uint8": lambda i, r: np.full(2, i, np.uint8),
}


def _dataset(base, make):
    class DS(base):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            return make(i, np.random.RandomState(i))

    return DS()


def _names(batch, name_of):
    if isinstance(batch, dict):
        return {k: _names(v, name_of) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return [_names(v, name_of) for v in batch]
    return name_of(batch.dtype)


def _first(base, loader, make):
    return next(iter(loader(_dataset(base, make), batch_size=4)))


@pytest.mark.parametrize("kind", sorted(SAMPLES))
@pytest.mark.parametrize("form", ["alone", "tuple", "dict", "list"])
def test_batch_dtypes_equal_the_reference(kind, form):
    f = SAMPLES[kind]
    make = {"alone": f,
            "tuple": lambda i, r: (f(i, r), np.int64(i)),
            "dict": lambda i, r: {"x": f(i, r), "y": i},
            "list": lambda i, r: [f(i, r), float(i)]}[form]
    want = _first(jio.Dataset, jio.DataLoader, make)
    got = _first(io.Dataset, io.DataLoader, make)
    assert _names(got, tdtype.dtype_name) == _names(want, jdtype.dtype_name)
    if kind == "float64" and form == "tuple":
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=TOL)


def test_torch_samples_are_narrowed_too():
    make_np = lambda i, r: (r.rand(3), np.int64(i))  # noqa: E731
    make_t = lambda i, r: (torch.from_numpy(r.rand(3)),  # noqa: E731
                           torch.tensor(i, dtype=torch.int64))
    want = _first(jio.Dataset, jio.DataLoader, make_np)
    got = _first(io.Dataset, io.DataLoader, make_t)
    assert _names(got, tdtype.dtype_name) == _names(want, jdtype.dtype_name)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=TOL)
    # a collate_fn's own tensors too; return_list=False hands on as is
    loader = io.DataLoader(_dataset(io.Dataset, make_np), batch_size=2,
                           collate_fn=lambda b: torch.zeros(2,
                                                            dtype=torch.int64))
    assert next(iter(loader)).dtype == torch.int32


def _nets():
    jp.seed(0)
    jnet = jp.nn.Sequential(jp.nn.Linear(4, 8), jp.nn.ReLU(),
                            jp.nn.Linear(8, 3))
    tnet = tp.nn.Sequential(tp.nn.Linear(4, 8), tp.nn.ReLU(),
                            tp.nn.Linear(8, 3))
    tnet.set_state_dict({k: np.asarray(v.numpy()) for k, v in
                         jnet.state_dict().items()})
    return jnet, tnet


def _float64_data():
    rng = np.random.RandomState(0)
    x = rng.rand(24, 4)  # float64, the numpy default
    y = (x.sum(1) * 1.5).astype(np.int64) % 3  # int64 labels
    return x, y


def test_fit_on_a_float64_dataset_matches_the_reference():
    x, y = _float64_data()
    jnet, tnet = _nets()
    losses = {}
    for key, P, H, D, net in (("j", jp, jhapi, jio, jnet),
                              ("t", tp, hapi, io, tnet)):
        rec = []

        class Rec(H.Callback):
            def on_train_batch_end(self, step, logs=None):
                rec.append(float(np.asarray(logs["loss"]).reshape(-1)[0]))

        m = H.Model(net)
        m.prepare(P.optimizer.Adam(learning_rate=0.01,
                                   parameters=net.parameters()),
                  loss=P.nn.CrossEntropyLoss(),
                  metrics=P.metric.Accuracy())
        m.fit(D.TensorDataset([x, y]), batch_size=8, epochs=2,
              shuffle=False, verbose=0, callbacks=[Rec()])
        losses[key] = (rec, m.evaluate(D.TensorDataset([x, y]),
                                       batch_size=8, verbose=0))
    assert len(losses["t"][0]) == 6
    np.testing.assert_allclose(losses["t"][0], losses["j"][0], rtol=0,
                               atol=TOL)
    for k, v in losses["j"][1].items():
        np.testing.assert_allclose(np.asarray(losses["t"][1][k], np.float64),
                                   np.asarray(v, np.float64), atol=TOL)


def test_ops_take_int32_labels():
    rng = np.random.RandomState(1)
    logits = rng.randn(6, 5).astype(np.float32)
    labels = rng.randint(0, 5, 6).astype(np.int32)
    jl, jy = jp.to_tensor(logits), jp.to_tensor(labels)
    tl, ty = torch.from_numpy(logits), torch.from_numpy(labels)
    assert ty.dtype == torch.int32
    pairs = [
        (tp.nn.functional.cross_entropy(tl, ty),
         jp.nn.functional.cross_entropy(jl, jy)),
        (tp.nn.functional.cross_entropy(tl, ty[:, None], soft_label=False),
         jp.nn.functional.cross_entropy(jl, jy[:, None], soft_label=False)),
        (tp.nn.functional.nll_loss(tp.nn.functional.log_softmax(tl), ty),
         jp.nn.functional.nll_loss(jp.nn.functional.log_softmax(jl), jy)),
        (tp.nn.functional.one_hot(ty, 5), jp.nn.functional.one_hot(jy, 5)),
        (tp.gather(tl, ty[:3]), jp.gather(jl, jy[:3])),
        (tp.take_along_axis(tl, ty[:, None], 1),
         jp.take_along_axis(jl, jy[:, None], 1)),
        (tp.nn.CrossEntropyLoss()(tl, ty), jp.nn.CrossEntropyLoss()(jl, jy)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                                   rtol=TOL, atol=TOL)
    for k in (1, 2):
        jm, tm = jp.metric.Accuracy(topk=(k,)), tp.metric.Accuracy(topk=(k,))
        tm.update(tm.compute(tl, ty[:, None]))
        jm.update(jm.compute(jl, jy[:, None]))
        assert tm.accumulate() == pytest.approx(jm.accumulate(), abs=1e-7)
