"""The port's nn layers held against the JAX package on the CPU.

- **The sweep**: every case of ``tests/torch_layer_cases.py`` (every spec
  of ``tests/test_layer_sweep.py``, then the layers it leaves out: the
  losses, unpooling, ``SpectralNorm``, containers, ...). The reference's
  layer's ``state_dict`` is loaded into the port's by name; outputs, the
  inputs' and every parameter's gradient of ``sum(out * cotangent)``, and
  the ``state_dict`` after the call (batch norm's running statistics,
  spectral norm's power-iteration vectors) within the case's tolerance
  (1e-5 of the largest magnitude, or of 1 below it, fp32).
- **Completeness**: every layer and initializer name that
  ``paddle_tpu/nn/__init__.py`` imports from ``nn/layer/`` and
  ``nn/initializer.py`` exists in ``paddle_tpu_torch.nn`` with the
  reference's positional parameters and defaults, and is built by a case
  or by a named test file.
- **Random layers** in training mode, by statistics; **initializers** by
  value (the deterministic ones) or by their moments.
"""
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as pnn
import paddle_tpu_torch.nn as tnn
import torch_layer_cases as lc
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.framework.device import using_device
from torch_functional_cases import cotangents, flat


@pytest.fixture(autouse=True)
def _on_cpu():
    with using_device("cpu"):
        yield


def _is_float(a):
    return np.asarray(a).dtype.kind == "f"


def _reference_run(case):
    """``port_run`` through the reference: its layer, its weights before
    the call, then (float outputs, input gradients, parameter gradients by
    name, state after the call)."""
    layer = case.build(pnn, lambda a: pt.to_tensor(np.array(a)))
    layer.train() if case.train else layer.eval()
    weights = {n: np.array(t.numpy()) for n, t in layer.state_dict().items()}
    grad = case.grad or ()
    ts = [pt.to_tensor(np.array(a), stop_gradient=i not in grad)
          if _is_float(a) else pt.to_tensor(np.array(a))
          for i, a in enumerate(case.inputs)]
    out = (case.call or (lambda m, *xs: m(*xs)))(layer, *ts)
    outs = [o for o in flat(out) if isinstance(o, pt.Tensor)
            and np.asarray(o.numpy()).dtype.kind == "f"]
    state = {n: np.asarray(t.numpy()) for n, t in layer.state_dict().items()}
    if case.grad is None:
        return weights, ([np.asarray(o.numpy()) for o in outs], [], {},
                         state)
    cots = cotangents([o.shape for o in outs])
    loss = None
    for o, c in zip(outs, cots):
        term = (o * pt.to_tensor(c)).sum()
        loss = term if loss is None else loss + term
    loss.backward()

    def grad_of(t):
        return None if t.grad is None else np.asarray(t.grad.numpy())

    return weights, ([np.asarray(o.numpy()) for o in outs],
                     [grad_of(ts[i]) for i in case.grad],
                     {n: grad_of(p) for n, p in layer.named_parameters()},
                     state)


def _close(got, want, tol, what):
    want = np.zeros_like(got) if want is None else np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    # of the largest magnitude, or of 1 below it: a gradient that is 0 in
    # exact arithmetic (a key bias under softmax) is fp32 noise in both
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


@pytest.mark.parametrize("case", lc.CASES, ids=[c.id for c in lc.CASES])
def test_layer_matches_the_reference(case):
    weights, (r_outs, r_in, r_par, r_state) = _reference_run(case)
    outs, in_grads, par_grads, state = lc.port_run(case, weights)
    assert len(outs) == len(r_outs)
    for i, (got, want) in enumerate(zip(outs, r_outs)):
        _close(got, want, case.tol, f"output {i}")
    for i, got, want in zip(case.grad or (), in_grads, r_in):
        _close(got, want, case.tol, f"gradient of input {i}")
    assert set(par_grads) <= set(r_par)
    for n, got in par_grads.items():
        _close(got, r_par[n], case.tol, f"gradient of {n}")
    assert sorted(state) == sorted(r_state)
    for n, got in state.items():
        _close(got, r_state[n], case.tol, f"state {n}")


# -- completeness ------------------------------------------------------------

def _reference_names():
    """The public names ``paddle_tpu.nn`` takes from ``nn/layer/`` and
    the public names ``nn/initializer.py`` defines."""
    layers = sorted(n for n in dir(pnn) if not n.startswith("_")
                    and getattr(getattr(pnn, n), "__module__", "")
                    .startswith("paddle_tpu.nn.layer"))
    init = pnn.initializer
    inits = sorted(n for n in dir(init) if not n.startswith("_")
                   and getattr(getattr(init, n), "__module__", "")
                   == "paddle_tpu.nn.initializer")
    return layers, inits


# built by the named test files rather than by a sweep case
ELSEWHERE = {
    "Layer": "test_torch_layer_api.py", "ParamAttr": "test_torch_layer_api.py",
    "ParameterList": "test_torch_layer_api.py",
    "RNNCellBase": "test_torch_rnn.py", "SimpleRNNCell": "test_torch_rnn.py",
    "LSTMCell": "test_torch_rnn.py", "GRUCell": "test_torch_rnn.py",
    "RNN": "test_torch_rnn.py", "BiRNN": "test_torch_rnn.py",
    "BeamSearchDecoder": "test_torch_rnn.py",
    "dynamic_decode": "test_torch_rnn.py",
}


def _positional(fn):
    """The positional parameters (and ``*args``/``**kwargs``) of a
    function or a class's ``__init__``, as (name, kind, default)."""
    sig = inspect.signature(fn.__init__ if inspect.isclass(fn) else fn)
    kinds = (inspect.Parameter.POSITIONAL_OR_KEYWORD,
             inspect.Parameter.VAR_POSITIONAL,
             inspect.Parameter.VAR_KEYWORD)
    return [(p.name, p.kind, p.default) for p in sig.parameters.values()
            if p.kind in kinds]


def _same_default(a, b):
    if a is inspect.Parameter.empty or b is inspect.Parameter.empty:
        return a is b
    if inspect.isclass(a) or callable(a):  # a class default (Cache)
        return getattr(a, "__name__", a) == getattr(b, "__name__", b)
    return a == b or (isinstance(a, float) and np.isclose(a, b))


def test_every_reference_name_is_ported_with_its_parameters():
    layers, inits = _reference_names()
    assert len(layers) >= 130 and len(inits) >= 15
    covered = lc.covered() | set(ELSEWHERE)
    for name in layers + [f"initializer.{n}" for n in inits]:
        ref = pnn
        port = tnn
        for part in name.split("."):
            ref, port = getattr(ref, part), getattr(port, part, None)
        assert port is not None, f"{name} is missing from the port"
        if callable(ref) and not isinstance(ref, type(pnn)):
            want, got = _positional(ref), _positional(port)
            # the port may add keyword-only parameters (device, generator)
            assert [(n, k) for n, k, _ in got] == \
                [(n, k) for n, k, _ in want], name
            for (n, _, d), (_, _, e) in zip(got, want):
                assert _same_default(d, e), (name, n, d, e)
    missing = sorted(n for n in layers if n not in covered)
    assert not missing, f"not built by any case: {missing}"


# -- random layers in training mode, by statistics ---------------------------

def test_random_layers_in_training_mode():
    """Dropout keeps each element with probability 1 - p scaled by 1 / (1
    - p); the 2-D and 3-D forms drop whole channels; alpha dropout keeps
    the mean and variance of a standard normal input; RReLU's slopes lie
    in ``[lower, upper]`` with their mean. Six standard errors apart."""
    trandom.seed(7)
    x = torch.ones(200, 50, 4, 4)
    for layer, per_channel in ((tnn.Dropout(0.3), False),
                               (tnn.Dropout2D(0.3), True),
                               (tnn.Dropout3D(0.3), True)):
        layer.train()
        xs = x if not isinstance(layer, tnn.Dropout3D) else x[..., None]
        y = layer(xs)
        kept = (y != 0).float()
        torch.testing.assert_close(y[kept.bool()],
                                   torch.full_like(y[kept.bool()], 1 / 0.7))
        if per_channel:
            flat_k = kept.reshape(200, 50, -1)
            assert bool((flat_k.amin(-1) == flat_k.amax(-1)).all())
            n = 200 * 50
        else:
            n = kept.numel()
        se = (0.3 * 0.7 / n) ** 0.5
        assert abs(kept.mean().item() - 0.7) < 6 * se
    z = torch.from_numpy(np.random.RandomState(3).randn(400, 400)
                         .astype(np.float32))
    a = tnn.AlphaDropout(0.2)
    a.train()
    y = a(z)
    se = (2.0 / z.numel()) ** 0.5
    assert abs(y.mean().item()) < 6 * se
    assert abs(y.var().item() - 1.0) < 6 * 2 ** 0.5 * se
    r = tnn.RReLU(0.1, 0.3)
    r.train()
    neg = -torch.ones(100000)
    slopes = -r(neg)
    assert slopes.min() >= 0.1 and slopes.max() <= 0.3
    assert abs(slopes.mean().item() - 0.2) < 6 * (0.2 / 12 ** 0.5) \
        / 100000 ** 0.5
    r.eval()
    torch.testing.assert_close(r(neg), torch.full_like(neg, -0.2))


# -- initializers ------------------------------------------------------------

DETERMINISTIC_INITS = [
    ("Constant", (0.3,), (5, 4)),
    ("Assign", (np.arange(12, dtype=np.float32),), (3, 4)),
    ("Dirac", (2,), (6, 3, 3, 3)),
    ("Bilinear", (), (2, 3, 4, 4)),
]


@pytest.mark.parametrize("name,args,shape", DETERMINISTIC_INITS,
                         ids=[d[0] for d in DETERMINISTIC_INITS])
def test_deterministic_initializers_equal_the_reference(name, args, shape):
    want = np.asarray(getattr(pnn.initializer, name)(*args)(shape,
                                                            "float32"))
    t = torch.empty(shape)
    getattr(tnn.initializer, name)(*args)(t)
    np.testing.assert_array_equal(t.numpy(), want)


RANDOM_INITS = [
    ("Normal", (0.5, 2.0)),
    ("TruncatedNormal", (0.5, 2.0, -1.5, 2.5)),
    ("Uniform", (-0.3, 0.7)),
    ("XavierUniform", ()),
    ("XavierNormal", ()),
    ("KaimingUniform", ()),
    ("KaimingNormal", ()),
]


@pytest.mark.parametrize("name,args", RANDOM_INITS,
                         ids=[r[0] for r in RANDOM_INITS])
def test_random_initializers_draw_the_references_distribution(name, args):
    """Mean and standard deviation of a 256 x 512 draw within six
    standard errors of the reference's draw; the range of the bounded
    ones."""
    shape = (256, 512)
    want = np.asarray(getattr(pnn.initializer, name)(*args)(shape,
                                                            "float32"))
    t = torch.empty(shape)
    getattr(tnn.initializer, name)(*args)(t, torch.Generator().manual_seed(
        3))
    got = t.numpy()
    n = got.size
    sd = want.std()
    assert abs(got.mean() - want.mean()) < 6 * sd * (2 / n) ** 0.5
    assert abs(got.std() - sd) < 6 * sd * (1 / n) ** 0.5
    if name in ("TruncatedNormal", "Uniform", "XavierUniform",
                "KaimingUniform"):
        lo, hi = want.min(), want.max()
        span = hi - lo
        assert got.min() >= lo - 0.01 * span and got.max() <= hi + 0.01 * span


@pytest.mark.parametrize("shape", [(6, 10), (10, 6), (4, 2, 3)])
def test_orthogonal_initializer(shape):
    """Rows (or columns) orthonormal times the gain, as the reference's."""
    t = torch.empty(shape)
    tnn.initializer.Orthogonal(1.5)(t)
    m = t.reshape(shape[0], -1)
    r = np.asarray(pnn.initializer.Orthogonal(1.5)(shape, "float32")
                   ).reshape(shape[0], -1)
    small = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
    want = r @ r.T if r.shape[0] <= r.shape[1] else r.T @ r
    torch.testing.assert_close(small, torch.from_numpy(want), atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(small, 2.25 * torch.eye(small.shape[0]),
                               atol=1e-5, rtol=1e-5)
