"""The port's ``jit.TrainStep`` and ``AsyncStepper`` held against the JAX
package's on the CPU (fp32 tiny Llama, weights through
``load_jax_weights``, batches from numpy seeds):

- 5 AdamW steps with global-norm clipping through both ``TrainStep``s:
  losses within 1e-5 at every step;
- ``nan_check``: a weight set to inf (the loss is the first bad leaf)
  and a loss whose gradient alone is NaN (a gradient is): the same
  step, leaf and kind as the reference's ``NonFiniteError``; the step
  counter does not advance and parameters, masters and states are
  bit-identical to before the failed call; the next good batch steps;
  and a NaN born in the update itself (``AdamW(epsilon=0)``'s 0/0 on
  embedding rows absent from the batch) named as the reference's
  ``param`` leaf, with the state left as it was;
- ``AsyncStepper``: the same losses as the bare ``TrainStep``, at most
  ``max_in_flight`` in flight, ``drain`` returns the last loss, a bound
  below 1 raises, as in the reference;
- the keying: the amp state is not part of a signature in either
  package: a signature first run outside ``auto_cast`` runs in fp32
  inside it too (one signature, the fp32 loss, 1e-5 between the two);
- ``donate=True``: a held ``optimizer.state_dict()`` keeps its values
  through later steps (copies), parameters update in place;
- the capturable optimizer: every rule with its ``[lr, step]`` read from
  a device-scalar buffer (the form a captured step runs) within 1e-6 of
  the eager rule after 3 steps; the eager results themselves are held
  bit for bit by tests/test_torch_optimizer.py;
- ``memory_analysis`` and ``exec_cache_key`` carry the reference's
  fields.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.jit.train_step import TrainStep as JaxTrainStep
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.monitor.numerics import NonFiniteError as JaxNonFinite
from paddle_tpu_torch import amp
from paddle_tpu_torch.jit import AsyncStepper, TrainStep
from paddle_tpu_torch.models import (
    LlamaConfig, LlamaForCausalLM, load_jax_weights,
)
from paddle_tpu_torch.monitor.numerics import NonFiniteError
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch import optimizer as topt

B, S, V = 2, 16, 128


def _pair(seed=0):
    pt.seed(seed)
    jm = JaxLlama(JaxLlamaConfig.tiny(num_hidden_layers=2))
    tm = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=2),
                          device="cpu")
    load_jax_weights(tm, {n: np.asarray(p._data)
                          for n, p in jm.named_parameters()})
    return jm, tm


def _batch(i):
    rng = np.random.RandomState(100 + i)
    return (rng.randint(0, V, (B, S)).astype(np.int32),
            rng.randint(0, V, (B, S)).astype(np.int32))


def _steps(loss_fn=None, **kw):
    jm, tm = _pair()
    jstep = JaxTrainStep(jm, pt.optimizer.AdamW(
        learning_rate=1e-3, weight_decay=0.01, parameters=jm.parameters(),
        grad_clip=pt.nn.ClipGradByGlobalNorm(1.0)),
        loss_fn or (lambda m, i, l: m(i, l)), **kw)
    opt = topt.AdamW(learning_rate=1e-3, weight_decay=0.01,
                     parameters=tm.parameters(),
                     grad_clip=ClipGradByGlobalNorm(1.0))
    step = TrainStep(tm, opt, loss_fn, **kw)
    return jm, tm, jstep, step, opt


def _run_both(jstep, step, i):
    ids, labels = _batch(i)
    jl = float(jstep(pt.to_tensor(ids), pt.to_tensor(labels)).numpy())
    tl = float(step(torch.from_numpy(ids), torch.from_numpy(labels)))
    return jl, tl


def test_five_steps_match_reference():
    _, _, jstep, step, _ = _steps(donate=True)
    for i in range(5):
        jl, tl = _run_both(jstep, step, i)
        assert abs(jl - tl) < 1e-5, (i, jl, tl)
    assert step.compiled_count == jstep.compiled_count == 1


def _snapshot(tm, opt):
    return ({n: p.detach().clone() for n, p in tm.named_parameters()},
            {k: (v.clone() if isinstance(v, torch.Tensor) else v)
             for k, v in opt.state_dict().items()})


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def _poison_weight(jm, tm, name, value):
    jp = dict(jm.named_parameters())[name]
    jp._data = jp._data.at[0, 0].set(value)
    with torch.no_grad():
        dict(tm.named_parameters())[name][0, 0] = value


def _sqrt_abs_loss(m, i, l):
    # finite (0 * ...), but the gradient of sqrt(|w|) at w = 0 is not
    return m(i, l) + 0.0 * (m.lm_head.weight.abs() ** 0.5).sum()


@pytest.mark.parametrize("case", ["loss", "grad"])
def test_nan_check_names_the_reference_leaf(case):
    loss_fn = _sqrt_abs_loss if case == "grad" else None
    jm, tm, jstep, step, opt = _steps(loss_fn, nan_check=True)
    for i in range(2):
        jl, tl = _run_both(jstep, step, i)
        assert abs(jl - tl) < 1e-5
    if case == "loss":
        _poison_weight(jm, tm, "llama.layers.1.mlp.down_proj.weight",
                       float("inf"))
    else:
        _poison_weight(jm, tm, "lm_head.weight", 0.0)
    before = _snapshot(tm, opt)
    ids, labels = _batch(2)
    with pytest.raises(JaxNonFinite) as jerr:
        jstep(pt.to_tensor(ids), pt.to_tensor(labels))
    with pytest.raises(NonFiniteError) as terr:
        step(torch.from_numpy(ids), torch.from_numpy(labels))
    assert (terr.value.step, terr.value.leaf, terr.value.kind) == \
        (jerr.value.step, jerr.value.leaf, jerr.value.kind)
    assert terr.value.step == 3
    assert terr.value.kind == case
    after = _snapshot(tm, opt)
    _same(before[0], after[0])
    _same(before[1], after[1])
    assert opt._global_step == 2


def test_nan_check_catches_a_nan_born_in_the_update():
    """A non-finite value made by the update from finite gradients:
    ``AdamW(epsilon=0.0)`` divides 0 by 0 on the embedding rows of tokens
    absent from the batch. Both packages raise at step 1 naming the
    embedding as a ``param`` leaf, and the port leaves parameters, states
    and the step count as they were (none of them existed yet)."""
    jm, tm = _pair()
    jstep = JaxTrainStep(jm, pt.optimizer.AdamW(
        learning_rate=1e-3, epsilon=0.0, parameters=jm.parameters()),
        lambda m, i, l: m(i, l), nan_check=True)
    opt = topt.AdamW(learning_rate=1e-3, epsilon=0.0,
                     parameters=tm.parameters())
    step = TrainStep(tm, opt, nan_check=True)
    before = _snapshot(tm, opt)
    ids, labels = _batch(0)
    with pytest.raises(JaxNonFinite) as jerr:
        jstep(pt.to_tensor(ids), pt.to_tensor(labels))
    with pytest.raises(NonFiniteError) as terr:
        step(torch.from_numpy(ids), torch.from_numpy(labels))
    got = (terr.value.step, terr.value.leaf, terr.value.kind)
    assert got == (jerr.value.step, jerr.value.leaf, jerr.value.kind)
    assert got == (1, "param/llama.embed_tokens.weight", "param")
    after = _snapshot(tm, opt)
    _same(before[0], after[0])
    _same(before[1], after[1])
    assert opt._global_step == 0 and not opt._accumulators
    # a finite rule from the same state steps through
    opt._epsilon = 1e-8
    assert np.isfinite(float(step(torch.from_numpy(ids),
                                  torch.from_numpy(labels))))
    assert opt._global_step == 1


def test_nan_check_off_steps_through():
    _, tm, _, step, opt = _steps(nan_check=False)
    ids, labels = _batch(0)
    with torch.no_grad():
        tm.lm_head.weight[0, 0] = float("nan")
    loss = step(torch.from_numpy(ids), torch.from_numpy(labels))
    assert not torch.isfinite(loss) and opt._global_step == 1


def test_async_stepper_semantics():
    _, tm, _, step, _ = _steps()
    _, tm2, _, step2, _ = _steps()
    with pytest.raises(ValueError, match="max_in_flight"):
        AsyncStepper(step, max_in_flight=0)
    stepper = AsyncStepper(step2, max_in_flight=2)
    want, got = [], []
    for i in range(5):
        ids, labels = (torch.from_numpy(a) for a in _batch(i))
        want.append(float(step(ids, labels)))
        got.append(stepper(ids, labels))
        assert stepper.in_flight <= stepper.max_in_flight
    last = stepper.drain()
    assert stepper.in_flight == 0 and last is got[-1]
    assert [float(x) for x in got] == want
    assert stepper.compiled_count == 1
    assert stepper.memory_analysis(ids, labels).argument_size_in_bytes > 0
    assert stepper.host_blocked_s >= 0.0


def test_amp_state_is_not_part_of_the_signature():
    """First call outside auto_cast, then inside: one signature, and the
    step inside runs the fp32 program in both packages."""
    _, _, jstep, step, _ = _steps()
    jl, tl = _run_both(jstep, step, 0)
    ids, labels = _batch(1)
    with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
        jl = float(jstep(pt.to_tensor(ids), pt.to_tensor(labels)).numpy())
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        tl = float(step(torch.from_numpy(ids), torch.from_numpy(labels)))
    assert step.compiled_count == jstep.compiled_count == 1
    _, _, jfp, tfp, _ = _steps()
    for i in range(2):
        jw, tw = _run_both(jfp, tfp, i)
    assert abs(tl - tw) < 1e-5 and abs(jl - jw) < 1e-5 and abs(jl - tl) < 1e-5
    assert step.exec_cache_key(ids, labels) == \
        tfp.exec_cache_key(ids, labels) | {"owner": step._serial}


def test_donate_keeps_a_held_state_dict():
    _, tm, _, step, opt = _steps(donate=True)
    ids, labels = (torch.from_numpy(a) for a in _batch(0))
    step(ids, labels)
    held = opt.state_dict()
    copy = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
            for k, v in held.items()}
    w = tm.lm_head.weight
    ptr = w.data_ptr()
    step(ids, labels)
    _same(held, copy)
    assert opt.state_dict()["global_step"] == 2
    assert w.data_ptr() == ptr  # updated in place


_RULES = [
    ("SGD", dict(learning_rate=0.1)),
    ("Momentum", dict(learning_rate=0.1, use_nesterov=True)),
    ("Adagrad", dict(learning_rate=0.1)),
    ("Adam", dict(learning_rate=1e-2, amsgrad=True)),
    ("AdamW", dict(learning_rate=1e-2, weight_decay=0.1)),
    ("Adamax", dict(learning_rate=1e-2)),
    ("RMSProp", dict(learning_rate=1e-2, momentum=0.9, centered=True)),
    ("Lamb", dict(learning_rate=1e-2)),
    ("Adadelta", dict(learning_rate=1.0)),
]


@pytest.mark.parametrize("rule, kw", _RULES, ids=[r for r, _ in _RULES])
def test_capturable_optimizer_matches_eager(rule, kw):
    rng = np.random.RandomState(0)
    init = [rng.randn(5, 3).astype(np.float32),
            rng.randn(4).astype(np.float32)]
    grads = [[rng.randn(*a.shape).astype(np.float32) for a in init]
             for _ in range(3)]
    results = []
    for captured in (False, True):
        ps = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
        ps[1].optimize_attr = {"learning_rate": 0.5}
        opt = getattr(topt, rule)(parameters=ps, **kw)
        buf = torch.zeros(2, dtype=torch.float64)
        for i, gs in enumerate(grads):
            for p, g in zip(ps, gs):
                p.grad = torch.from_numpy(g)
            if captured and i > 0:  # states exist: the captured form
                buf.copy_(torch.tensor([opt.get_lr(), i + 1.0],
                                       dtype=torch.float64))
                opt._dev_scalars = buf
            opt.step()
            opt._dev_scalars = None
        results.append([p.detach().numpy().copy() for p in ps])
    for a, b in zip(*results):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


def test_memory_analysis_and_key_fields():
    _, tm, jstep, step, _ = _steps(donate=True)
    ids, labels = (torch.from_numpy(a) for a in _batch(0))
    step(ids, labels)
    ma = step.memory_analysis(ids, labels)
    n_params = sum(p.numel() * 4 for p in tm.parameters())
    # params, two Adam moments, gradients, the batch
    assert ma.alias_size_in_bytes == 3 * n_params
    assert ma.argument_size_in_bytes == 4 * n_params + 2 * B * S * 4
    assert ma.temp_size_in_bytes is None  # nothing captured on the CPU
    assert ma._fields[:4] == ("argument_size_in_bytes",
                              "output_size_in_bytes", "alias_size_in_bytes",
                              "temp_size_in_bytes")
    key = step.exec_cache_key(ids, labels)
    for field in ("kind", "model", "params", "opt", "donate", "nan_check",
                  "training", "batch"):
        assert field in key
    assert key["donate"] is True and key["kind"] == "train_step"
