"""The port's optimizer surface held against the JAX package on the CPU.

- **Schedulers**: each of the 17 in ``optimizer/lr.py``, built with the
  same arguments on both sides, gives the reference's rate at each of
  41 reads (the initial one and 40 ``step()`` s) within 1e-12 relative;
  ``ReduceOnPlateau`` is fed the same metrics. Its ``state_dict`` equals
  the reference's, and a fresh scheduler loaded from it mid-sequence
  continues the sequence exactly.
- **Update rules**: each rule and option, from the same fp32 weights and
  the same sequence of 5 gradients (numpy, seeded), leaves every
  parameter and every state within 1e-6 of its max abs of the
  reference's (the port fuses expressions into ``_foreach`` ops and
  rounds at other places).
- **Lamb under multi_precision** on bf16 parameters: fp32 masters held
  (within 1e-6 of the reference's), each parameter exactly its master's
  bf16 rounding.
- **Checkpoints**: the ``state_dict`` keys equal the reference's for the
  same run; a run resumed from ``state_dict`` into a fresh optimizer and
  scheduler equals the uninterrupted run bit for bit.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.framework.core import EagerParamBase, Tensor
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.optimizer import lr as tlr

STEPS = 40
SHAPES = [(8, 6), (6,), (3, 4, 5)]
NAMES = ["fc.weight", "fc.bias", "conv.weight"]

# (name, constructor args) shared by both packages
SCHEDULERS = [
    ("NoamDecay", dict(d_model=64, warmup_steps=10, learning_rate=2.0)),
    ("PiecewiseDecay", dict(boundaries=[5, 12, 30],
                            values=[0.1, 0.05, 0.01, 0.001])),
    ("NaturalExpDecay", dict(learning_rate=0.5, gamma=0.1)),
    ("InverseTimeDecay", dict(learning_rate=0.5, gamma=0.2)),
    ("PolynomialDecay", dict(learning_rate=0.1, decay_steps=25,
                             end_lr=0.001, power=2.0)),
    ("PolynomialDecay", dict(learning_rate=0.1, decay_steps=15,
                             end_lr=0.001, power=1.0, cycle=True)),
    ("LinearWarmup", dict(learning_rate=0.1, warmup_steps=8, start_lr=0.0,
                          end_lr=0.1)),
    ("LinearWarmup", dict(learning_rate=("CosineAnnealingDecay",
                                         dict(learning_rate=0.1, T_max=20)),
                          warmup_steps=5, start_lr=0.001, end_lr=0.1)),
    ("ExponentialDecay", dict(learning_rate=0.5, gamma=0.9)),
    ("MultiStepDecay", dict(learning_rate=0.5, milestones=[4, 9, 25],
                            gamma=0.5)),
    ("StepDecay", dict(learning_rate=0.5, step_size=7, gamma=0.3)),
    ("LambdaDecay", dict(learning_rate=0.5,
                         lr_lambda=lambda e: 0.95 ** e)),
    ("MultiplicativeDecay", dict(learning_rate=0.5,
                                 lr_lambda=lambda e: 0.9 if e % 3 else 1.1)),
    ("CosineAnnealingDecay", dict(learning_rate=0.1, T_max=17,
                                  eta_min=0.001)),
    ("CosineAnnealingWarmRestarts", dict(learning_rate=0.1, T_0=5, T_mult=2,
                                         eta_min=0.001)),
    ("ReduceOnPlateau", dict(learning_rate=0.1, patience=2, cooldown=1,
                             factor=0.5)),
    ("ReduceOnPlateau", dict(learning_rate=0.1, mode="max", patience=1,
                             threshold_mode="abs", threshold=0.01)),
    ("OneCycleLR", dict(max_learning_rate=0.1, total_steps=30)),
    ("OneCycleLR", dict(max_learning_rate=0.1, total_steps=30,
                        anneal_strategy="linear", phase_pct=0.4)),
    ("CyclicLR", dict(base_learning_rate=0.01, max_learning_rate=0.1,
                      step_size_up=6)),
    ("CyclicLR", dict(base_learning_rate=0.01, max_learning_rate=0.1,
                      step_size_up=4, step_size_down=7,
                      mode="triangular2")),
    ("CyclicLR", dict(base_learning_rate=0.01, max_learning_rate=0.1,
                      step_size_up=5, mode="exp_range", exp_gamma=0.97)),
    ("LinearLR", dict(learning_rate=0.2, total_steps=25)),
]
# the metric ReduceOnPlateau reads at each step: falls, then plateaus,
# then rises
METRICS = [1.0 / (1 + i) if i < 10 else 0.1 + 0.001 * ((i * 7) % 5)
           + (0.02 * (i - 30) if i > 30 else 0.0) for i in range(STEPS)]


def _make(mod, name, kw):
    kw = dict(kw)
    inner = kw.get("learning_rate")
    if isinstance(inner, tuple):
        kw["learning_rate"] = _make(mod, *inner)
    return getattr(mod, name)(**kw)


def _advance(sched, i):
    if isinstance(sched, (jlr.ReduceOnPlateau, tlr.ReduceOnPlateau)):
        sched.step(METRICS[i])
    else:
        sched.step()


def _ids(cases):
    return [f"{n}{i}" for i, (n, _) in enumerate(cases)]


def test_every_scheduler_is_ported():
    names = {n for n, _ in SCHEDULERS}
    want = {n for n, c in vars(jlr).items()
            if isinstance(c, type) and issubclass(c, jlr.LRScheduler)
            and c is not jlr.LRScheduler}
    assert names == want and len(want) == 17
    assert set(tlr.__all__) == want | {"LRScheduler"}


@pytest.mark.parametrize("name, kw", SCHEDULERS, ids=_ids(SCHEDULERS))
def test_scheduler_sequence_and_state_match_reference(name, kw):
    ref, got = _make(jlr, name, kw), _make(tlr, name, kw)
    want_seq, got_seq = [ref()], [got()]
    resumed = None
    for i in range(STEPS):
        _advance(ref, i)
        _advance(got, i)
        want_seq.append(ref())
        got_seq.append(got())
        if resumed is not None:
            _advance(resumed, i)
            assert resumed() == got(), (name, i)
        if i == STEPS // 2 - 3:
            assert got.state_dict() == ref.state_dict()
            resumed = _make(tlr, name, kw)
            resumed.set_state_dict(got.state_dict())
            assert resumed() == got()
    np.testing.assert_allclose(got_seq, want_seq, rtol=1e-12, atol=0)
    assert len(set(got_seq)) > 1, "the sequence never moved"


def test_scheduler_state_dict_drops_functions_and_nests_warmup():
    lam = tlr.LambdaDecay(0.5, lambda e: 0.9 ** e)
    assert set(lam.state_dict()) == {"last_epoch", "last_lr"}
    warm = tlr.LinearWarmup(tlr.PolynomialDecay(1e-4, decay_steps=100), 2,
                            1e-5, 1e-4)
    for _ in range(4):
        warm.step()
    inner = warm.state_dict()["LinearWarmup_LR"]
    assert inner["last_epoch"] == 2 and inner["decay_steps"] == 100


def _weights(seed=0, shapes=SHAPES):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _grads(step, seed=0, shapes=SHAPES):
    rng = np.random.RandomState(1000 * seed + step + 1)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _jax_params(ws, dtype=None, attrs=None):
    ps = []
    for i, w in enumerate(ws):
        p = EagerParamBase(w, dtype=dtype, name=NAMES[i])
        for k, v in (attrs or {}).get(i, {}).items():
            setattr(p, k, v)
        ps.append(p)
    return ps


def _torch_params(ws, dtype=torch.float32, attrs=None):
    ps = []
    for i, w in enumerate(ws):
        p = torch.nn.Parameter(torch.from_numpy(w.copy()).to(dtype))
        for k, v in (attrs or {}).get(i, {}).items():
            setattr(p, k, v)
        ps.append(p)
    return ps


def _reg(mod, spec):
    """("l1" | "l2", coeff) as the package's regularizer object."""
    kind, coeff = spec
    return (mod.L1Decay if kind == "l1" else mod.L2Decay)(coeff)


def _attrs(mod, attrs):
    out = {}
    for i, a in (attrs or {}).items():
        out[i] = {k: _reg(mod, v) if k == "regularizer" else v
                  for k, v in a.items()}
    return out


def _exclude_bias(name):
    return name.endswith("bias")


# (id, optimizer class, kwargs, per-parameter attributes {i: {attr: v}});
# a kwarg ("l1" | "l2", c) under weight_decay becomes the package's
# regularizer object
RULES = [
    ("momentum", "Momentum", dict(learning_rate=0.01, momentum=0.9), None),
    ("momentum_nesterov", "Momentum",
     dict(learning_rate=0.01, momentum=0.9, use_nesterov=True), None),
    ("adagrad", "Adagrad",
     dict(learning_rate=0.1, initial_accumulator_value=0.1), None),
    ("adam_amsgrad", "Adam", dict(learning_rate=0.01, amsgrad=True), None),
    ("adamw_amsgrad", "AdamW",
     dict(learning_rate=0.01, amsgrad=True, weight_decay=0.05), None),
    ("adamax", "Adamax", dict(learning_rate=0.01), None),
    ("rmsprop", "RMSProp", dict(learning_rate=0.01, momentum=0.9), None),
    ("rmsprop_centered", "RMSProp",
     dict(learning_rate=0.01, momentum=0.5, centered=True), None),
    ("lamb", "Lamb", dict(learning_rate=0.01, lamb_weight_decay=0.01),
     None),
    ("lamb_exclude", "Lamb",
     dict(learning_rate=0.01, lamb_weight_decay=0.05,
          exclude_from_weight_decay_fn=_exclude_bias), None),
    ("adadelta", "Adadelta", dict(learning_rate=1.0, rho=0.9), None),
    ("sgd_l2", "SGD", dict(learning_rate=0.1, weight_decay=("l2", 0.05)),
     None),
    ("sgd_l1_optimizer_level", "SGD",
     dict(learning_rate=0.1, weight_decay=("l1", 0.05)), None),
    ("momentum_param_regularizers", "Momentum",
     dict(learning_rate=0.01, weight_decay=("l2", 0.05)),
     {0: {"regularizer": ("l1", 0.02)}, 2: {"regularizer": ("l2", 0.1)}}),
    ("adamw_param_regularizer_and_decay_fn", "AdamW",
     dict(learning_rate=0.01, weight_decay=0.1,
          apply_decay_param_fun=lambda n: not n.endswith("bias")),
     {0: {"regularizer": ("l1", 0.02)}}),
    ("adam_optimize_attr", "Adam", dict(learning_rate=0.01),
     {0: {"optimize_attr": {"learning_rate": 0.5}},
      2: {"optimize_attr": {"learning_rate": 3.0}}}),
    ("adagrad_l1_and_lr_factor", "Adagrad",
     dict(learning_rate=0.1),
     {1: {"regularizer": ("l1", 0.01),
          "optimize_attr": {"learning_rate": 0.25}}}),
]


def _build(mod, cls, kw, params):
    """The optimizer over ``params``; the port's is given them named
    (``(name, param)`` pairs), the reference's carry ``name``."""
    kw = dict(kw)
    if mod is topt:
        params = list(zip(NAMES, params))
    if isinstance(kw.get("weight_decay"), tuple):
        kw["weight_decay"] = _reg(mod, kw["weight_decay"])
    return getattr(mod, cls)(parameters=params, **kw)


def _run_ref(cls, kw, attrs, steps, ws, dtype=None):
    params = _jax_params(ws, dtype, _attrs(pt.optimizer, attrs))
    opt = _build(pt.optimizer, cls, kw, params)
    for s in range(steps):
        for p, g in zip(params, _grads(s)):
            p.grad = Tensor(g, dtype=dtype)
        opt.step()
    return opt, params


def _run_port(cls, kw, attrs, steps, ws, dtype=torch.float32):
    params = _torch_params(ws, dtype, _attrs(treg, attrs))
    opt = _build(topt, cls, kw, params)
    for s in range(steps):
        for p, g in zip(params, _grads(s)):
            p.grad = torch.from_numpy(g).to(dtype)
        opt.step()
    return opt, params


def _close(got, want, name):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got, want, atol=1e-6 * scale, rtol=0,
                               err_msg=name)


@pytest.mark.parametrize("rid, cls, kw, attrs", RULES,
                         ids=[r[0] for r in RULES])
def test_update_rule_matches_reference(rid, cls, kw, attrs):
    ws = _weights()
    jopt, jps = _run_ref(cls, kw, attrs, 5, ws)
    topt_, tps = _run_port(cls, kw, attrs, 5, ws)
    moved = 0.0
    for i, (jp, tp) in enumerate(zip(jps, tps)):
        _close(tp, jp.numpy(), f"{rid} param {i}")
        moved = max(moved, float(np.abs(jp.numpy() - ws[i]).max()))
        jst = jopt._accumulators[id(jp)]
        tst = topt_._accumulators[id(tp)]
        assert set(tst) == set(jst), (rid, i)
        for k in jst:
            _close(tst[k], jst[k], f"{rid} param {i} {k}")
    assert moved > 1e-4, f"{rid}: the parameters barely moved"
    assert topt_._global_step == jopt._global_step == 5


def test_lamb_trust_ratio_is_per_parameter():
    """Scaling one parameter's weights leaves the others' steps alone:
    the norms are each parameter's, not the group's."""
    ws = _weights()
    kw = dict(learning_rate=0.01, lamb_weight_decay=0.01)
    _, a = _run_port("Lamb", kw, None, 3, ws)
    _, b = _run_port("Lamb", kw, None, 3, [ws[0] * 10.0] + ws[1:])
    for p, q in zip(a[1:], b[1:]):
        torch.testing.assert_close(p, q, rtol=0, atol=0)


def test_lamb_multi_precision_bf16():
    ws = _weights()
    kw = dict(learning_rate=0.01, lamb_weight_decay=0.01,
              multi_precision=True)
    jopt, jps = _run_ref("Lamb", kw, None, 5, ws, dtype="bfloat16")
    opt, tps = _run_port("Lamb", kw, None, 5, ws, dtype=torch.bfloat16)
    for i, (jp, tp) in enumerate(zip(jps, tps)):
        master = opt._master_weights[id(tp)]
        assert tp.dtype == torch.bfloat16 and master.dtype == torch.float32
        assert torch.equal(tp.detach(), master.to(torch.bfloat16)), i
        _close(master, np.asarray(jopt._master_weights[id(jp)]),
               f"master {i}")
        for k, v in opt._accumulators[id(tp)].items():
            assert v.dtype == torch.float32, k
            _close(v, jopt._accumulators[id(jp)][k], f"param {i} {k}")


def _sched(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(0.01, T_max=8), 3,
                            0.001, 0.01)


def test_scheduler_drives_the_optimizer_and_set_lr_raises():
    ws = _weights()
    jps, tps = _jax_params(ws), _torch_params(ws)
    jsch, tsch = _sched(jlr), _sched(tlr)
    jopt = pt.optimizer.Adam(learning_rate=jsch, parameters=jps)
    opt = topt.Adam(learning_rate=tsch, parameters=tps)
    for s in range(6):
        assert opt.get_lr() == jopt.get_lr()
        for jp, tp, g in zip(jps, tps, _grads(s)):
            jp.grad, tp.grad = Tensor(g), torch.from_numpy(g)
        jopt.step()
        opt.step()
        jsch.step()
        tsch.step()
    for i, (jp, tp) in enumerate(zip(jps, tps)):
        _close(tp, jp.numpy(), f"param {i}")
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.1)
    plain = topt.SGD(learning_rate=0.5, parameters=tps)
    plain.set_lr(0.25)
    assert plain.get_lr() == 0.25


def test_minimize_and_clear_gradients():
    w = torch.nn.Parameter(torch.ones(3))
    opt = topt.SGD(learning_rate=0.5, parameters=[w])
    opt.minimize((w * torch.tensor([1.0, 2.0, 3.0])).sum())
    torch.testing.assert_close(w.detach(), torch.tensor([0.5, 0.0, -0.5]))
    opt.clear_gradients()
    assert w.grad is None


@pytest.mark.parametrize("multi_precision", [False, True],
                         ids=["fp32", "bf16_masters"])
def test_state_dict_keys_follow_the_reference(multi_precision):
    ws = _weights()
    dtype, tdtype = (("bfloat16", torch.bfloat16) if multi_precision
                     else (None, torch.float32))
    jps = _jax_params(ws, dtype)
    for p in jps:
        p.name = None  # unnamed: param_{i}
    tps = _torch_params(ws, tdtype)
    jopt = pt.optimizer.AdamW(learning_rate=_sched(jlr), parameters=jps,
                              multi_precision=multi_precision)
    opt = topt.AdamW(learning_rate=_sched(tlr), parameters=tps,
                     multi_precision=multi_precision)
    for s in range(2):
        for jp, tp, g in zip(jps, tps, _grads(s)):
            jp.grad = Tensor(g, dtype=dtype)
            tp.grad = torch.from_numpy(g).to(tdtype)
        jopt.step()
        opt.step()
    want, got = jopt.state_dict(), opt.state_dict()
    assert set(got) == set(want)
    assert "param_0.moment1" in got and "global_step" in got
    assert ("param_2.master_weight" in got) == multi_precision
    assert got["LR_Scheduler"] == want["LR_Scheduler"]
    for k, v in want.items():
        if isinstance(v, Tensor):
            _close(got[k], v.numpy(), k)
        elif k != "LR_Scheduler":
            assert got[k] == v, k


@pytest.mark.parametrize("cls, kw", [
    ("Lamb", dict(lamb_weight_decay=0.01, multi_precision=True)),
    ("AdamW", dict(weight_decay=0.01, multi_precision=True, amsgrad=True)),
    ("RMSProp", dict(momentum=0.9, centered=True)),
], ids=["lamb_bf16", "adamw_bf16", "rmsprop_fp32"])
def test_resume_from_state_dict_is_bit_identical(cls, kw):
    ws = _weights()
    dtype = torch.bfloat16 if kw.get("multi_precision") else torch.float32

    def fresh():
        ps = _torch_params(ws, dtype)
        sched = _sched(tlr)
        return ps, sched, _build(topt, cls, dict(kw, learning_rate=sched), ps)

    def run(ps, sched, opt, start, steps):
        for s in range(start, start + steps):
            for p, g in zip(ps, _grads(s)):
                p.grad = torch.from_numpy(g).to(dtype)
            opt.step()
            sched.step()

    ps, sched, opt = fresh()
    run(ps, sched, opt, 0, 10)
    qs, qsched, qopt = fresh()
    run(qs, qsched, qopt, 0, 5)
    sd = qopt.state_dict()
    weights = [q.detach().clone() for q in qs]
    rs, rsched, ropt = fresh()
    with torch.no_grad():
        for r, w in zip(rs, weights):
            r.copy_(w)
    ropt.set_state_dict(sd)
    assert rsched() == qsched() and ropt._global_step == 5
    run(rs, rsched, ropt, 5, 5)
    for p, r in zip(ps, rs):
        assert torch.equal(p.detach(), r.detach())
        for k, v in opt._accumulators[id(p)].items():
            assert torch.equal(v, ropt._accumulators[id(r)][k]), k
    assert opt.get_lr() == ropt.get_lr()
