"""The port's framework surface held against the reference's on the CPU:
the flags (``framework/flags.py``, the reference's ``TestFlags`` cases of
``tests/test_io_metric_flags.py:51-76`` with the ``/`` operator), the
``FLAGS_`` environment read at import, the structured errors
(``framework/errors.py``), the long tail of ``framework/compat.py``,
the default dtype, the RNG state (``framework/random.py``), the device
functions without a card (``framework/device.py``), ``summary`` and
``flops`` (``hapi/summary.py``) and the grad-clip utilities
(``nn/clip.py``).
"""
import contextlib
import io as _io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.framework import dtype as jdtype
from paddle_tpu.framework import errors as jerr
from paddle_tpu_torch.framework import dtype as tdtype
from paddle_tpu_torch.framework import errors as terr
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.framework.device import using_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    with using_device("cpu"):
        yield


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.numpy())


# -- flags --------------------------------------------------------------------

@pytest.mark.parametrize("P", [jp, tp], ids=["reference", "port"])
def test_flags_get_set(P):
    flags = P.get_flags()
    assert "check_nan_inf" in flags
    P.set_flags({"FLAGS_check_nan_inf_level": 1})
    assert P.get_flags("FLAGS_check_nan_inf_level")[
        "FLAGS_check_nan_inf_level"] == 1
    P.set_flags({"FLAGS_check_nan_inf_level": 0})
    with pytest.raises(ValueError):
        P.set_flags({"FLAGS_not_a_flag": 1})
    with pytest.raises(ValueError):
        P.get_flags(["FLAGS_not_a_flag"])


def test_flags_are_the_reference_set():
    assert tp.get_flags() == jp.get_flags()


def test_nan_check_hook_on_the_divide_operator_and_log():
    tp.set_flags({"FLAGS_check_nan_inf": True})
    try:
        x = tp.to_tensor([1.0, 0.0])
        with pytest.raises(FloatingPointError, match="output of op"):
            _ = x / tp.to_tensor([1.0, 0.0])
        with pytest.raises(FloatingPointError, match="'log'"):
            tp.log(tp.to_tensor([-1.0, 2.0]))
        # finite outputs pass, integer ones are not read
        np.testing.assert_allclose(_np(x * 2), [2.0, 0.0])
        tp.set_flags({"FLAGS_check_nan_inf_level": 1})
        with pytest.warns(UserWarning, match="NaN/Inf"):
            _ = x / tp.to_tensor([1.0, 0.0])
    finally:
        tp.set_flags({"FLAGS_check_nan_inf": False,
                      "FLAGS_check_nan_inf_level": 0})
    # after disabling, no raise
    out = tp.to_tensor([1.0]) / tp.to_tensor([0.0])
    assert np.isinf(_np(out)).all()


def test_flags_from_the_environment_at_import():
    code = ("import paddle_tpu_torch as p\n"
            "p.set_device('cpu')\n"
            "print(p.get_flags(['check_nan_inf', 'log_level',"
            " 'matmul_precision']))\n"
            "try:\n"
            "    p.to_tensor([1.0]) / p.to_tensor([0.0])\n"
            "except FloatingPointError:\n"
            "    print('raised')\n")
    env = dict(os.environ, PYTHONPATH=ROOT, FLAGS_check_nan_inf="1",
               FLAGS_log_level="3", FLAGS_matmul_precision="highest")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == [
        "{'check_nan_inf': True, 'log_level': 3, "
        "'matmul_precision': 'highest'}", "raised"]


# -- errors ---------------------------------------------------------------------

ERRORS = [n for n in jerr.__all__ if n.endswith("Error")]


@pytest.mark.parametrize("name", ERRORS)
def test_error_classes_match_the_reference(name):
    j, t = getattr(jerr, name), getattr(terr, name)
    assert t.category == j.category
    assert [c.__name__ for c in t.__mro__] == [c.__name__ for c in j.__mro__]
    assert str(t("bad", "f.py:3")) == str(j("bad", "f.py:3"))


def test_enforce_helpers_match_the_reference():
    assert terr.__all__ == jerr.__all__
    cases = [("enforce_eq", 1, 2), ("enforce_ne", 1, 1), ("enforce_gt", 1, 2),
             ("enforce_ge", 1, 2), ("enforce_lt", 2, 1), ("enforce_le", 2, 1)]
    for name, a, b in cases:
        for mod in (jerr, terr):
            with pytest.raises(mod.InvalidArgumentError) as e:
                getattr(mod, name)(a, b, "sizes")
            assert e.value.summary.startswith("sizes (expected lhs")
        if name in ("enforce_eq", "enforce_ge", "enforce_le"):
            getattr(terr, name)(a, a, "equal passes")
    with pytest.raises(terr.NotFoundError):
        terr.enforce_not_none(None, "missing")
    assert terr.enforce_not_none(3, "x") == 3
    with pytest.raises(ValueError, match="InvalidArgument: no"):
        terr.enforce(False, "no")
    with pytest.raises(terr.UnimplementedError):
        terr.enforce(0, "later", terr.UnimplementedError)


# -- compat -----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["float16", "bfloat16", "float32", "float64"])
def test_finfo_matches_the_reference(name):
    j, t = jp.finfo(name), tp.finfo(name)
    # (torch's ``resolution`` is 10**-digits, numpy's rounds otherwise)
    for attr in ("bits", "eps", "max", "min", "tiny"):
        np.testing.assert_allclose(float(getattr(t, attr)),
                                   float(getattr(j, attr)), rtol=1e-6)
    assert tp.finfo(getattr(tp, name)).bits == j.bits


@pytest.mark.parametrize("name", ["uint8", "int8", "int16", "int32", "int64"])
def test_iinfo_matches_the_reference(name):
    j, t = jp.iinfo(name), tp.iinfo(name)
    assert (t.bits, t.min, t.max) == (j.bits, j.min, j.max)


def test_shape_rank_tolist_and_kind_helpers_match_the_reference():
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    jx, tx = jp.to_tensor(a), tp.to_tensor(a)
    np.testing.assert_array_equal(_np(tp.shape(tx)), _np(jp.shape(jx)))
    assert tp.shape(tx).dtype == torch.int32
    assert int(tp.rank(tx)) == int(jp.rank(jx)) == 3
    assert tp.tolist(tx) == jp.tolist(jx)
    for dt in ("bool", "uint8", "int8", "int16", "int32", "float16",
               "bfloat16", "float32", "complex64"):
        jt, tt = jx.astype(dt), tx.to(tdtype.to_torch_dtype(dt))
        for fn in ("is_floating_point", "is_integer", "is_complex"):
            assert getattr(tp, fn)(tt) == getattr(jp, fn)(jt), (fn, dt)
            assert getattr(tp, fn)(dt) == getattr(jp, fn)(dt), (fn, dt)
    tp.check_shape([2, np.int64(3), tp.to_tensor([4])])
    with pytest.raises(TypeError):
        tp.check_shape([2, 3.5])
    with pytest.raises(TypeError):
        jp.check_shape([2, 3.5])


def test_places_static_flag_and_guards():
    assert str(tp.CPUPlace()) == str(jp.CPUPlace()) == "cpu"
    assert str(tp.CUDAPinnedPlace()) == "cpu"
    assert str(tp.CUDAPlace(1)) == "gpu:1"  # the reference's says tpu:1
    assert tp.CUDAPlace(1) == tp.CUDAPlace(1) != tp.CUDAPlace(0)
    assert len({tp.CUDAPlace(0), tp.CUDAPlace(0), tp.CPUPlace()}) == 2
    assert repr(tp.CUDAPlace(2)) == repr(jp.CUDAPlace(2))
    before = tp.get_device()
    try:
        assert tp.set_device(tp.CPUPlace()) == torch.device("cpu")
        assert tp.get_device() == "cpu"
        with pytest.raises(ValueError, match="unsupported device"):
            tp.set_device(tp.TPUPlace(0))
    finally:
        tp.framework.device._current[0] = before
    for P in (jp, tp):
        assert P.in_dynamic_mode() and not P.in_static_mode()
        P.enable_static()
        assert P.in_static_mode() and not P.in_dynamic_mode()
        P.disable_static()
        assert P.in_dynamic_mode()
        with P.LazyGuard() as g:
            assert g is not None
        assert P.disable_signal_handler() is None


def test_create_parameter_and_printoptions():
    j = jp.create_parameter([3, 4], "float32", is_bias=True)
    t = tp.create_parameter([3, 4], "float32", is_bias=True)
    assert list(t.shape) == list(j.shape) and t.requires_grad
    np.testing.assert_array_equal(_np(t), _np(j))
    t = tp.create_parameter([2, 5], attr=tp.ParamAttr(
        initializer=tp.nn.initializer.Constant(0.5), learning_rate=2.0,
        trainable=False))
    assert float(t.sum()) == 5.0 and not t.requires_grad
    assert t.optimize_attr == {"learning_rate": 2.0}
    try:
        tp.set_printoptions(precision=2, sci_mode=False)
        assert "1.23" in repr(torch.tensor([1.23456]))
    finally:
        torch.set_printoptions(profile="default")
        np.set_printoptions(precision=8, suppress=False)


# -- the default dtype --------------------------------------------------------------

@pytest.mark.parametrize("name", ["float16", "bfloat16", "float32", "float64"])
def test_default_dtype_matches_the_reference(name):
    try:
        jp.set_default_dtype(name)
        tp.set_default_dtype(name)
        assert tdtype.dtype_name(tp.get_default_dtype()) == name
        for init in ("Normal", "XavierNormal", "Constant", "Uniform"):
            j = getattr(jp.nn.initializer, init)()([2, 3])
            t = getattr(tp.nn.initializer, init)()([2, 3])
            assert list(t.shape) == [2, 3]
            assert tdtype.dtype_name(t.dtype) == jdtype.dtype_name(j.dtype), init
        # a layer's parameters follow the layer's dtype, not the default
        jl, tl = jp.nn.Linear(3, 2), tp.nn.Linear(3, 2)
        assert tdtype.dtype_name(tl.weight.dtype) == jdtype.dtype_name(
            jl.weight.dtype)
        assert tdtype.dtype_name(tl.bias.dtype) == jdtype.dtype_name(
            jl.bias.dtype)
    finally:
        jp.set_default_dtype("float32")
        tp.set_default_dtype("float32")


CREATION = {
    "zeros": lambda P: P.zeros([2]), "ones": lambda P: P.ones([2]),
    "full_float": lambda P: P.full([2], 1.5),
    "full_int": lambda P: P.full([2], 1), "empty": lambda P: P.empty([2]),
    "rand": lambda P: P.rand([2]), "randn": lambda P: P.randn([2]),
    "uniform": lambda P: P.uniform([2]),
    "normal": lambda P: P.normal(shape=[2]),
    "standard_normal": lambda P: P.standard_normal([2]),
    "linspace": lambda P: P.linspace(0, 1, 3),
    "logspace": lambda P: P.logspace(0, 1, 3), "eye": lambda P: P.eye(2),
    "arange_float": lambda P: P.arange(0, 2, 0.5),
    "arange_int": lambda P: P.arange(3),
    "to_tensor": lambda P: P.to_tensor([1.0]),
    "randint": lambda P: P.randint(0, 3, [2]),
    "zeros_like": lambda P: P.zeros_like(P.to_tensor([1])),
    "randperm": lambda P: P.randperm(3),
}


@pytest.mark.parametrize("name", ["float16", "bfloat16", "float64"])
def test_creation_ops_follow_the_default_dtype_as_the_reference(name):
    try:
        jp.set_default_dtype(name)
        tp.set_default_dtype(name)
        got = {k: tdtype.dtype_name(f(tp).dtype) for k, f in CREATION.items()}
        want = {k: jdtype.dtype_name(f(jp).dtype)
                for k, f in CREATION.items()}
    finally:
        jp.set_default_dtype("float32")
        tp.set_default_dtype("float32")
    assert got == want


def test_default_dtype_refuses_non_floating():
    for P in (jp, tp):
        with pytest.raises(TypeError):
            P.set_default_dtype("int32")
    assert tp.get_default_dtype() is torch.float32
    assert tdtype.convert_dtype("FP16") is torch.float16
    assert tdtype.convert_dtype(None) is None


# -- the RNG state -------------------------------------------------------------------

def _draws():
    x = torch.ones(64)
    return (_np(tp.randn([8])), _np(tp.nn.functional.dropout(x, 0.5)),
            trandom.next_seed_words(), _np(tp.randint(0, 100, [4])))


def _same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_rng_state_round_trip_repeats_draws():
    tp.seed(7)
    _draws()
    state = tp.get_rng_state()
    first = _draws()
    assert not np.array_equal(first[0], _draws()[0])
    tp.set_rng_state(state)
    _same(_draws(), first)
    # the state object is a snapshot: drawing does not change it
    tp.set_rng_state(state)
    _same(_draws(), first)
    cuda_state = tp.get_cuda_rng_state()
    assert isinstance(cuda_state, list) and len(cuda_state) == 1
    again = _draws()
    tp.set_cuda_rng_state(cuda_state)
    _same(_draws(), again)


def test_rng_scope_draws_from_its_state_and_restores():
    tp.seed(3)
    state = tp.get_rng_state()
    outside = _draws()
    tp.seed(3)
    with trandom.rng_scope(state):
        _same(_draws(), outside)
    # the state before the block is back: the draws after it continue
    # the outer stream as if the block had not drawn
    tp.seed(3)
    _draws()
    after = _draws()
    tp.seed(3)
    _draws()
    with trandom.rng_scope(state):
        _draws()
    _same(_draws(), after)


# -- the device functions without a card -------------------------------------------

@pytest.mark.parametrize("name", [
    "memory_stats", "memory_allocated", "max_memory_allocated",
    "memory_reserved", "max_memory_reserved", "reset_max_memory_allocated",
    "reset_max_memory_reserved", "empty_cache", "get_device_properties"])
def test_device_memory_functions_raise_without_a_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(tp.device, name)()


def test_device_count_and_tpu():
    assert tp.device_count() == torch.cuda.device_count()
    assert tp.device_count("cpu") == 1 and tp.device_count("tpu") == 0
    assert tp.is_compiled_with_tpu() is False
    with pytest.raises(ValueError, match="not a card"):
        tp.device.memory_allocated("cpu")


# -- summary and flops ------------------------------------------------------------

def _lenet(P):
    return P.vision.models.LeNet(), (1, 1, 28, 28)


def _mlp(P):
    nn = P.nn
    return nn.Sequential(nn.Linear(10, 32), nn.ReLU(), nn.Linear(32, 1)), \
        (1, 10)


@pytest.mark.parametrize("make", [_lenet, _mlp], ids=["lenet", "mlp"])
def test_summary_and_flops_match_the_reference(make):
    got = {}
    for key, P in (("j", jp), ("t", tp)):
        net, size = make(P)
        buf = _io.StringIO()
        with contextlib.redirect_stdout(buf):
            info = P.summary(net, size)
            n = P.flops(net, size, print_detail=True)
        got[key] = (info, n, buf.getvalue(), net)
    assert got["t"][:3] == got["j"][:3]
    net = got["t"][3]
    assert got["t"][0]["total_params"] == sum(p.numel()
                                              for p in net.parameters())
    assert net.training  # summary restores the mode


def test_summary_counts_frozen_parameters_and_custom_flops():
    net = tp.nn.Sequential(tp.nn.Linear(4, 8), tp.nn.ReLU(),
                           tp.nn.Linear(8, 2))
    net[0].weight.requires_grad_(False)
    with contextlib.redirect_stdout(_io.StringIO()):
        info = tp.summary(net, input=torch.zeros(3, 4))
    assert info == {"total_params": 58, "trainable_params": 26}
    n = tp.flops(net, [1, 4], custom_ops={tp.nn.ReLU: lambda l, i, o: 100})
    assert n == 1 * 8 * 4 + 100 + 1 * 2 * 8


# -- the grad clips -------------------------------------------------------------------

def _grads_pair(seed=0):
    rng = np.random.RandomState(seed)
    w1, w2 = rng.randn(4, 3).astype(np.float32), rng.randn(3).astype(
        np.float32)
    x = rng.randn(5, 4).astype(np.float32)
    jw = [jp.to_tensor(w, stop_gradient=False) for w in (w1, w2)]
    tw = [torch.tensor(w, requires_grad=True) for w in (w1, w2)]
    ((jp.to_tensor(x) @ jw[0] + jw[1]) ** 2).sum().backward()
    ((torch.tensor(x) @ tw[0] + tw[1]) ** 2).sum().backward()
    return jw, tw


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
@pytest.mark.parametrize("max_norm", [0.5, 1e4])
def test_clip_grad_norm_matches_the_reference(norm_type, max_norm):
    from paddle_tpu.nn import clip as jclip

    jw, tw = _grads_pair()
    jt = jclip.clip_grad_norm_(jw, max_norm, norm_type)
    tt = tp.nn.clip.clip_grad_norm_(tw, max_norm, norm_type)
    np.testing.assert_allclose(float(tt), float(_np(jt)), rtol=TOL)
    for j, t in zip(jw, tw):
        np.testing.assert_allclose(_np(t.grad), _np(j.grad), rtol=TOL,
                                   atol=TOL)


def test_clip_grad_value_and_clip_base():
    from paddle_tpu.nn import clip as jclip

    jw, tw = _grads_pair(1)
    jclip.clip_grad_value_(jw, 0.7)
    tp.nn.clip.clip_grad_value_(tw, 0.7)
    for j, t in zip(jw, tw):
        np.testing.assert_array_equal(_np(t.grad), _np(j.grad))
    assert float(tp.nn.clip.clip_grad_norm_([torch.zeros(2)], 1.0)) == 0.0
    jw, tw = _grads_pair(2)
    tw[0].grad[0, 0] = float("nan")
    with pytest.raises(RuntimeError, match="not finite"):
        tp.nn.clip.clip_grad_norm_(tw, 1.0, error_if_nonfinite=True)
    for name in ("ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"):
        assert issubclass(getattr(tp.nn, name), tp.nn.clip.ClipGradBase)
    with pytest.raises(NotImplementedError):
        tp.nn.clip.ClipGradBase()([])


# -- paddle.batch and paddle.callbacks -------------------------------------------

@pytest.mark.parametrize("drop_last", [False, True])
def test_batch_matches_the_reference(drop_last):
    def reader():
        yield from range(7)

    assert list(tp.batch(reader, 3, drop_last)()) == \
        list(jp.batch(reader, 3, drop_last)())
    with pytest.raises(ValueError, match="positive"):
        tp.batch(reader, 0)


def test_callbacks_at_the_top_level():
    from paddle_tpu_torch import hapi

    cb = tp.callbacks
    assert cb.LRScheduler is hapi.LRSchedulerCallback
    assert sorted(cb.__all__) == sorted(
        n for n in jp.callbacks.__all__ if n != "VisualDL")
    with pytest.raises(AttributeError, match="ROADMAP A.7"):
        cb.VisualDL
