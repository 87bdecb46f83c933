"""The port's tensor ops that ``tests/op_specs.py`` has no spec for, held
against the reference with the same numpy inputs.

- ``CASES`` (``tests/torch_tensor_cases.py``, free of JAX so that
  ``chip_smoke.py`` phase 23 runs the same rows on the card): one row
  per call, ``(id, call, inputs)``; ``call(m, *xs)``
  drives either package (``m`` is ``paddle_tpu`` or ``paddle_tpu_torch``)
  on the inputs made tensors by each package's ``to_tensor``. The
  outputs must carry the reference's dtype names and equal its values
  (``TOL`` relative to the largest magnitude; ints and bools exactly).
  The rows also hold the dtype rules (int32 indices and integer sums,
  ``full`` and ``arange`` inference), ``median``'s average mode and the
  tie-breaking of ``topk``, ``kthvalue``, ``argsort``, ``sort`` and
  ``mode``.
- ``call_inplace``: the 42 top-level in-place variants, each returning
  its input with the reference's values.
- the random ops: moments within stated bounds, a Kolmogorov-Smirnov
  test for ``uniform`` and ``normal`` (scipy), one seed giving one draw,
  ``draws()`` counting each call; ``pca_lowrank`` by its invariants.
- placement, and one white and one black op under ``auto_cast``.

The sweep's completeness test reads the functions these rows call from
``torch_tensor_cases.covered()``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from scipy import stats

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.framework.device import using_device
from torch_tensor_cases import (
    CASES, PCA, RANDOM, SIGMAS, TIES, N, call_inplace, draw, pca,
)

TOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with using_device("cpu"):
        yield


def _port_tensor(a):
    return ptt.to_tensor(np.array(a), place="cpu")


def _same(got, want, name):
    """``got`` (the port's) against ``want`` (the reference's): the same
    structure, dtype names and shapes; ints and bools equal, floats
    within ``TOL`` of the largest magnitude."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), \
            (name, got, want)
        for g, w in zip(got, want):
            _same(g, w, name)
        return
    if not isinstance(want, pt.Tensor):
        assert got == want, (name, got, want)
        return
    assert isinstance(got, torch.Tensor), (name, type(got))
    w = np.asarray(want.numpy())
    g = got.detach().cpu().numpy()
    assert str(got.dtype).replace("torch.", "") == w.dtype.name, \
        (name, got.dtype, w.dtype)
    assert g.shape == w.shape, (name, g.shape, w.shape)
    if w.dtype.kind in "biu":
        np.testing.assert_array_equal(g, w, err_msg=name)
        return
    fin = np.isfinite(w)
    np.testing.assert_array_equal(np.isfinite(g), fin, err_msg=name)
    scale = np.abs(w[fin]).max() + 1e-30 if fin.any() else 1.0
    np.testing.assert_allclose(g[fin] / scale, w[fin] / scale, atol=TOL,
                               rtol=0, err_msg=name)


@pytest.mark.parametrize("name,call,inputs", CASES,
                         ids=[c[0] for c in CASES])
def test_op_matches_reference(name, call, inputs):
    want = call(pt, *[pt.to_tensor(np.array(a)) for a in inputs])
    got = call(ptt, *[_port_tensor(a) for a in inputs])
    _same(got, want, name)


def test_median_averages_and_ties_break_as_the_reference():
    """The values the rows above hold, spelled out."""
    assert float(ptt.median(_port_tensor([1.0, 2.0, 3.0, 4.0]))) == 2.5
    t = _port_tensor(TIES)
    vals, idx = ptt.topk(t, 2)
    assert idx.tolist() == [[1, 2], [0, 1]] and idx.dtype == torch.int32
    assert ptt.kthvalue(t, 2)[1].tolist() == [3, 4]
    v, i = ptt.mode(t)
    assert v.tolist() == [3.0, 1.0] and i.tolist() == [4, 2]
    assert ptt.argsort(t, axis=1).tolist()[1] == [3, 4, 1, 2, 0]


# -- the 42 in-place variants ---------------------------------------------------


@pytest.mark.parametrize("name", list(ptt.INPLACE))
def test_inplace_variant_writes_into_x(name):
    jx, jout = call_inplace(pt, name, lambda a: pt.to_tensor(np.array(a)))
    tx, tout = call_inplace(ptt, name, _port_tensor)
    assert tout is tx
    _same(tx, jx, name)
    _same(tout, jout, name)


# -- random ops ------------------------------------------------------------------


@pytest.mark.parametrize("name", RANDOM)
def test_random_moments_seed_and_draw_count(name):
    fn, mean, var = draw(ptt, name)
    ptt.seed(5)
    before = trandom.draws()
    a = fn()
    assert trandom.draws() == before + 1, "a draw must count itself"
    ptt.seed(5)
    b = fn()
    assert torch.equal(a, b), "one seed must give one draw"
    assert a.device.type == "cpu"
    x = a.double()
    se_mean = np.sqrt(var / x.numel())
    assert abs(float(x.mean()) - mean) < SIGMAS * se_mean, \
        (name, float(x.mean()), mean)
    # the variance of a sample variance is below 3 var^2 / n for these
    # distributions (kurtosis < 3 + 1)
    se_var = np.sqrt(3 * var * var / x.numel())
    assert abs(float(x.var()) - var) < SIGMAS * se_var + 1e-9, \
        (name, float(x.var()), var)
    if name in ("randint", "randint_like", "randperm", "multinomial",
                "binomial"):
        assert a.dtype == torch.int32
    if name in ("randperm", "shuffle"):
        assert sorted(a.tolist()) == list(range(N))


@pytest.mark.parametrize("name,cdf", [
    ("uniform", stats.uniform(-2.0, 5.0).cdf),
    ("normal", stats.norm(1.5, 2.0).cdf)])
def test_uniform_and_normal_pass_ks(name, cdf):
    ptt.seed(9)
    x = draw(ptt, name)[0]().double().numpy()
    assert stats.kstest(x, cdf).pvalue > 1e-3


def test_random_dtypes_and_seed_alias():
    ptt.tensor.seed(3)
    a = ptt.randn([4], dtype="float16")
    ptt.seed(3)
    assert torch.equal(a, ptt.randn([4], dtype="float16"))
    assert a.dtype == torch.float16
    assert ptt.uniform([2], dtype="float64").dtype == torch.float32


def test_pca_lowrank_invariants():
    """Full rank: the singular values of the centred matrix, as the
    reference finds them, and ``U diag(S) V^T`` the centred matrix."""
    a = PCA
    ju, js, jv = pca(pt, pt.to_tensor(a))
    u, s, v = pca(ptt, _port_tensor(a))
    c = a - a.mean(0, keepdims=True)
    np.testing.assert_allclose(s.numpy(), np.linalg.svd(c)[1], atol=1e-5)
    np.testing.assert_allclose(s.numpy(), js.numpy(), atol=1e-5)
    np.testing.assert_allclose((u * s) @ v.T, c, atol=1e-5)
    assert u.dtype == torch.float32 and v.shape == (4, 4)


# -- placement and auto_cast -----------------------------------------------------


def test_placement():
    """Creation and random ops go to the current device, ``_like`` ops
    follow their input; with the card as the current device and no card
    present, creation raises instead of falling back to the CPU."""
    assert ptt.get_device() == "cpu"
    assert ptt.zeros([2]).device.type == "cpu"
    with using_device("gpu:0"):
        assert ptt.get_device() == "gpu:0"
        x = torch.ones(3)
        assert ptt.zeros_like(x).device.type == "cpu"
        assert ptt.tensor.rand_like(x).device.type == "cpu"
        assert ptt.exp(x).device.type == "cpu"
        if not torch.cuda.is_available():
            for make in (lambda: ptt.zeros([2]), lambda: ptt.arange(3),
                         lambda: ptt.rand([2]), lambda: ptt.eye(2),
                         lambda: ptt.tril_indices(3),
                         lambda: ptt.set_device("gpu")):
                with pytest.raises(RuntimeError, match="no CUDA device"):
                    make()
    assert ptt.get_device() == "cpu"


def test_white_and_black_ops_under_auto_cast():
    x = np.ones((2, 2), np.float32)
    with pt.amp.auto_cast(dtype="bfloat16"):
        jw = pt.matmul(pt.to_tensor(x), pt.to_tensor(x))
        je = pt.exp(pt.to_tensor(x).astype("bfloat16"))
    with tamp.auto_cast(dtype="bfloat16"):
        tw = ptt.matmul(_port_tensor(x), _port_tensor(x))
        te = ptt.exp(_port_tensor(x).to(torch.bfloat16))
    assert tw.dtype == torch.bfloat16 and jw.numpy().dtype.name == "bfloat16"
    assert te.dtype == torch.float32 and je.numpy().dtype.name == "float32"
    np.testing.assert_array_equal(tw.float().numpy(),
                                  jw.numpy().astype(np.float32))
