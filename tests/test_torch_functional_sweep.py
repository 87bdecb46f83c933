"""The port's ``nn.functional`` held against the reference's op specs.

One case per spec of ``tests/op_specs.py`` whose callable lies in
``paddle_tpu.nn.functional`` (80 specs over 67 functions): the same
numpy inputs go through the reference (its adapter and kwargs), the port
on the CPU and the spec's numpy function; the outputs must equal numpy's
and the reference's within the spec's ``rtol``/``atol`` and carry the
reference's dtype names. Each (spec, input) pair with a ``grad`` index
holds the port's ``torch.autograd`` gradient of ``sum(out *
cotangent)`` against the reference's ``backward()`` within 1e-4
relative and 1e-5 absolute. A completeness test computes the reference
namespace's exports and asserts that the port has each under the same
parameters, held by this sweep or by a row of
``test_torch_functional_ops.py`` (``covered()``).
"""
from __future__ import annotations

import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn.functional as TF
from op_specs import SPECS
from paddle_tpu_torch.framework.device import using_device
from torch_functional_cases import (
    covered, flat, functional_specs, port_grads, reference_grads,
)
from torch_tensor_cases import (
    _reaches_reference, port_adapted, resolve, spec_inputs,
)

JF = pt.nn.functional
SWEEP = functional_specs(SPECS)
SWEPT = {SPECS[n]["path"].split(".")[-1] for n in SWEEP}
GRAD_PAIRS = [(n, i) for n in SWEEP for i in SPECS[n]["grad"]]
# the grad tolerance of the pairs (tighter than the specs' finite
# differences, which bound them against numpy)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def _exports():
    """The reference namespace's public functions (not classes or
    modules): what ``paddle_tpu/nn/functional/__init__.py`` defines and
    re-exports."""
    return {n: getattr(JF, n) for n in dir(JF) if not n.startswith("_")
            and callable(getattr(JF, n))
            and not inspect.isclass(getattr(JF, n))}


REF_EXPORTS = _exports()


@pytest.fixture(autouse=True)
def _on_cpu():
    with using_device("cpu"):
        yield


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t.numpy())


def _dtype_name(t):
    if isinstance(t, torch.Tensor):
        return str(t.dtype).replace("torch.", "")
    return np.asarray(t.numpy()).dtype.name


def _calls(spec):
    ref_fn = resolve(pt, spec["path"])
    if spec["adapter"] is not None:
        ref_fn = spec["adapter"](ref_fn)
    return ref_fn, port_adapted(spec)


@pytest.mark.parametrize("name", SWEEP)
def test_spec_matches_reference_and_numpy(name):
    spec = SPECS[name]
    ref_fn, port_fn = _calls(spec)
    kwargs = dict(spec["kwargs"])
    inputs = list(spec["inputs"])
    refs = flat(ref_fn(*spec_inputs(pt.to_tensor, inputs), **kwargs))
    ports = flat(port_fn(*spec_inputs(
        lambda a: ptt.to_tensor(a, place="cpu"), inputs), **kwargs))
    exps = flat(spec["np_fn"](*inputs, **kwargs))
    assert len(ports) == len(refs), name
    for r, p, e in zip(refs, ports, exps):
        assert _dtype_name(p) == _dtype_name(r), (name, _dtype_name(p),
                                                  _dtype_name(r))
        o, r, e = _np(p), _np(r), np.asarray(e)
        assert o.shape == r.shape, (name, o.shape, r.shape)
        if np.issubdtype(e.dtype, np.floating):
            o, r = o.astype(np.float64), r.astype(np.float64)
        np.testing.assert_allclose(o, e, rtol=spec["rtol"],
                                   atol=spec["atol"], err_msg=name)
        np.testing.assert_allclose(o, r, rtol=spec["rtol"],
                                   atol=spec["atol"], err_msg=name)


@pytest.mark.parametrize("name,gi", GRAD_PAIRS,
                         ids=[f"{n}-{i}" for n, i in GRAD_PAIRS])
def test_spec_gradient_matches_reference(name, gi):
    spec = SPECS[name]
    ref_fn, port_fn = _calls(spec)
    kwargs = dict(spec["kwargs"])
    inputs = list(spec["inputs"])
    (want,) = reference_grads(pt, lambda *xs: ref_fn(*xs, **kwargs), inputs,
                              (gi,))
    (got,) = port_grads(lambda *xs: port_fn(*xs, **kwargs), inputs, (gi,))
    assert np.abs(want).max() > 0, f"{name}: the reference's gradient is 0"
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                               err_msg=f"{name} d/d input[{gi}]")


def test_port_adapters_stay_clear_of_the_reference():
    """No adapter of the functional specs imports the reference (so the
    card runs them all through ``port_adapted``)."""
    assert not [n for n in SWEEP if SPECS[n]["adapter"] is not None
                and _reaches_reference(SPECS[n]["adapter"])]


def _params(fn):
    return list(inspect.signature(fn).parameters)


def test_every_reference_export_has_a_counterpart():
    """Each public function of the reference's namespace is in the
    port's with the same parameters and defaults, and held by a test:
    this sweep, or a row or random draw of the functional tables."""
    missing, params, untested = [], [], []
    for name, ref in REF_EXPORTS.items():
        fn = getattr(TF, name, None)
        if fn is None or not callable(fn):
            missing.append(name)
            continue
        ref_sig = inspect.signature(ref).parameters.values()
        sig = inspect.signature(fn).parameters.values()
        if [(p.name, p.default) for p in sig] != \
                [(p.name, p.default) for p in ref_sig]:
            params.append((name, _params(fn), _params(ref)))
        if name not in SWEPT and name not in covered():
            untested.append(name)
    assert not missing, missing
    assert not params, params
    assert not untested, untested


def test_counts():
    """130 reference exports (``apply`` included), the 80 specs over 67
    functions, 69 of them with ``grad`` indices."""
    assert len(REF_EXPORTS) == 130
    assert len(SWEEP) == 80 and len(SWEPT) == 67
    assert sum(1 for n in SWEEP if SPECS[n]["grad"]) == 69
