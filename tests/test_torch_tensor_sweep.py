"""The port's tensor ops held against the reference's op specs.

One case per spec of ``tests/op_specs.py`` whose callable lies in the
tensor namespace (``paddle_tpu.<name>`` for an export of the reference's
nine ``paddle_tpu/tensor/`` modules, ``paddle_tpu.linalg.*`` and
``paddle_tpu.tensor.*``): the same numpy inputs go through the
reference (its adapter and kwargs), the port on the CPU and the spec's
numpy function. The port's outputs must equal numpy's and the
reference's within the spec's ``rtol``/``atol`` and carry the
reference's dtype names. Each (spec, input) pair with a ``grad`` index
holds the port's ``torch.autograd`` gradient of ``sum(out *
cotangent)`` against the reference's ``backward()`` (1e-3 relative,
1e-4 absolute). A further test computes every function that the
reference's nine modules export and asserts that the port has it, under
the same parameter names, in its module and at the top level, and that
this file or ``test_torch_tensor_ops.py`` holds it.
"""
from __future__ import annotations

import importlib
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from op_specs import SPECS
from paddle_tpu_torch.framework.device import using_device
from torch_functional_cases import port_grads, reference_grads
from torch_tensor_cases import (
    PORT_ADAPTERS, TENSOR_MODULES as MODULES, _reaches_reference, covered,
    port_adapted, resolve, spec_inputs, tensor_specs,
)

def _exports(mod):
    """The public callables a reference module defines or re-exports
    from the tensor package (the modules' own exports)."""
    return {n: getattr(mod, n) for n in dir(mod)
            if not n.startswith("_") and callable(getattr(mod, n))
            and getattr(getattr(mod, n), "__module__", "").startswith(
                "paddle_tpu.tensor")}


REF_EXPORTS = {m: _exports(importlib.import_module(f"paddle_tpu.tensor.{m}"))
               for m in MODULES}
TENSOR_NAMES = set().union(*REF_EXPORTS.values())


SWEEP = tensor_specs(SPECS, TENSOR_NAMES)
SWEPT = {SPECS[n]["path"].split(".")[-1] for n in SWEEP}
GRAD_PAIRS = [(n, i) for n in SWEEP for i in SPECS[n]["grad"]]


@pytest.fixture(autouse=True)
def _on_cpu():
    with using_device("cpu"):
        yield


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t.numpy())


def _dtype_name(t):
    if isinstance(t, torch.Tensor):
        return str(t.dtype).replace("torch.", "")
    return np.asarray(t.numpy()).dtype.name


@pytest.mark.parametrize("name", SWEEP)
def test_op_matches_reference_and_numpy(name):
    spec = SPECS[name]
    ref_fn = resolve(pt, spec["path"])
    if spec["adapter"] is not None:
        ref_fn = spec["adapter"](ref_fn)
    port_fn = port_adapted(spec)
    kwargs = dict(spec["kwargs"])
    sort_complex = kwargs.pop("_sort_complex", False)
    inputs = list(spec["inputs"])
    refs = _flat(ref_fn(*spec_inputs(pt.to_tensor, inputs), **kwargs))
    ports = _flat(port_fn(*spec_inputs(
        lambda a: ptt.to_tensor(a, place="cpu"), inputs), **kwargs))
    exps = _flat(spec["np_fn"](*inputs, **kwargs))
    assert len(ports) == len(refs), name
    for r, p in zip(refs, ports):
        assert _dtype_name(p) == _dtype_name(r), (name, _dtype_name(p),
                                                  _dtype_name(r))
    ref_np = [_np(r) for r in refs]
    port_np = [_np(p) for p in ports]
    if sort_complex:
        ref_np = [np.sort_complex(a) for a in ref_np]
        port_np = [np.sort_complex(a) for a in port_np]
    if not np.isfinite(spec["rtol"]):  # a shape-only contract (empty)
        assert port_np[0].shape == np.asarray(exps[0]).shape
        return
    for o, r, e in zip(port_np, ref_np, exps):
        e = np.asarray(e)
        assert o.shape == r.shape, (name, o.shape, r.shape)
        if np.issubdtype(e.dtype, np.floating):
            o, r = o.astype(np.float64), r.astype(np.float64)
        np.testing.assert_allclose(o, e, rtol=spec["rtol"],
                                   atol=spec["atol"], err_msg=name)
        np.testing.assert_allclose(o, r, rtol=spec["rtol"],
                                   atol=spec["atol"], err_msg=name)


@pytest.mark.parametrize("name,gi", GRAD_PAIRS,
                         ids=[f"{n}-{i}" for n, i in GRAD_PAIRS])
def test_op_gradient_matches_reference(name, gi):
    spec = SPECS[name]
    ref_fn = resolve(pt, spec["path"])
    if spec["adapter"] is not None:
        ref_fn = spec["adapter"](ref_fn)
    port_fn = port_adapted(spec)
    kwargs = dict(spec["kwargs"])
    kwargs.pop("_sort_complex", None)
    inputs = list(spec["inputs"])
    (want,) = reference_grads(pt, lambda *xs: ref_fn(*xs, **kwargs), inputs,
                              (gi,))
    (got,) = port_grads(lambda *xs: port_fn(*xs, **kwargs), inputs, (gi,))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4,
                               err_msg=f"{name} d/d input[{gi}]")


def test_port_adapters_stay_clear_of_the_reference():
    """Each adapter of the sweep that imports the reference has a twin for
    the port; an adapter that reaches it with no twin is refused."""
    reaching = {SPECS[n]["adapter"].__name__ for n in SWEEP
                if SPECS[n]["adapter"] is not None
                and _reaches_reference(SPECS[n]["adapter"])}
    assert reaching == {"_lu_recon", "_svd_recon"}
    assert reaching <= set(PORT_ADAPTERS)

    def _recon(f):
        def run(x):
            import paddle_tpu as p
            return p.abs(f(x))
        return run
    with pytest.raises(LookupError, match="no twin"):
        port_adapted({"path": "paddle_tpu.abs", "adapter": _recon})


def _params(fn):
    return list(inspect.signature(fn).parameters)


@pytest.mark.parametrize("module", MODULES)
def test_every_reference_export_has_a_counterpart(module):
    """Each function of the reference module is in the port's module of
    the same name with the same parameters, at the top level, and held
    by a test: this sweep, or a row of ``test_torch_tensor_ops.py`` that
    calls it (``covered()``)."""
    port = importlib.import_module(f"paddle_tpu_torch.tensor.{module}")
    missing, params, untested = [], [], []
    for name, ref in REF_EXPORTS[module].items():
        fn = getattr(port, name, None)
        if fn is None or not callable(fn) or not callable(
                getattr(ptt, name, None)):
            missing.append(name)
            continue
        if _params(fn) != _params(ref):
            params.append((name, _params(fn), _params(ref)))
        if name not in SWEPT and name not in covered():
            untested.append(name)
    assert not missing, missing
    assert not params, params
    assert not untested, untested


def test_counts_inplace_variants_and_linalg():
    """315 functions in all, the 42 in-place variants, the random
    aliases and ``linalg`` at the top level."""
    assert len(TENSOR_NAMES) == 315
    assert len(ptt.INPLACE) == 42
    for name in ptt.INPLACE:
        assert getattr(ptt, name + "_").__name__ == name + "_"
        assert callable(getattr(pt, name + "_"))
    for name in ("rand", "randn", "randint", "randperm", "uniform",
                 "normal", "bernoulli", "multinomial", "is_tensor"):
        assert getattr(ptt, name) is getattr(ptt.tensor, name)
    assert ptt.linalg is ptt.tensor.linalg
    for name in REF_EXPORTS["linalg"]:
        assert callable(getattr(ptt.linalg, name)), name
    assert ptt.cov is ptt.tensor.stat.cov
    assert ptt.linalg.cov is ptt.tensor.linalg.cov
