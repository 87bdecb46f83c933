"""The port's top level against the reference's: ``import
paddle_tpu_torch as paddle`` resolves every name ``import paddle_tpu as
paddle`` does.

The names are the reference's own: ``dir(paddle_tpu)``, ``_LAZY`` and
``_LAZY_ATTRS``, read in a fresh interpreter. The port is imported in
another (a name a test imported by its module path would resolve there
anyway), which
looks every name up and reports what it got. Each name resolves there,
or raises ``AttributeError`` naming the ROADMAP item that ``UNPORTED``
gives it; a name in ``UNPORTED`` that resolves is a stale entry and
fails, and so does a reference name in neither. The lookups touch no
card and import neither ``jax`` nor ``paddle_tpu``.
"""
import json
import os
import subprocess
import sys

import pytest

import paddle_tpu
from paddle_tpu.framework import dtype as jdtype

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference's names that the port does not have yet, by ROADMAP item
UNPORTED = {
    **dict.fromkeys(
        ("static", "inference", "text", "audio", "sparse", "distribution",
         "fft", "signal", "geometric", "onnx", "hub", "utils", "reader",
         "dataset", "sysconfig"), "A.8"),
    "profiler": "A.7",
    "cost_model": "A.7",
    "resilience": "A.6",
}


def _reference_names():
    """The reference's top-level names as a fresh interpreter sees them:
    in this process ``dir(paddle_tpu)`` also lists every submodule that
    another test imported."""
    code = ("import json\n"
            "import paddle_tpu as p\n"
            "print(json.dumps(sorted({n for n in dir(p) if n[0] != '_'}"
            " | set(p._LAZY) | set(p._LAZY_ATTRS))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT,
                                  JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


REFERENCE = _reference_names()

DTYPES = ("bool", "uint8", "int8", "int16", "int32", "int64", "float16",
          "bfloat16", "float32", "float64", "complex64", "complex128")

# the names a Paddle script meets first
FIRST = ("nn", "optimizer", "io", "vision", "jit", "metric", "distributed",
         "hapi", "models", "serving", "quantization", "regularizer",
         "incubate", "monitor", "ops", "autograd", "device", "callbacks",
         "ParamAttr", "Model", "DataParallel", "save", "load", "no_grad",
         "grad", "get_rng_state", "set_flags", "summary", "flops") + DTYPES

_PROBE = """
import json, sys
import torch
import paddle_tpu_torch as paddle
from paddle_tpu_torch.framework import dtype as tdtype
out = {}
for name in json.loads(sys.argv[1]):
    try:
        val = getattr(paddle, name)
        out[name] = ["ok", type(val).__name__]
    except AttributeError as e:
        out[name] = ["AttributeError", str(e)]
    except Exception as e:  # noqa: BLE001 - reported, and the test fails
        out[name] = [type(e).__name__, str(e)]
try:
    paddle.callbacks.VisualDL
    visualdl = "resolved"
except AttributeError as e:
    visualdl = str(e)
print(json.dumps({
    "names": out,
    "has_fft": hasattr(paddle, "fft"),
    "dtype_names": {n: tdtype.dtype_name(getattr(paddle, n))
                    for n in json.loads(sys.argv[2])},
    "float32_is_torch": paddle.float32 is torch.float32,
    "tensor_is_torch": paddle.Tensor is torch.Tensor,
    "visualdl": visualdl,
    "cuda_initialized": torch.cuda.is_initialized(),
    "imported": sorted(n for n in sys.modules
                       if n.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")),
}))
"""


@pytest.fixture(scope="module")
def port():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, json.dumps(REFERENCE),
         json.dumps(DTYPES)], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_names_are_the_known_set():
    # 462 names at the time of writing: a change in the reference shows here
    assert len(REFERENCE) == 462
    assert set(UNPORTED) <= set(REFERENCE)


@pytest.mark.parametrize("name", REFERENCE)
def test_reference_name_resolves_or_names_its_item(port, name):
    kind, what = port["names"][name]
    if name in UNPORTED:
        assert kind == "AttributeError", (
            f"{name} resolves now: take it out of UNPORTED (stale entry)")
        assert f"ROADMAP {UNPORTED[name]}" in what, what
    else:
        assert kind == "ok", f"{name}: {kind}: {what}"


def test_first_names_of_a_paddle_script_resolve(port):
    assert all(port["names"][n][0] == "ok" for n in FIRST)
    assert port["names"]["nn"][1] == "module"
    assert port["names"]["device"][1] == "module"


def test_unported_raise_attribute_error_so_hasattr_is_false(port):
    assert port["has_fft"] is False
    assert "ROADMAP A.7" in port["visualdl"]


def test_dtype_names_equal_the_reference_by_name(port):
    assert port["dtype_names"] == {n: jdtype.dtype_name(getattr(paddle_tpu,
                                                                n))
                                   for n in DTYPES}
    assert port["float32_is_torch"] and port["tensor_is_torch"]


def test_lookups_touch_no_card_and_no_reference(port):
    assert port["cuda_initialized"] is False
    assert port["imported"] == []
