"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu``.

The port trains the Llama causal LM (``jit.TrainStep`` on CUDA graphs
with ``optimizer.AdamW``, or ``hapi.Model.fit`` over ``io.DataLoader``;
``amp.auto_cast`` in bfloat16 or float16 with ``amp.GradScaler``) and
serves it through the continuous-batching engine on one NVIDIA Hopper
card; it trains the BERT and ERNIE 3.0 encoders, with the reference's LR
schedulers and update rules (``optimizer.lr``, ``optimizer.Lamb``,
``optimizer.LBFGS``, ...), and the vision models (``vision.resnet50``
over ``nn.Conv2D``, ``nn.BatchNorm2D`` and the pools; ``vision.LeNet``).
Module names follow the JAX package (``models/llama.py``,
``jit/train_step.py``, ``serving/engine.py``, ...) so every module has
an obvious counterpart; the Pallas kernels on those
paths become hand-written CUDA C++ under ``ops/cuda/``.

    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.serving import ServingEngine

    model = LlamaForCausalLM(LlamaConfig.tiny())          # on "cuda"
    step = TrainStep(model, AdamW(parameters=model.parameters()))
    loss = step(input_ids, labels)
    engine = ServingEngine(model)
    engine.submit([1, 2, 3], max_new_tokens=8)
    outputs = engine.run()

Public entry points take ``device`` (default ``"cuda"``) and raise when
no GPU is present unless the caller passes ``device="cpu"``. This package
imports ``torch`` and never ``jax`` or ``paddle_tpu``.

A Paddle script imports it as ``paddle`` (``import paddle_tpu_torch as
paddle``): every name of the reference's top level
(``paddle_tpu/__init__.py``) resolves here, the subpackages on first
access through ``_LAZY`` and ``_LAZY_ATTRS`` as in the reference, or
raises ``AttributeError`` naming the ROADMAP item that will port it
(``_UNPORTED``). The dtype names are torch dtypes (``paddle.float32 is
torch.float32``) and ``paddle.Tensor`` is ``torch.Tensor``. Importing the
package touches no card and builds no kernel.

The tensor ops sit at the top level as in the reference
(``paddle_tpu/__init__.py:33-100``): ``paddle_tpu_torch.concat``,
``.where``, ``.topk``, ``.arange``, ``.linalg.norm``, the in-place
variants (``add_``, ``exp_``, ...: the result written into ``x``'s
storage, ``x`` returned) and the random aliases. An op with no tensor
input places its output on the device of :func:`set_device` (the card
until ``set_device("cpu")``).
"""
from __future__ import annotations

import importlib as _importlib

import torch as _torch

from .framework.dtype import (  # noqa: F401
    bool, uint8, int8, int16, int32, int64, float16, bfloat16, float32,
    float64, complex64, complex128, set_default_dtype, get_default_dtype,
    to_torch_dtype,
)
from .framework import dtype as dtype  # noqa: F401
from .framework.device import (  # noqa: F401
    device_count, get_device, is_compiled_with_tpu, resolve_device,
    set_device,
)
from .framework.random import (  # noqa: F401
    get_cuda_rng_state, get_rng_state, seed, set_cuda_rng_state,
    set_rng_state,
)
from .autograd.tape import (  # noqa: F401
    enable_grad, grad, is_grad_enabled, no_grad, set_grad_enabled,
    set_grad_enabled_ctx,
)
from . import autograd  # noqa: F401
from . import tensor  # noqa: F401
from .tensor import linalg  # noqa: F401

# every tensor op at the top level: paddle_tpu_torch.add, .matmul, ...
for _name in dir(tensor):
    _fn = getattr(tensor, _name)
    if not _name.startswith("_") and callable(_fn) and getattr(
            _fn, "__module__", "").startswith("paddle_tpu_torch.tensor"):
        globals().setdefault(_name, _fn)


def _make_inplace(base):
    def g(x, *args, **kwargs):
        return x.copy_(base(x, *args, **kwargs))

    g.__name__ = g.__qualname__ = base.__name__ + "_"
    g.__doc__ = (f"In-place :func:`{base.__name__}`: the result written "
                 f"into ``x``'s storage (cast to its dtype); returns ``x``.")
    return g


INPLACE = (
    "abs", "acos", "addmm", "atan", "cos", "digamma", "erf", "expm1",
    "frac", "i0", "index_add", "index_put", "lgamma", "log", "log10",
    "log2", "logit", "neg", "polygamma", "pow", "sin", "sinh", "square",
    "tan", "tanh", "tril", "triu", "trunc", "add", "subtract", "multiply",
    "divide", "clip", "scale", "exp", "sqrt", "rsqrt", "ceil", "floor",
    "round", "reciprocal", "sigmoid",
)
for _name in INPLACE:
    globals().setdefault(_name + "_", _make_inplace(getattr(tensor, _name)))

rand = tensor.random.rand
randn = tensor.random.randn
randint = tensor.random.randint
randperm = tensor.random.randperm
uniform = tensor.random.uniform
normal = tensor.random.normal
bernoulli = tensor.random.bernoulli
multinomial = tensor.random.multinomial
is_tensor = tensor.logic.is_tensor

# places, the static-mode flag, dtype and tensor introspection (after the
# tensor ops, as in the reference, so these names win)
from .framework.compat import (  # noqa: F401,E402
    CPUPlace, CUDAPlace, CUDAPinnedPlace, TPUPlace, LazyGuard,
    enable_static, disable_static, in_dynamic_mode, in_static_mode,
    set_printoptions, finfo, iinfo, shape, rank, tolist,
    is_floating_point, is_integer, is_complex, create_parameter,
    check_shape, disable_signal_handler,
)

Tensor = _torch.Tensor

# the subpackages, imported on first access (paddle_tpu/__init__.py:89-147)
_LAZY = {
    "nn": ".nn",
    "optimizer": ".optimizer",
    "io": ".io",
    "amp": ".amp",
    "jit": ".jit",
    "metric": ".metric",
    "distributed": ".distributed",
    "vision": ".vision",
    "hapi": ".hapi",
    "linalg": ".tensor.linalg",
    "incubate": ".incubate",
    "models": ".models",
    "device": ".framework.device",
    "framework": ".framework",
    "quantization": ".quantization",
    "callbacks": ".callbacks",
    "regularizer": ".regularizer",
    "monitor": ".monitor",
    "serving": ".serving",
    "ops": ".ops",
}

_LAZY_ATTRS = {
    "Model": (".hapi.model", "Model"),
    "DataParallel": (".distributed.parallel", "DataParallel"),
    "batch": (".batch", "batch"),
    "ParamAttr": (".nn.layer.layers", "ParamAttr"),
    "Parameter": (".nn.layer.layers", "ParamBase"),
    "EagerParamBase": (".nn.layer.layers", "ParamBase"),
}

# the reference's names with nothing behind them yet, by ROADMAP item
_UNPORTED = {
    **dict.fromkeys(
        ("static", "inference", "text", "audio", "sparse", "distribution",
         "fft", "signal", "geometric", "onnx", "hub", "utils", "reader",
         "dataset", "sysconfig"), "A.8"),
    "profiler": "A.7",
    "cost_model": "A.7",
    "resilience": "A.6",
}


def __getattr__(name):
    if name in _LAZY:
        mod = _importlib.import_module(_LAZY[name], __name__)
        globals()[name] = mod
        return mod
    if name in _LAZY_ATTRS:
        modname, attr = _LAZY_ATTRS[name]
        val = getattr(_importlib.import_module(modname, __name__), attr)
        globals()[name] = val
        return val
    if name in _UNPORTED:
        raise AttributeError(
            f"paddle_tpu_torch.{name} is not ported yet (ROADMAP "
            f"{_UNPORTED[name]})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def save(obj, path, protocol=4, **kwargs):
    """``paddle.save``: ``obj`` to ``path`` in the reference's format."""
    from .framework.io import save as _save

    return _save(obj, path, protocol=protocol, **kwargs)


def load(path, **kwargs):
    """``paddle.load``: what :func:`save` wrote (or the reference)."""
    from .framework.io import load as _load

    return _load(path, **kwargs)


def summary(net, input_size=None, dtypes=None, input=None):  # noqa: A002
    from .hapi.summary import summary as _summary

    return _summary(net, input_size, dtypes=dtypes, input=input)


def flops(net, input_size, custom_ops=None, print_detail=False):
    from .hapi.summary import flops as _flops

    return _flops(net, input_size, custom_ops=custom_ops,
                  print_detail=print_detail)


def set_flags(flags):
    from .framework.flags import set_flags as _set

    return _set(flags)


def get_flags(flags=None):
    from .framework.flags import get_flags as _get

    return _get(flags)


__all__ = ["resolve_device", "to_torch_dtype", "set_device", "get_device",
           "seed", "tensor", "linalg"]
