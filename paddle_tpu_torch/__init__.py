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

The tensor ops sit at the top level as in the reference
(``paddle_tpu/__init__.py:33-100``): ``paddle_tpu_torch.concat``,
``.where``, ``.topk``, ``.arange``, ``.linalg.norm``, the in-place
variants (``add_``, ``exp_``, ...: the result written into ``x``'s
storage, ``x`` returned) and the random aliases. An op with no tensor
input places its output on the device of :func:`set_device` (the card
until ``set_device("cpu")``).
"""
from .framework.device import (  # noqa: F401
    get_device, resolve_device, set_device,
)
from .framework.dtype import to_torch_dtype  # noqa: F401
from .framework.random import seed  # noqa: F401
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

__all__ = ["resolve_device", "to_torch_dtype", "set_device", "get_device",
           "seed", "tensor", "linalg"]
