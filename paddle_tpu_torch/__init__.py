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
"""
from .framework.device import resolve_device  # noqa: F401
from .framework.dtype import to_torch_dtype  # noqa: F401

__all__ = ["resolve_device", "to_torch_dtype"]
