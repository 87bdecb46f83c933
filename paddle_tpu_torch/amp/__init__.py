"""Mixed precision: ``decorate`` (counterpart of
``paddle_tpu/amp/auto_cast.py::decorate``).

O2 stores every parameter in bf16 and keeps an fp32 master in each
optimizer (``multi_precision``). O1 (``auto_cast``, per-op casting),
float16 (the attention kernels take fp32 and bf16 only) and
``GradScaler`` are not ported (ROADMAP queue A): they raise.
"""
from __future__ import annotations

import torch

from ..framework.dtype import to_torch_dtype

__all__ = ["decorate"]


def decorate(models, optimizers=None, level="O2", dtype="bfloat16"):
    """Cast the models' parameters for AMP and enable the optimizers'
    fp32 masters, as the reference does (``auto_cast.py:136-166``).

    ``level="O2"`` casts **every** fp32 parameter to bf16 in place
    (LayerNorm scales and biases included; there are no buffers to
    spare), and each optimizer is forced to ``multi_precision``. Returns
    the model (or list) and, when given, the optimizer (or list), as the
    reference returns them. ``level="O1"`` and ``dtype="float16"`` raise
    ``NotImplementedError``."""
    if level.upper() not in ("O1", "O2"):
        raise ValueError("decorate level must be O1 or O2")
    if level.upper() == "O1":
        raise NotImplementedError(
            "amp O1 (auto_cast) is not ported (ROADMAP queue A)")
    if to_torch_dtype(dtype) != torch.bfloat16:
        raise NotImplementedError(
            f"amp takes bfloat16 only, got {dtype!r}: float16 is not ported "
            f"(ROADMAP queue A)")
    single_model = isinstance(models, torch.nn.Module)
    model_list = [models] if single_model else list(models)
    with torch.no_grad():
        for m in model_list:
            for p in m.parameters():
                if p.dtype == torch.float32:
                    p.data = p.data.to(torch.bfloat16)
    out_models = model_list[0] if single_model else model_list
    if optimizers is None:
        return out_models
    single_opt = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if single_opt else list(optimizers)
    for opt in opt_list:
        opt._multi_precision = True
    return out_models, (opt_list[0] if single_opt else opt_list)
