"""paddle_tpu_torch.incubate: the incubating APIs the port runs
(counterpart of ``paddle_tpu/incubate``): the expert-parallel
``MoELayer`` under ``distributed.models.moe`` and ``incubate.autograd``
(``autograd.py``)."""
from . import autograd, distributed  # noqa: F401

__all__ = ["autograd", "distributed"]
