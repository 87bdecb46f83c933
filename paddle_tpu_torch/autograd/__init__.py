"""``paddle.autograd`` over torch's autograd (counterpart of
``paddle_tpu/autograd``): the grad switches and ``grad`` (``tape.py``),
``PyLayer`` (``py_layer.py``), the functional derivatives
(``functional.py``), ``backward`` over several roots and
``saved_tensors_hooks``."""
import torch

from .tape import (  # noqa: F401
    enable_grad, grad, is_grad_enabled, no_grad, run_backward,
    set_grad_enabled, set_grad_enabled_ctx,
)
from .py_layer import PyLayer, PyLayerContext, once_differentiable  # noqa: F401
from . import functional  # noqa: F401
from .functional import Jacobian, hessian, jacobian, jvp, vhp, vjp  # noqa: F401

__all__ = ["no_grad", "enable_grad", "is_grad_enabled", "set_grad_enabled",
           "grad", "backward", "PyLayer", "PyLayerContext",
           "once_differentiable", "saved_tensors_hooks", "vjp", "jvp",
           "Jacobian", "jacobian", "hessian", "vhp"]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """Backward from several roots in one sweep (roots that share
    intermediates consume the graph once), adding into ``.grad``."""
    run_backward(tensors, grad_tensors, retain_graph)


class saved_tensors_hooks(torch.autograd.graph.saved_tensors_hooks):  # noqa: N801
    """Inside the block every tensor the graph saves for the backward
    goes through ``pack_hook`` when saved and ``unpack_hook`` when the
    backward reads it (to offload or compress it)."""
