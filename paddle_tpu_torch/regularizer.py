"""Weight-decay regularizers (counterpart of ``paddle_tpu/regularizer.py``).

The classes live with the optimizers (``optimizer/optimizer.py`` applies
them in the update); this module is the public namespace. Set one on a
parameter as ``param.regularizer = L1Decay(1e-4)`` (the reference's
``ParamAttr(regularizer=...)``), or pass it as an optimizer's
``weight_decay``.
"""
from .optimizer.optimizer import L1Decay, L2Decay  # noqa: F401

# the aliases the reference keeps from Paddle's fluid lineage
L1DecayRegularizer = L1Decay
L2DecayRegularizer = L2Decay

__all__ = ["L1Decay", "L2Decay"]
