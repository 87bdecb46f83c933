"""Carrying a reference vision model's weights and state across, by
name."""
from __future__ import annotations

import torch

from ...framework.io import to_tensor

__all__ = ["load_jax_weights"]


def load_jax_weights(model, arrays) -> None:
    """Fill a port vision model (``resnet50()``, ``LeNet()``, any
    ``Layer``) with the reference model's ``state_dict()``: ``arrays``
    maps each name to a numpy array (or tensor), as ``{n: np.asarray(
    t._data) for n, t in jax_model.state_dict().items()}`` gives them,
    parameters and buffers (BatchNorm's ``_mean`` and ``_variance``)
    alike. The port's names are the reference's, so each entry is
    copied by name, in place. Raises ``KeyError`` on a missing or
    unexpected name and ``ValueError`` on a shape or dtype mismatch,
    before anything is written."""
    own = model.state_dict(keep_vars=True)
    missing = sorted(set(own) - set(arrays))
    unexpected = sorted(set(arrays) - set(own))
    if missing or unexpected:
        raise KeyError(f"load_jax_weights: missing {missing}, "
                       f"unexpected {unexpected}")
    values = {}
    for name, target in own.items():
        a = arrays[name]
        v = a.detach() if isinstance(a, torch.Tensor) else to_tensor(a)
        if tuple(v.shape) != tuple(target.shape) or v.dtype != target.dtype:
            raise ValueError(
                f"load_jax_weights: {name} is {tuple(v.shape)} {v.dtype}, "
                f"the model holds {tuple(target.shape)} {target.dtype}")
        values[name] = v
    with torch.no_grad():
        for name, v in values.items():
            own[name].copy_(v)
