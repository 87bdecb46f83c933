"""Loading the reference model's weights into a port model by name."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_jax_weights"]


def _to_tensor(arr) -> torch.Tensor:
    """A numpy array (bfloat16 from ``ml_dtypes`` included) as a CPU
    tensor with the same bits."""
    arr = np.array(arr)  # a writable copy: from_numpy shares memory
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def load_jax_weights(model, arrays) -> None:
    """Fill a port model (``LlamaForCausalLM``, ``BertForMaskedLM``, ...)
    with the reference model's weights, so the two packages compute the
    same function.

    ``arrays`` maps parameter names to numpy arrays, as
    ``{n: np.asarray(p._data) for n, p in jax_model.named_parameters()}``
    gives them; the port's parameters carry the same names and Paddle's
    ``[in, out]`` linear layout. A model may accept alias prefixes of its
    names (``_jax_aliases``, pairs ``(alias, name)``: the Llama's
    ``model.*`` is ``llama.*``). Each array is converted to its
    parameter's dtype and device. Raises ``KeyError`` on a missing or
    unexpected name and ``ValueError`` on a shape mismatch, before any
    parameter is written."""
    params = dict(model.named_parameters())
    given = {}
    for name, arr in arrays.items():
        key = name
        for alias, real in getattr(model, "_jax_aliases", ()):
            if name.startswith(alias):
                key = real + name[len(alias):]
        if key in given and not np.array_equal(given[key], arr):
            raise ValueError(f"{name!r} and its alias disagree")
        given[key] = arr
    missing = sorted(set(params) - set(given))
    unexpected = sorted(set(given) - set(params))
    if missing or unexpected:
        raise KeyError(f"load_jax_weights: missing {missing}, "
                       f"unexpected {unexpected}")
    for name, p in params.items():
        if tuple(np.shape(given[name])) != tuple(p.shape):
            raise ValueError(
                f"load_jax_weights: {name} has shape "
                f"{tuple(np.shape(given[name]))}, the model expects "
                f"{tuple(p.shape)}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(_to_tensor(given[name]).to(p.dtype))
