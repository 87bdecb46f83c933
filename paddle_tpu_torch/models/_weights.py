"""Moving weights between the reference's global arrays and a port
model, by name."""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..distributed import _comm
from ..distributed.fleet.meta_parallel.parallel_layers.pp_layers import (
    PipelineLayer,
)
from ..distributed.shard import gather_global, local_piece
from ..framework.io import to_tensor

__all__ = ["load_jax_weights", "gather_jax_layout"]


def _to_tensor(arr) -> torch.Tensor:
    """A numpy array (bfloat16 from ``ml_dtypes`` included) as a CPU
    tensor with the same bits; a tensor as it is."""
    if isinstance(arr, torch.Tensor):
        return arr.detach()
    return to_tensor(arr)


def load_jax_weights(model, arrays) -> None:
    """Fill a port model (``LlamaForCausalLM``, ``BertForMaskedLM``, ...)
    with the reference model's weights, so the two packages compute the
    same function.

    ``arrays`` maps parameter names to numpy arrays (or tensors), as
    ``{n: np.asarray(p._data) for n, p in jax_model.named_parameters()}``
    gives them; the port's parameters carry the same names and Paddle's
    ``[in, out]`` linear layout. A model may accept alias prefixes of its
    names (``_jax_aliases``, pairs ``(alias, name)``: the Llama's
    ``model.*`` is ``llama.*``). Each array is converted to its
    parameter's dtype and device. Raises ``KeyError`` on a missing or
    unexpected name and ``ValueError`` on a shape mismatch, before any
    parameter is written.

    A pipeline model (``LlamaForCausalLMPipe``,
    ``ErnieForPretrainingPipe``) takes the reference ``PipelineLayer``'s
    canonical ``state_dict`` (``"<index>.<param>"``): every rank passes
    the whole of it and keeps its own stage's layers.

    A tensor-parallel parameter (one that records a ``_dist_layout``,
    under mp > 1, or ZeRO ``p_g_os``'s slice of it) takes this rank's
    piece of the global array, cut by each of its layout's cuts: every
    rank passes the same global arrays. The fused ``qkv_proj`` and
    ``gate_up_proj`` weights (and ERNIE's fused ``qkv`` weight and its
    1-D bias) are cut segment by segment, so a rank holds its own q, k
    and v heads (or its gate and up columns) side by side:
    its piece is *not* the contiguous chunk of the fused dim that GSPMD
    gives a device in the reference (``distributed.shard``).
    :func:`gather_jax_layout` is the inverse."""
    pipe = isinstance(model, PipelineLayer)
    params = dict(model.named_parameters(remove_duplicate=not pipe))
    given = {}
    for name, arr in arrays.items():
        key = name
        for alias, real in getattr(model, "_jax_aliases", ()):
            if name.startswith(alias):
                key = real + name[len(alias):]
        if key in given and not np.array_equal(given[key], arr):
            raise ValueError(f"{name!r} and its alias disagree")
        if pipe and model.held_elsewhere(key):
            continue  # another stage's layer
        given[key] = arr
    if pipe:  # a shared layer's copy may come under another occurrence
        for name in set(params) - set(given):
            for alt in model.tied_keys(name):
                if alt in arrays:
                    given[name] = arrays[alt]
                    break
    missing = sorted(set(params) - set(given))
    unexpected = sorted(set(given) - set(params))
    if missing or unexpected:
        raise KeyError(f"load_jax_weights: missing {missing}, "
                       f"unexpected {unexpected}")
    for name, p in params.items():
        want = _global_shape(p)
        if tuple(np.shape(given[name])) != want:
            raise ValueError(
                f"load_jax_weights: {name} has shape "
                f"{tuple(np.shape(given[name]))}, the model expects "
                f"{want}")
    with torch.no_grad():
        for name, p in params.items():
            full = _to_tensor(given[name])
            layout = getattr(p, "_dist_layout", None)
            if layout is not None:
                full = local_piece(full, layout)
            p.copy_(full.to(p.dtype))


def _global_shape(p):
    layout = getattr(p, "_dist_layout", None)
    return tuple(p.shape) if layout is None else tuple(layout.shape)


def gather_jax_layout(model, grads=False) -> dict:
    """The model's parameters (or, with ``grads``, their gradients; a
    parameter without one is left out) as the reference's global numpy
    arrays by name, on every rank: a tensor-parallel parameter's pieces
    are all-gathered over its axis and laid out as
    :func:`load_jax_weights` cut them, and a pipeline model's stages put
    together under their canonical keys. Collective under mp > 1 or
    pp > 1: every rank must call it."""
    out = {}
    pipe = isinstance(model, PipelineLayer)
    for name, p in model.named_parameters(remove_duplicate=not pipe):
        t = p.grad if grads else p
        if t is None:
            continue
        layout = getattr(p, "_dist_layout", None)
        if layout is not None:
            t = gather_global(t.detach(), layout)
        t = t.detach().to("cpu", copy=True)  # not a view of the model
        out[name] = (t.to(torch.float32) if t.dtype == torch.bfloat16
                     else t).numpy()
    group = model.pp_group() if pipe else None
    if group is not None:
        stages = [None] * len(group[0])
        _comm.run(dist.all_gather_object, None, group, stages, out)
        out = {k: v for stage in stages for k, v in stage.items()}
    return out
