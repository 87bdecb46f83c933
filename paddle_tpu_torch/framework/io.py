"""Checkpoint I/O: ``save`` / ``load`` of nested state dicts.

Counterpart of ``paddle_tpu/framework/io.py``, in its format: a pickle
of the nested object with every tensor replaced by a payload holding its
value as a numpy array and its shell's fields (``name``,
``stop_gradient``, ``persistable``, ``is_parameter``). The payload is
pickled under the reference's class name
(``paddle_tpu.framework.io._TensorPayload``), so a file written by
either package loads in the other; loading maps that name to this
module's class, so the port never imports the reference to read one.

bfloat16 has no numpy dtype of its own: its 2-byte view is written with
``ml_dtypes.bfloat16`` as the array's dtype where ``ml_dtypes`` is
installed (the reference's own form), else as ``uint16``; both load
back as ``torch.bfloat16`` values bit for bit.
"""
from __future__ import annotations

import io as _io
import os
import pickle

import numpy as np
import torch

__all__ = ["save", "load", "save_to_bytes", "load_from_bytes"]

_REF_MODULE = "paddle_tpu.framework.io"


class _TensorPayload:
    """Pickle surrogate for a tensor: its numpy value and the fields of
    the reference's tensor shell."""

    def __init__(self, t: torch.Tensor):
        self.value = to_numpy(t)
        self.name = getattr(t, "name", None)
        self.stop_gradient = not t.requires_grad
        self.is_parameter = isinstance(t, torch.nn.Parameter)
        self.persistable = self.is_parameter


def _bf16_dtype():
    try:
        import ml_dtypes
    except ImportError:
        return None
    return np.dtype(ml_dtypes.bfloat16)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU copy of ``t`` as numpy; bfloat16 as its 2-byte view (see
    the module note)."""
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        raw = t.contiguous().view(torch.int16).numpy().view(np.uint16)
        bf16 = _bf16_dtype()
        return raw.copy() if bf16 is None else raw.view(bf16).copy()
    return t.numpy().copy()


def to_tensor(a) -> torch.Tensor:
    """A numpy array as a CPU tensor with the same bits (``ml_dtypes``
    bfloat16 as ``torch.bfloat16``)."""
    a = np.array(a)  # writable: from_numpy shares memory
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _pack(obj):
    if isinstance(obj, torch.Tensor):
        return _TensorPayload(obj)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        packed = [_pack(v) for v in obj]
        return packed if isinstance(obj, list) else tuple(packed)
    return obj


def _unpack(obj, return_numpy=False):
    if isinstance(obj, _TensorPayload):
        if return_numpy:
            return obj.value
        t = to_tensor(obj.value)
        if obj.is_parameter:
            return torch.nn.Parameter(
                t, requires_grad=not obj.stop_gradient
                and t.is_floating_point())
        return t
    if isinstance(obj, dict):
        return {k: _unpack(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unpack(v, return_numpy) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_unpack(v, return_numpy) for v in obj)
    return obj


class _Pickler(pickle._Pickler):
    """Writes the payload class under the reference's name."""

    def save_global(self, obj, name=None):
        if obj is not _TensorPayload:
            return super().save_global(obj, name)
        if self.proto >= 4:
            self.save(_REF_MODULE)
            self.save("_TensorPayload")
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL
                       + f"{_REF_MODULE}\n_TensorPayload\n".encode())
        self.memoize(obj)


class _Unpickler(pickle.Unpickler):
    """Reads the reference's payload class as this module's."""

    def find_class(self, module, name):
        if (module, name) == (_REF_MODULE, "_TensorPayload"):
            return _TensorPayload
        return super().find_class(module, name)


def save(obj, path, protocol=4, **configs):
    """Save a nested object (state dicts, tensors, Python values) to
    ``path`` (a file name, its directories made, or a writable file)."""
    if isinstance(path, (str, os.PathLike)):
        path = os.fspath(path)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "wb") as f:
            _Pickler(f, protocol=protocol).dump(_pack(obj))
    elif hasattr(path, "write"):
        _Pickler(path, protocol=protocol).dump(_pack(obj))
    else:
        raise TypeError(f"unsupported path type {type(path)}")


def load(path, return_numpy=False, **configs):
    """Load an object saved by :func:`save` (or by the reference's):
    CPU tensors (``nn.Parameter`` for a parameter), or numpy arrays with
    ``return_numpy``."""
    if isinstance(path, (str, os.PathLike)):
        with open(os.fspath(path), "rb") as f:
            raw = _Unpickler(f).load()
    elif hasattr(path, "read"):
        raw = _Unpickler(path).load()
    else:
        raise TypeError(f"unsupported path type {type(path)}")
    return _unpack(raw, return_numpy=return_numpy)


def save_to_bytes(obj, protocol=4) -> bytes:
    buf = _io.BytesIO()
    save(obj, buf, protocol=protocol)
    return buf.getvalue()


def load_from_bytes(data: bytes, return_numpy=False):
    return load(_io.BytesIO(data), return_numpy=return_numpy)
