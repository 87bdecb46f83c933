"""Runtime flag registry: ``paddle.set_flags`` / ``paddle.get_flags``.

Counterpart of ``paddle_tpu/framework/flags.py``, with its eleven flags.
A flag is set from the ``FLAGS_<name>`` environment variable when it is
defined (at import) or by :func:`set_flags` at run time; observers
registered with :func:`observe_flag` fire on every change.

Only ``check_nan_inf`` and ``check_nan_inf_level`` act, as in the
reference (``flags.py:112-147``): while ``check_nan_inf`` is on, the
first op whose output holds a nan or an inf raises
``FloatingPointError`` naming the op (level 1: warns instead). The
reference hooks its op dispatch; the port's ops are torch's, reached
through the port's functions and through a tensor's operators
(``x / y``), so the check is a ``torch.overrides.TorchFunctionMode``
pushed while the flag is on: it sees every torch function and tensor
method. It reads each floating output on the host (one synchronisation
an op on the card), and skips while a CUDA stream captures, as the
reference skips tracers, so a ``jit.TrainStep`` still captures its
graph with the flag on. The mode is pushed on the thread that turns the
flag on. The other flags are stored and read, and act on nothing, as in
the reference.
"""
from __future__ import annotations

import os
import threading
import warnings

import torch
from torch.overrides import TorchFunctionMode

__all__ = ["define_flag", "observe_flag", "get_flags", "set_flags",
           "flag_value"]

_lock = threading.Lock()
_registry: dict[str, dict] = {}
_observers: dict[str, list] = {}


def _coerce(value, default):
    if isinstance(default, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(default, int):
        return int(value)
    if isinstance(default, float):
        return float(value)
    return value


def _key(name):
    return name[6:] if name.startswith("FLAGS_") else name


def define_flag(name: str, default, help_str: str = ""):
    """Register a flag (``PHI_DEFINE_EXPORTED_*``). The environment
    variable ``FLAGS_<name>`` overrides ``default`` at definition."""
    env = os.environ.get(f"FLAGS_{name}")
    value = _coerce(env, default) if env is not None else default
    with _lock:
        _registry[name] = {"value": value, "default": default,
                           "help": help_str}
    return value


def observe_flag(name: str, callback):
    """Call ``callback(value)`` whenever :func:`set_flags` sets ``name``."""
    _observers.setdefault(name, []).append(callback)


def get_flags(flags=None):
    """Every flag's value (``flags`` None), or those named by ``flags``
    (a name or a list, with or without ``FLAGS_``) under the names
    given. An unknown name raises ``ValueError``."""
    with _lock:
        if flags is None:
            return {k: v["value"] for k, v in _registry.items()}
        if isinstance(flags, str):
            flags = [flags]
        out = {}
        for name in flags:
            if _key(name) not in _registry:
                raise ValueError(f"unknown flag {name!r}")
            out[name] = _registry[_key(name)]["value"]
        return out


def set_flags(flags: dict):
    """Set each flag of ``flags`` (a dict of name to value), coerced to
    its default's type; an unknown name raises ``ValueError``."""
    fired = []
    with _lock:
        for name, value in flags.items():
            if _key(name) not in _registry:
                raise ValueError(f"unknown flag {name!r}")
            rec = _registry[_key(name)]
            rec["value"] = _coerce(value, rec["default"])
            fired.append((_key(name), rec["value"]))
    for key, value in fired:
        for cb in _observers.get(key, []):
            cb(value)


def flag_value(name: str):
    with _lock:
        return _registry[name]["value"]


# ---- the flag set: the reference's eleven ----
define_flag("check_nan_inf", False,
            "Check every op output for NaN/Inf (reference "
            "`fluid/eager/nan_inf_utils.cc`); raises on first hit.")
define_flag("check_nan_inf_level", 0,
            "0: raise on nan/inf; 1: warn only.")
define_flag("matmul_precision", "default",
            "Matmul precision: default|high|highest (stored only).")
define_flag("benchmark", False, "Sync after every op (stored only).")
define_flag("eager_delete_tensor_gb", 0.0, "Stored only.")
define_flag("use_autotune", True, "Stored only.")
define_flag("log_level", 0, "Log verbosity (stored only).")
define_flag("fraction_of_gpu_memory_to_use", 0.92, "Stored only.")
define_flag("init_allocated_mem", False, "Stored only.")
define_flag("cudnn_deterministic", False, "Stored only.")
define_flag("flash_attn", True, "Stored only: the port's attention "
            "always takes its kernels where they apply.")


def _capturing() -> bool:
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


# attribute access, and what hands out memory before anything is written
# to it (a kernel wrapper's outputs, say): not ops whose values are read
_UNCHECKED = {"__get__", "__set__", "empty", "empty_like", "empty_strided",
              "new_empty", "new_empty_strided", "resize_", "resize_as_"}


def _op_name(func) -> str:
    name = getattr(func, "__name__", None) or repr(func)
    return name.strip("_") or name


class _NanInfCheck(TorchFunctionMode):
    """Check each floating output of every torch call but
    ``_UNCHECKED``'s for nan and inf (the mode is off the stack while
    its handler runs, so the check's own calls are not checked)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if getattr(func, "__name__", "") in _UNCHECKED or _capturing():
            return out
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(o, torch.Tensor) and o.numel() and \
                    (o.is_floating_point() or o.is_complex()) and \
                    o.device.type != "meta" and \
                    not bool(torch.isfinite(o.detach()).all()):
                msg = f"NaN/Inf detected in output of op '{_op_name(func)}'"
                if flag_value("check_nan_inf_level") >= 1:
                    warnings.warn(msg)
                    break
                raise FloatingPointError(msg)
        return out


_mode = [None]


def _install_check_hook(enabled):
    if enabled and _mode[0] is None:
        _mode[0] = _NanInfCheck()
        _mode[0].__enter__()
    elif not enabled and _mode[0] is not None:
        mode, _mode[0] = _mode[0], None
        mode.__exit__(None, None, None)


observe_flag("check_nan_inf", _install_check_hook)
if flag_value("check_nan_inf"):
    _install_check_hook(True)
