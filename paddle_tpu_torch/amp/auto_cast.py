"""Autocast: ``auto_cast`` / ``amp_guard`` and ``decorate``.

Counterpart of ``paddle_tpu/amp/auto_cast.py``. There one hook in the
op dispatcher sees every op by its Paddle name and casts its inputs;
here each op entry of the port calls :func:`cast_inputs` with the
reference's op name before it computes:

- ``nn.functional.linear`` and ``tensor.matmul`` (white: the Llama's
  projections and its LM head), ``scaled_dot_product_attention`` and
  ``sliding_window_attention`` (white), ``rms_norm``, ``layer_norm``,
  ``softmax`` and ``cross_entropy`` (black: fp32), and
  ``chunked_lm_ce`` and ``tensor.add`` (gray).

The policy is the reference's: white ops cast their float inputs to the
low dtype, black ops to fp32, gray ops keep their dtypes under O1
(promoted to fp32 when their float inputs are mixed, as at
``auto_cast.py:96-100``) and take the low dtype under O2. Elementwise
work between entries (the residual adds, SiLU, the RoPE rotation) is
torch arithmetic, whose type promotion gives what a gray op gives under
O1: an fp32 residual plus a bf16 projection is fp32.

This is not ``torch.autocast``: its op lists are not these, it cannot
take custom lists by Paddle op name, and it never sees the ctypes
kernels. The state is a thread-local stack, so threads do not disable
each other's casting. Casts are ordinary autograd ops: a gradient comes
back in its parameter's dtype.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from . import amp_lists

__all__ = ["auto_cast", "amp_guard", "amp_state", "decorate",
           "cast_inputs"]

_state = threading.local()

_LOW = {"float16": torch.float16, "bfloat16": torch.bfloat16}


def _ctx():
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


def amp_state():
    """The innermost ``auto_cast`` config of this thread, or None."""
    stack = _ctx()
    return stack[-1] if stack else None


class _AmpConfig:
    __slots__ = ("enable", "level", "dtype", "white", "black")

    def __init__(self, enable, level, dtype, custom_white, custom_black):
        self.enable = enable
        self.level = level.upper()
        self.dtype = dtype
        white = amp_lists.white_list()
        black = amp_lists.black_list()
        if custom_white:
            white |= set(custom_white)
            black -= set(custom_white)
        if custom_black:
            black |= set(custom_black)
            white -= set(custom_black)
        self.white = white
        self.black = black

    def __repr__(self):
        return (f"_AmpConfig(enable={self.enable}, level={self.level!r}, "
                f"dtype={self.dtype!r})")


def _cast(tensors, target):
    return tuple(t.to(target) if isinstance(t, torch.Tensor)
                 and t.is_floating_point() and t.dtype != target else t
                 for t in tensors)


def cast_inputs(op_name, *tensors):
    """``tensors`` as the op ``op_name`` takes them under the current
    ``auto_cast`` state (unchanged outside one); non-float and non-tensor
    arguments pass through."""
    cfg = amp_state()
    if cfg is None or not cfg.enable:
        return tensors
    if op_name in cfg.black:
        return _cast(tensors, torch.float32)
    low = _LOW[cfg.dtype]
    if op_name in cfg.white or cfg.level == "O2":
        return _cast(tensors, low)
    dtypes = {t.dtype for t in tensors
              if isinstance(t, torch.Tensor) and t.is_floating_point()}
    if len(dtypes) > 1:
        return _cast(tensors, torch.float32)
    return tensors


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """Mixed precision inside the block (``paddle.amp.auto_cast``):
    ``level`` O0 (off), O1 (white ops low, black ops fp32) or O2 (every
    op low but black ops); ``dtype`` ``"bfloat16"`` or ``"float16"``;
    custom lists move op names between the lists. Nested blocks stack."""
    if dtype not in _LOW:
        raise ValueError(f"amp dtype must be float16|bfloat16, got {dtype!r}")
    if level.upper() not in ("O0", "O1", "O2"):
        raise ValueError(f"amp level must be O0|O1|O2, got {level!r}")
    cfg = _AmpConfig(enable and level.upper() != "O0", level, dtype,
                     custom_white_list, custom_black_list)
    with _pushed(cfg):
        yield


@contextlib.contextmanager
def _pushed(cfg):
    """Run the block under ``cfg`` (an ``amp_state()`` value; None runs it
    with casting off)."""
    stack = _ctx()
    stack.append(cfg if cfg is not None
                 else _AmpConfig(False, "O0", "bfloat16", None, None))
    try:
        yield
    finally:
        stack.pop()


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """Prepare models and optimizers for AMP (``paddle.amp.decorate``,
    reference ``auto_cast.py:136-166``).

    ``level="O2"`` casts every fp32 parameter to ``dtype`` in place
    (norm scales and biases included) and leaves the buffers fp32, as
    the reference does (``auto_cast.py:150-156``): BatchNorm's running
    statistics stay fp32; ``level="O1"`` leaves the parameters fp32, since
    ``auto_cast`` casts them per op. Either way each optimizer is forced
    to ``multi_precision`` (fp32 masters for low-precision parameters).
    Returns the model (or list) and, when given, the optimizer (or
    list), as the reference returns them."""
    if level.upper() not in ("O1", "O2"):
        raise ValueError("decorate level must be O1 or O2")
    if dtype not in _LOW:
        raise ValueError(f"amp dtype must be float16|bfloat16, got {dtype!r}")
    low = _LOW[dtype]
    single_model = isinstance(models, torch.nn.Module)
    model_list = [models] if single_model else list(models)
    if level.upper() == "O2":
        with torch.no_grad():
            for m in model_list:
                for p in m.parameters():
                    if p.dtype == torch.float32:
                        p.data = p.data.to(low)
    out_models = model_list[0] if single_model else model_list
    if optimizers is None:
        return out_models
    single_opt = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if single_opt else list(optimizers)
    for opt in opt_list:
        opt._multi_precision = True
    return out_models, (opt_list[0] if single_opt else opt_list)
