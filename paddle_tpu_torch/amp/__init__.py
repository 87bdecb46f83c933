"""Mixed precision (``paddle_tpu/amp``): ``auto_cast`` at O1 and O2 in
bfloat16 or float16, ``decorate``, and ``GradScaler`` for float16's
range. Not ported: ``amp/debugging.py`` (ROADMAP queue A)."""
from . import amp_lists  # noqa: F401
from .auto_cast import (  # noqa: F401
    amp_guard, amp_state, auto_cast, cast_inputs, decorate,
)
from .grad_scaler import AmpScaler, GradScaler  # noqa: F401

WHITE_LIST = amp_lists.WHITE_LIST
BLACK_LIST = amp_lists.BLACK_LIST

__all__ = ["auto_cast", "amp_guard", "amp_state", "decorate", "GradScaler",
           "AmpScaler", "amp_lists", "is_bfloat16_supported",
           "is_float16_supported"]


def is_bfloat16_supported(device=None):
    """The port's kernels take bfloat16 on every card they build for."""
    return True


def is_float16_supported(device=None):
    """float16 runs the Llama path's kernels (flash kernels 1-3 at head
    dim 128, causal, no key row or dropout); every other kernel variant
    raises on float16."""
    return True
