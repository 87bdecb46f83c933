"""Device resolution: CUDA by default, the CPU only when asked for.

Counterpart of ``paddle_tpu/framework/device.py``. There a device is a
JAX device chosen by platform name; here it is a ``torch.device``. The
port runs on the card: an entry point given the default ``"cuda"`` on a
host without a GPU raises instead of quietly running on the CPU. Tests
pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` (a string or ``torch.device``) as a ``torch.device``.
    Raises ``RuntimeError`` for a CUDA device when no GPU is present and
    ``ValueError`` for any type other than ``cuda`` and ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA device is "
                f"present; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(
            f"unsupported device {str(device)!r}: use 'cuda[:i]' or 'cpu'")
    return dev
