"""Device resolution: CUDA by default, the CPU only when asked for.

Counterpart of ``paddle_tpu/framework/device.py``. There a device is a
JAX device chosen by platform name; here it is a ``torch.device``. The
port runs on the card: an entry point given the default ``"cuda"`` on a
host without a GPU raises instead of quietly running on the CPU. Tests
pass ``device="cpu"`` explicitly.

The ops of ``paddle_tpu_torch.tensor`` that take no tensor (creation,
random draws, ``*_indices``) place their output on the current device:
:func:`set_device` chooses it (``"gpu"``, ``"gpu:1"``, ``"cuda:0"`` or
``"cpu"``), :func:`get_device` names it and :func:`current_device`
resolves it. It starts as the card, so such an op raises on a host
without a GPU until ``set_device("cpu")`` is called. :func:`using_device`
chooses it for a block and restores the one before.

The memory functions (``memory_allocated``, ``max_memory_reserved``,
``get_device_properties``, ...) keep the reference's names
(``device.py:136-216``) and read ``torch.cuda``'s caching allocator on
the card ``device`` names (default: the current card); without a card
they raise as :func:`resolve_device` does.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "set_device", "get_device", "current_device",
           "using_device", "device_count", "is_compiled_with_tpu",
           "memory_stats", "memory_allocated", "max_memory_allocated",
           "memory_reserved", "max_memory_reserved",
           "reset_max_memory_allocated", "reset_max_memory_reserved",
           "empty_cache", "get_device_properties"]

_current = ["gpu:0"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` (a string or ``torch.device``) as a ``torch.device``.
    Raises ``RuntimeError`` for a CUDA device when no GPU is present and
    ``ValueError`` for any type other than ``cuda`` and ``cpu``."""
    try:
        dev = torch.device(device)
    except RuntimeError:
        raise ValueError(
            f"unsupported device {str(device)!r}: use 'cuda[:i]' or "
            f"'cpu'") from None
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


def _as_torch_name(device) -> str:
    """A Paddle device string (``gpu``/``gpu:i``) as torch's
    (``cuda``/``cuda:i``)."""
    name = str(device).lower()
    return "cuda" + name[3:] if name.startswith("gpu") else name


def set_device(device):
    """Make ``device`` the one that ops without a tensor input place
    their output on (``paddle.set_device``, reference ``device.py:47``).
    Raises as :func:`resolve_device` does; returns the ``torch.device``."""
    dev = resolve_device(_as_torch_name(device))
    _current[0] = "cpu" if dev.type == "cpu" else f"gpu:{dev.index}"
    return dev


def get_device() -> str:
    """The current device as a Paddle string, ``"gpu:0"`` or ``"cpu"``
    (reference ``device.py:79``)."""
    return _current[0]


def current_device() -> torch.device:
    """The current device as a ``torch.device`` (raises without a GPU
    unless ``set_device("cpu")`` was called)."""
    return resolve_device(_as_torch_name(_current[0]))


@contextlib.contextmanager
def using_device(device):
    """Within the block, ops without a tensor input place their output on
    ``device``; on exit the device before is current again. The name is
    checked but not resolved, so ``using_device("gpu")`` on a host
    without a GPU makes those ops raise, and the card (the starting
    device) comes back on such a host."""
    try:
        dev = torch.device(_as_torch_name(device))
    except RuntimeError:
        dev = None
    if dev is None or dev.type not in ("cuda", "cpu"):
        raise ValueError(
            f"unsupported device {str(device)!r}: use 'gpu[:i]' or 'cpu'")
    before = _current[0]
    _current[0] = "cpu" if dev.type == "cpu" else f"gpu:{dev.index or 0}"
    try:
        yield
    finally:
        _current[0] = before


def _card(device=None) -> torch.device:
    """The card ``device`` names (a Paddle or torch name, an index, a
    place), default the current card; raises without one or for the
    CPU."""
    if isinstance(device, int):
        device = f"gpu:{device}"
    dev = resolve_device(_as_torch_name(
        device if device is not None else
        (_current[0] if _current[0] != "cpu" else "gpu")))
    if dev.type != "cuda":
        raise ValueError(f"{device!r} is not a card: the memory functions "
                         f"read a card's allocator")
    return dev


def device_count(platform=None) -> int:
    """The number of cards (``platform`` None, ``"gpu"`` or ``"cuda"``;
    0 without one), 1 for ``"cpu"`` and 0 for ``"tpu"``."""
    p = (platform or "gpu").lower()
    if p in ("gpu", "cuda"):
        return torch.cuda.device_count()
    return 1 if p == "cpu" else 0


def is_compiled_with_tpu() -> bool:
    """False: the port runs on CUDA cards."""
    return False


def memory_stats(device=None) -> dict:
    """``torch.cuda.memory_stats`` of the card."""
    return dict(torch.cuda.memory_stats(_card(device)))


def memory_allocated(device=None) -> int:
    """Bytes held by live tensors on the card."""
    return torch.cuda.memory_allocated(_card(device))


def max_memory_allocated(device=None) -> int:
    """The peak of :func:`memory_allocated` since the process started or
    since :func:`reset_max_memory_allocated`."""
    return torch.cuda.max_memory_allocated(_card(device))


def memory_reserved(device=None) -> int:
    """Bytes the caching allocator holds on the card."""
    return torch.cuda.memory_reserved(_card(device))


def max_memory_reserved(device=None) -> int:
    return torch.cuda.max_memory_reserved(_card(device))


def reset_max_memory_allocated(device=None) -> None:
    torch.cuda.reset_peak_memory_stats(_card(device))


def reset_max_memory_reserved(device=None) -> None:
    torch.cuda.reset_peak_memory_stats(_card(device))


def empty_cache() -> None:
    """Return the allocator's unused blocks to the card."""
    _card()
    torch.cuda.empty_cache()


def get_device_properties(device=None) -> dict:
    """The card's name, platform, index, total memory and bytes in use,
    under the reference's keys."""
    dev = _card(device)
    props = torch.cuda.get_device_properties(dev)
    return {"name": props.name, "platform": "gpu", "index": dev.index,
            "total_memory": int(props.total_memory),
            "bytes_in_use": torch.cuda.memory_allocated(dev)}
