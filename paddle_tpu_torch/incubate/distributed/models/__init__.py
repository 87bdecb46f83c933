"""``incubate.distributed.models``: the mixture-of-experts layer."""
from . import moe  # noqa: F401

__all__ = ["moe"]
