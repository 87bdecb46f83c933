"""``incubate.distributed``: the expert-parallel models."""
from . import models  # noqa: F401

__all__ = ["models"]
