"""Runtime monitoring (``paddle_tpu/monitor``): only the numerics
sentinel is ported (``numerics.py``); the counters, spans, goodput and
live planes wait in ROADMAP queue A.7."""
from . import numerics  # noqa: F401

__all__ = ["numerics"]
