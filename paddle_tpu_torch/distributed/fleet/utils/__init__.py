"""fleet.utils: recomputation and sequence parallelism."""
from . import sequence_parallel_utils  # noqa: F401
from .recompute import recompute, recompute_sequential  # noqa: F401

__all__ = ["recompute", "recompute_sequential", "sequence_parallel_utils"]
