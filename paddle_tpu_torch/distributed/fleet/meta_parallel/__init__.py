"""The tensor-parallel layers and the named random states (counterpart
of ``paddle_tpu/distributed/fleet/meta_parallel/``; the pipeline layers
and schedule wait for a later slice)."""
from .parallel_layers.mp_layers import (  # noqa: F401
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding, masked_token_mean,
)
from .parallel_layers.random import (  # noqa: F401
    RNGStatesTracker, get_rng_state_tracker, model_parallel_random_seed,
)

__all__ = [
    "ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding",
    "ParallelCrossEntropy", "masked_token_mean", "RNGStatesTracker",
    "get_rng_state_tracker", "model_parallel_random_seed",
]
