"""The tensor-parallel layers, the pipeline container and its driver,
and the named random states (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/``)."""
from .parallel_layers.mp_layers import (  # noqa: F401
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding, masked_token_mean,
)
from .parallel_layers.pp_layers import (  # noqa: F401
    LayerDesc, PipelineLayer, SharedLayerDesc,
)
from .parallel_layers.random import (  # noqa: F401
    RNGStatesTracker, get_rng_state_tracker, model_parallel_random_seed,
)
from .pipeline_parallel import PipelineParallel  # noqa: F401

__all__ = [
    "ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding",
    "ParallelCrossEntropy", "masked_token_mean", "LayerDesc",
    "SharedLayerDesc", "PipelineLayer", "PipelineParallel",
    "RNGStatesTracker", "get_rng_state_tracker",
    "model_parallel_random_seed",
]
