"""Continuous-batching decode serving on the block KV pool.

    from paddle_tpu_torch.serving import ServingEngine, ServingConfig

    engine = ServingEngine(model, ServingConfig(max_lanes=8))
    req = engine.submit(prompt_ids, max_new_tokens=64)
    outputs = engine.run()   # {request_id: generated token ids}
"""
from .engine import ServingConfig, ServingEngine  # noqa: F401
from .kv_cache import BlockPool, blocks_needed, prefix_keys  # noqa: F401
from .scheduler import (  # noqa: F401
    FINISHED, RUNNING, WAITING, FCFSScheduler, Request,
)
from .speculative import Drafter, NgramDrafter  # noqa: F401

__all__ = [
    "ServingConfig", "ServingEngine", "BlockPool", "blocks_needed",
    "prefix_keys", "FCFSScheduler", "Request", "WAITING", "RUNNING",
    "FINISHED", "Drafter", "NgramDrafter",
]
