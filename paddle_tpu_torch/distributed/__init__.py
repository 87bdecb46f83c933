"""paddle_tpu_torch.distributed: the collectives, the hybrid topology and
fleet's tensor- and sequence-parallel layers, ZeRO (``sharding``) and
the sharded checkpoint (``checkpoint``) on ``torch.distributed``, one
process per rank (counterpart of ``paddle_tpu/distributed``; see
``env.py`` for how ranks map onto the reference's mesh)."""
from __future__ import annotations

from .env import (  # noqa: F401
    AXIS_ORDER, get_env, get_mesh, init_mesh,
)
from .collective import (  # noqa: F401
    Group, ReduceOp, all_gather, all_gather_object, all_reduce, all_to_all,
    alltoall, alltoall_single, barrier, broadcast, broadcast_object_list,
    destroy_process_group, gather, get_backend, get_group, irecv,
    is_available, isend, new_group, ppermute, recv, reduce, reduce_scatter,
    scatter, scatter_object_list, send, wait,
)
from .parallel import (  # noqa: F401
    DataParallel, ParallelEnv, get_rank, get_world_size, init_parallel_env,
    is_initialized, spawn,
)
from .shard import (  # noqa: F401
    PartitionSpec, get_sharding, replicate, shard_parameter, shard_tensor,
    sharding_constraint,
)
from .store import TCPStore  # noqa: F401
from . import checkpoint  # noqa: F401
from . import fleet  # noqa: F401
from . import sharding  # noqa: F401

__all__ = [
    "init_parallel_env", "get_rank", "get_world_size", "is_initialized",
    "ParallelEnv", "DataParallel", "spawn",
    "ReduceOp", "Group", "new_group", "get_group",
    "all_reduce", "all_gather", "all_to_all", "alltoall", "alltoall_single",
    "broadcast", "reduce", "scatter", "reduce_scatter", "barrier", "wait",
    "send", "recv", "isend", "irecv", "gather", "ppermute",
    "all_gather_object", "broadcast_object_list", "scatter_object_list",
    "destroy_process_group", "get_backend", "is_available",
    "shard_tensor", "sharding_constraint", "shard_parameter", "replicate",
    "get_sharding", "PartitionSpec", "TCPStore",
    "init_mesh", "get_mesh", "get_env", "AXIS_ORDER", "fleet",
    "checkpoint", "sharding",
]
