"""fleet: the distributed-training facade.

Counterpart of ``paddle_tpu/distributed/fleet/__init__.py``:

- :func:`init` lays the ranks out as the mesh of the strategy's
  ``hybrid_configs`` (starting the process group from the launcher's
  environment if it is not up) and installs the
  ``HybridCommunicateGroup``;
- :func:`distributed_model` returns ``PipelineParallel`` for a
  ``PipelineLayer`` under pp > 1 (which sums the gradients over the
  batch axes once a ``train_batch``: the reference's dp x mp x pp
  layout with SP and experts over dp included, each rank's mp shards
  and SP norms summed by their layers), wraps a model in
  ``DataParallel`` when dp > 1,
  mp = 1 and pp = 1, as the reference does, and otherwise returns the
  model itself. Under dp > 1 with mp > 1 the model's gradients are
  still summed over ``dp`` after each backward (the reference gets that
  from GSPMD; Paddle's ``HybridParallelOptimizer`` does it in
  ``step``), by the same hooks ``DataParallel`` uses. A model with
  ``config.context_parallel`` holds a sequence chunk on each ``sep``
  rank, so its gradients are summed over dp and sep together. A
  parameter laid out over a batch axis (an expert over dp or sharding)
  is summed over the other batch axes only;
- :func:`distributed_optimizer` returns the optimizer, as the
  reference does: each tensor-parallel parameter records its layout
  (``shard.Layout``), from which the clips and Lamb take the group
  their norms are summed over, and ``LBFGS`` its dot products (under
  pp it raises, as the reference's: ``train_batch`` passes no
  closure).
"""
from __future__ import annotations

from .. import env as env_mod
from .base.distributed_strategy import DistributedStrategy
from .base.role_maker import (  # noqa: F401
    PaddleCloudRoleMaker, Role, UserDefinedRoleMaker,
)
from .base.topology import (
    CommunicateTopology, HybridCommunicateGroup, ensure_hcg, get_hcg, set_hcg,
)
from . import utils  # noqa: F401

__all__ = [
    "init", "DistributedStrategy", "HybridCommunicateGroup",
    "CommunicateTopology", "distributed_model", "distributed_optimizer",
    "get_hybrid_communicate_group", "worker_index", "worker_num",
    "is_first_worker", "barrier_worker", "utils", "Fleet", "Role",
    "PaddleCloudRoleMaker", "UserDefinedRoleMaker", "UtilBase",
    "get_hcg", "set_hcg", "ensure_hcg",
]

_fleet_strategy: DistributedStrategy | None = None


def init(role_maker=None, is_collective=False, strategy=None,
         log_level="INFO"):
    """Lay out the mesh from ``strategy.hybrid_configs`` (every degree 1
    by default) and install the hybrid group."""
    global _fleet_strategy
    strategy = strategy or DistributedStrategy()
    _fleet_strategy = strategy
    hc = strategy.hybrid_configs
    env_mod.init_mesh(
        dp=hc.get("dp_degree", 1) or 1,
        mp=hc.get("mp_degree", 1) or 1,
        pp=hc.get("pp_degree", 1) or 1,
        sharding=hc.get("sharding_degree", 1) or 1,
        sep=hc.get("sep_degree", 1) or 1,
    )
    set_hcg(HybridCommunicateGroup())
    return None


def get_strategy() -> DistributedStrategy | None:
    return _fleet_strategy


def get_hybrid_communicate_group() -> HybridCommunicateGroup:
    return ensure_hcg()


def batch_axes(config=None):
    """The mesh axes a model's batch is split over: dp; sharding when
    its degree is > 1 (its ranks hold batch shards too, as Paddle's
    sharding group does, whether or not ZeRO shards the states); and
    sep for a model run with ``config.context_parallel`` (each rank
    holds a sequence chunk)."""
    hcg = get_hcg()
    axes = ["dp"]
    if hcg is not None and hcg.get_sharding_parallel_world_size() > 1:
        axes.append("sharding")
    if getattr(config, "context_parallel", False) and hcg is not None \
            and hcg.get_sep_parallel_world_size() > 1:
        axes.append("sep")
    return tuple(axes)


def distributed_model(model):
    """``PipelineParallel`` for a ``PipelineLayer`` under pp > 1;
    ``DataParallel(model)`` for pure data parallelism (over dp and, for
    a context-parallel model, sep); else the model (see the module
    note)."""
    from ..collective import Group
    from ..parallel import DataParallel, _batch_sums, _sync_gradients
    from .meta_parallel.parallel_layers.pp_layers import PipelineLayer
    from .meta_parallel.pipeline_parallel import PipelineParallel

    hcg = ensure_hcg()
    if hcg.get_pipe_parallel_world_size() > 1 \
            and isinstance(model, PipelineLayer):
        return PipelineParallel(model, hcg, _fleet_strategy)
    group = Group(batch_axes(getattr(model, "config", None)))
    if group.nranks > 1 and hcg.get_model_parallel_world_size() == 1 \
            and hcg.get_pipe_parallel_world_size() == 1:
        return DataParallel(model, group=group)
    if group.nranks > 1:
        model._dp_sync_handles = [
            h for sub, params in _batch_sums(model.parameters(), group.axes,
                                             group._pair())
            for h in _sync_gradients(params, sub)]
    return model


def distributed_optimizer(optimizer, strategy=None):
    """The optimizer itself (see the module note; ``LBFGS`` takes its dot
    products and max-abs values over the ranks itself)."""
    return optimizer


def worker_index():
    e = env_mod.get_env()
    return e.rank if e else 0


def worker_num():
    e = env_mod.get_env()
    return e.world_size if e else 1


def is_first_worker():
    return worker_index() == 0


def barrier_worker():
    from ..collective import barrier

    barrier()


class UtilBase:
    """``fleet.UtilBase``: host-side helpers over the collectives."""

    def all_reduce(self, input, mode="sum", comm_world="worker"):  # noqa: A002
        import numpy as np
        import torch

        from ..collective import ReduceOp, all_reduce

        op = {"sum": ReduceOp.SUM, "max": ReduceOp.MAX,
              "min": ReduceOp.MIN}[mode]
        out = all_reduce(torch.as_tensor(np.array(input)), op=op)
        return out.numpy()

    def barrier(self, comm_world="worker"):
        barrier_worker()

    def all_gather(self, input, comm_world="worker"):  # noqa: A002
        import numpy as np
        import torch

        from ..collective import all_gather

        outs: list = []
        all_gather(outs, torch.as_tensor(np.array(input)))
        return [o.numpy() for o in outs]

    def get_file_shard(self, files):
        """Split a file list over the workers (earlier workers take the
        remainder)."""
        n = worker_num()
        i = worker_index()
        base, rem = divmod(len(files), n)
        start = i * base + min(i, rem)
        return files[start:start + base + (1 if i < rem else 0)]

    def print_on_rank(self, message, rank_id=0):
        if worker_index() == rank_id:
            print(message)


class Fleet:
    """The ``fleet.Fleet`` facade: the module's functions as methods."""

    init = staticmethod(init)
    distributed_model = staticmethod(distributed_model)
    distributed_optimizer = staticmethod(distributed_optimizer)
    worker_index = staticmethod(worker_index)
    worker_num = staticmethod(worker_num)
    is_first_worker = staticmethod(is_first_worker)
    barrier_worker = staticmethod(barrier_worker)
    get_hybrid_communicate_group = staticmethod(
        get_hybrid_communicate_group)

    @property
    def util(self):
        return UtilBase()

    def is_worker(self):
        return True

    def is_server(self):
        return False
