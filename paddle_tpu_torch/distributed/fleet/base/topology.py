"""The hybrid-parallel topology.

Counterpart of ``paddle_tpu/distributed/fleet/base/topology.py``. There
the topology is the mesh and every rank query answers 0, as one
controller drives every device. Here each process is one rank: its
place on each axis is its mesh coordinate (``env.ParallelEnv``), and
each axis's group is the ``torch.distributed`` subgroup of the ranks
that share every other coordinate.
"""
from __future__ import annotations

from ... import env as env_mod
from ...collective import Group

__all__ = ["CommunicateTopology", "HybridCommunicateGroup", "set_hcg",
           "get_hcg", "ensure_hcg"]


class CommunicateTopology:
    """The degrees under the reference's axis vocabulary."""

    _ALIAS = {"data": "dp", "pipe": "pp", "sharding": "sharding",
              "sep": "sep", "model": "mp"}

    def __init__(self, hybrid_group_names=("data", "pipe", "sharding",
                                           "sep", "model"), dims=None):
        self._names = list(hybrid_group_names)
        e = env_mod.ensure_env()
        self._dims = list(dims) if dims is not None else [
            e.degree(self._ALIAS[n]) for n in self._names]

    def get_hybrid_group_names(self):
        return self._names

    def get_dim(self, axis_name):
        return self._dims[self._names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        n = 1
        for d in self._dims:
            n *= d
        return n


class HybridCommunicateGroup:
    """Each axis's world size, this rank's place on it, its group, and
    the global rank of the group's first member (``*_group_src_rank``)."""

    def __init__(self, topology: CommunicateTopology | None = None):
        self._topo = topology or CommunicateTopology()
        self._env = env_mod.ensure_env()
        self._dp_group = Group(("dp",), "dp_group")
        self._mp_group = Group(("mp",), "mp_group")
        self._pp_group = Group(("pp",), "pp_group")
        self._sharding_group = Group(("sharding",), "sharding_group")
        self._sep_group = Group(("sep",), "sep_group")
        # dp and sharding together: the group a pure-dp parameter's
        # gradient is checked over
        self._dp_sharding_group = Group(("dp", "sharding"), "dp_sharding")

    def get_hybrid_communicate_group(self):
        return self

    @property
    def topology(self):
        return self._topo

    def topology_obj(self):
        return self._topo

    def _src(self, group):
        return group.ranks[0]

    # -- global --
    def get_global_rank(self):
        return self._env.rank

    def get_world_size(self):
        return self._env.world_size

    # -- data parallel --
    def get_data_parallel_world_size(self):
        return self._env.degree("dp")

    def get_data_parallel_rank(self):
        return self._env.coords["dp"]

    def get_data_parallel_group(self):
        return self._dp_group

    def get_data_parallel_group_src_rank(self):
        return self._src(self._dp_group)

    # -- model (tensor) parallel --
    def get_model_parallel_world_size(self):
        return self._env.degree("mp")

    def get_model_parallel_rank(self):
        return self._env.coords["mp"]

    def get_model_parallel_group(self):
        return self._mp_group

    def get_model_parallel_group_src_rank(self):
        return self._src(self._mp_group)

    # -- pipeline parallel --
    def get_pipe_parallel_world_size(self):
        return self._env.degree("pp")

    def get_pipe_parallel_rank(self):
        return self._env.coords["pp"]

    def get_stage_id(self):
        return self._env.coords["pp"]

    def get_pipe_parallel_group(self):
        return self._pp_group

    def get_pipe_parallel_group_src_rank(self):
        return self._src(self._pp_group)

    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self.get_pipe_parallel_world_size() - 1

    def get_rank_from_stage(self, stage_id):
        """The global rank of stage ``stage_id`` in this rank's pp group
        (the same coordinates on every other axis)."""
        return self._pp_group.ranks[stage_id]

    def _get_p2p_next_rank(self):
        """The global rank of the next stage (the first after the last:
        the pp group is a ring, as in Paddle)."""
        n = self.get_pipe_parallel_world_size()
        return self.get_rank_from_stage((self.get_stage_id() + 1) % n)

    def _get_p2p_prev_rank(self):
        """The global rank of the previous stage (the last before the
        first)."""
        n = self.get_pipe_parallel_world_size()
        return self.get_rank_from_stage((self.get_stage_id() - 1) % n)

    # -- sharding --
    def get_sharding_parallel_world_size(self):
        return self._env.degree("sharding")

    def get_sharding_parallel_rank(self):
        return self._env.coords["sharding"]

    def get_sharding_parallel_group(self):
        return self._sharding_group

    def get_sharding_parallel_group_src_rank(self):
        return self._src(self._sharding_group)

    # -- sep --
    def get_sep_parallel_world_size(self):
        return self._env.degree("sep")

    def get_sep_parallel_rank(self):
        return self._env.coords["sep"]

    def get_sep_parallel_group(self):
        return self._sep_group

    def get_sep_parallel_group_src_rank(self):
        return self._src(self._sep_group)

    def get_check_parallel_group(self, sharding=False):
        return self._dp_sharding_group


_hcg: HybridCommunicateGroup | None = None


def set_hcg(hcg: HybridCommunicateGroup | None):
    global _hcg
    _hcg = hcg


def get_hcg() -> HybridCommunicateGroup | None:
    return _hcg


def ensure_hcg() -> HybridCommunicateGroup:
    global _hcg
    if _hcg is None:
        _hcg = HybridCommunicateGroup()
    return _hcg
