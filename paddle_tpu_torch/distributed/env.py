"""The parallel environment: the ranks' hybrid topology and its process
groups.

Counterpart of ``paddle_tpu/distributed/env.py``. The reference is one
controller over one ``jax.sharding.Mesh`` with the axes
:data:`AXIS_ORDER`; a process group there is a mesh axis. The port runs
one process per rank on ``torch.distributed``, as PyTorch does, and
keeps the reference's mesh as a coordinate system over the ranks:

- rank ``r`` is device ``r`` of the reference's mesh: its coordinates
  are ``r`` unravelled over the degrees in :data:`AXIS_ORDER` with
  ``mp`` fastest, as ``np.array(devices).reshape(degrees)`` lays the
  devices out there;
- the group of a set of axes is the ``torch.distributed`` subgroup of
  the ranks that share every other coordinate; a member's rank in it is
  its coordinates on those axes, flattened in the same order. Every
  subgroup of every single axis, and of ``("dp", "sharding")``, is made
  by :func:`init_mesh` on every rank in one fixed order
  (``torch.distributed.new_group`` is collective); other axis sets are
  made at first use, which every rank must then reach alike.

The process group itself comes from :mod:`.parallel`'s
``init_parallel_env`` (or :func:`init_mesh`, which starts it from the
launcher's environment when it is not up yet).
"""
from __future__ import annotations

import itertools
import math

import torch.distributed as dist

__all__ = ["AXIS_ORDER", "ParallelEnv", "init_mesh", "get_env",
           "ensure_env", "reset_env", "get_mesh"]

# outermost (slowest) first, the reference's order
AXIS_ORDER = ("dp", "pp", "sharding", "sep", "mp")

_global_env = None


class ParallelEnv:
    """The degrees of the hybrid topology, this process's rank and
    coordinates in it, and its process groups by axis set."""

    def __init__(self, degrees: dict, rank: int):
        self.degrees = {a: int(degrees[a]) for a in AXIS_ORDER}
        self.rank = rank
        self.mesh_size = math.prod(self.degrees.values())
        self._shape = [self.degrees[a] for a in AXIS_ORDER]
        self.coords = dict(zip(AXIS_ORDER, self.coords_of(rank)))
        self._groups: dict = {}  # axes -> (member ranks, process group)

    @property
    def world_size(self) -> int:
        return self.mesh_size

    nranks = world_size

    @property
    def local_rank(self) -> int:
        return self.rank

    def degree(self, axis: str) -> int:
        return self.degrees.get(axis, 1)

    def coords_of(self, rank: int) -> tuple:
        """``rank``'s coordinates in :data:`AXIS_ORDER` order."""
        out = []
        for d in reversed(self._shape):
            out.append(rank % d)
            rank //= d
        return tuple(reversed(out))

    def rank_of(self, coords) -> int:
        r = 0
        for c, d in zip(coords, self._shape):
            r = r * d + c
        return r

    def members(self, axes, rank=None) -> list:
        """The ranks of ``rank``'s group over ``axes`` (this process's by
        default), ordered by their coordinates on ``axes``."""
        axes = _canon(axes)
        base = list(self.coords_of(self.rank if rank is None else rank))
        idx = [AXIS_ORDER.index(a) for a in axes]
        out = []
        for combo in itertools.product(*[range(self._shape[i])
                                         for i in idx]):
            for i, c in zip(idx, combo):
                base[i] = c
            out.append(self.rank_of(base))
        return out

    def _make(self, axes):
        """Make every subgroup over ``axes`` (on every rank, in one order)
        and keep this rank's."""
        idx = [AXIS_ORDER.index(a) for a in axes]
        others = [i for i in range(len(AXIS_ORDER)) if i not in idx]
        mine = None
        for combo in itertools.product(*[range(self._shape[i])
                                         for i in others]):
            coords = [0] * len(AXIS_ORDER)
            for i, c in zip(others, combo):
                coords[i] = c
            ranks = self.members(axes, self.rank_of(coords))
            pg = dist.new_group(ranks)
            if self.rank in ranks:
                mine = (ranks, pg)
        self._groups[axes] = mine
        return mine

    def group(self, axes):
        """``(member ranks, process group)`` of this rank over ``axes``
        (a name or a tuple of names)."""
        axes = _canon(axes)
        if axes == AXIS_ORDER:  # the mesh holds every rank
            return list(range(self.mesh_size)), dist.group.WORLD
        got = self._groups.get(axes)
        return got if got is not None else self._make(axes)

    def destroy(self):
        for _, pg in self._groups.values():
            dist.destroy_process_group(pg)
        self._groups.clear()

    def __repr__(self):
        return f"ParallelEnv(degrees={self.degrees}, rank={self.rank})"


def _canon(axes) -> tuple:
    """Axis names as a tuple in :data:`AXIS_ORDER` order."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    bad = [a for a in axes if a not in AXIS_ORDER]
    if bad:
        raise ValueError(f"unknown mesh axes {bad}; the axes are "
                         f"{AXIS_ORDER}")
    return tuple(a for a in AXIS_ORDER if a in axes)


def init_mesh(dp: int = 1, mp: int = 1, pp: int = 1, sharding: int = 1,
              sep: int = 1) -> ParallelEnv:
    """Lay the ranks of the process group out as a ``dp x pp x sharding
    x sep x mp`` mesh, with the reference's validation: degrees are
    positive, or -1 on one axis to take the ranks left. Unlike the
    reference, which may leave devices out, the mesh holds every rank of
    the process group: a rank outside it would have no coordinates.
    Makes every axis's subgroups; a mesh made before is torn down
    first."""
    from .parallel import _ensure_process_group

    _ensure_process_group()
    world = dist.get_world_size()
    degrees = {"dp": dp, "pp": pp, "sharding": sharding, "sep": sep,
               "mp": mp}
    known, wild = 1, None
    for ax, d in degrees.items():
        if d == 0 or d < -1:
            raise ValueError(
                f"mesh degree {ax}={d}: degrees must be positive "
                "(or -1 on one axis to absorb the remaining ranks)")
        if d == -1:
            if wild is not None:
                raise ValueError("only one mesh axis may be -1 "
                                 f"(both {wild!r} and {ax!r} are)")
            wild = ax
        else:
            known *= d
    if wild is not None:
        if world % known:
            raise RuntimeError(
                f"cannot infer {wild}: {world} ranks not divisible by the "
                f"{known} explicitly requested")
        degrees[wild] = world // known
    total = math.prod(degrees.values())
    if total != world:
        raise RuntimeError(
            f"mesh of {total} ranks requested ({'*'.join(AXIS_ORDER)} = "
            f"{'*'.join(str(degrees[a]) for a in AXIS_ORDER)}) but the "
            f"process group has {world}")
    _teardown()
    env = ParallelEnv(degrees, dist.get_rank())
    for axes in [(a,) for a in AXIS_ORDER] + [("dp", "sharding")]:
        env._make(axes)
    global _global_env
    _global_env = env
    from .fleet.base import topology as _topo

    if _topo.get_hcg() is not None:  # rebuild the view over the new mesh
        _topo.set_hcg(_topo.HybridCommunicateGroup())
    return env


def get_env() -> ParallelEnv | None:
    return _global_env


def ensure_env() -> ParallelEnv:
    """The environment, made as a data-parallel mesh over every rank
    (``dp=-1``) when none was made, as in the reference."""
    if _global_env is None:
        init_mesh(dp=-1)
        _global_env.auto_initialized = True
    return _global_env


def _teardown():
    global _global_env
    if _global_env is not None:
        _global_env.destroy()
    _global_env = None


def reset_env():
    """Tear the mesh down: its subgroups are destroyed and the fleet
    globals cleared (the world process group stays up)."""
    _teardown()
    from . import fleet as _fleet
    from .fleet.base import topology as _topo

    _topo.set_hcg(None)
    _fleet._fleet_strategy = None


def get_mesh():
    """The degrees of the mesh by axis (the port has no mesh object)."""
    return dict(_global_env.degrees) if _global_env is not None else None
