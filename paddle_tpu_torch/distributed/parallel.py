"""Starting the process group, and ``DataParallel``.

Counterpart of ``paddle_tpu/distributed/parallel.py``. The reference is
one controller: ``spawn`` calls the function once and data parallelism
is a batch sharding that XLA completes with the gradient all-reduce.
The port runs one process per rank:

- :func:`init_parallel_env` starts the world process group from the
  launcher's contract (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
  ``PADDLE_MASTER`` as ``host:port``; or ``init_method``), NCCL by
  default (CUDA; raises without a GPU) or ``backend="gloo"``, then lays
  the ranks out as the mesh (``env.init_mesh``);
- :func:`spawn` starts ``nprocs`` processes with
  ``torch.multiprocessing`` (start method ``spawn``), each with the
  launcher's variables set, and calls the function in each;
- :class:`DataParallel` sums over the ``dp`` group what each backward
  adds to every gradient. It sums, not averages: the port's losses
  divide by the global batch's count (``masked_token_mean``), so the sum
  is the gradient of the global mean, as in the reference; so gradients
  accumulated over several backwards sum each backward's part once. A
  parameter laid out over some of the group's axes (an expert over dp)
  is summed over the others only: over its own its gradient is whole on
  its rank.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import socket

import torch
import torch.distributed as dist

from . import _comm
from . import env as env_mod

__all__ = ["init_parallel_env", "get_rank", "get_world_size",
           "is_initialized", "ParallelEnv", "DataParallel", "spawn"]


def _launcher():
    """(rank, world size, init method) from the launcher's variables."""
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    master = os.environ.get("PADDLE_MASTER")
    return rank, world, f"tcp://{master}" if master else None


def _ensure_process_group(backend=None, init_method=None):
    """Start the world process group if it is not up: NCCL unless
    ``backend`` says otherwise, which needs a GPU; on CUDA this rank
    takes device ``rank % device_count``."""
    if dist.is_initialized():
        return
    backend = backend or "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError(
            "the nccl backend needs a CUDA device and none is present; "
            "pass backend='gloo' to run the ranks on the CPU")
    rank, world, method = _launcher()
    method = init_method or method
    kw = {}
    if method is None:
        if world != 1:
            raise RuntimeError(
                f"PADDLE_TRAINERS_NUM={world} but neither PADDLE_MASTER "
                f"nor init_method says where the ranks meet")
        kw["store"] = dist.HashStore()
    else:
        kw["init_method"] = method
    if torch.cuda.is_available() and backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, rank=rank, world_size=world, **kw)


def init_parallel_env(dp=-1, mp=1, pp=1, sharding=1, sep=1, backend=None,
                      init_method=None):
    """Start the process group (see the module note) and lay the ranks
    out as a ``dp x pp x sharding x sep x mp`` mesh; returns the
    environment (``env.ParallelEnv``)."""
    _ensure_process_group(backend, init_method)
    return env_mod.init_mesh(dp=dp, mp=mp, pp=pp, sharding=sharding,
                             sep=sep)


def get_rank(group=None):
    """This process's rank (in ``group`` if given)."""
    if group is not None:
        from .collective import get_group

        return get_group(group).rank
    if dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("PADDLE_TRAINER_ID", 0))


def get_world_size(group=None):
    if group is not None:
        from .collective import get_group

        return get_group(group).nranks
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("PADDLE_TRAINERS_NUM", 1))


def is_initialized():
    return env_mod.get_env() is not None


class ParallelEnv:
    """``paddle.distributed.ParallelEnv``'s attributes."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def device_id(self):
        n = torch.cuda.device_count()
        return get_rank() % n if n else 0

    dev_id = device_id


def _batch_sums(params, axes, pair=None):
    """``[(group, params)]``: the parameters whose gradients a batch group
    over ``axes`` (its ``(ranks, process group)`` ``pair``; the mesh's
    by default) sums, each under the group of the batch axes that its
    layout does not cut (``shard.Layout``). Such a parameter is not
    replicated over the axes it is cut on: each rank holds other experts
    (``MoELayer`` over dp), and its backward already sums every rank's
    tokens on those axes into its gradient through the layer's
    collectives; over the other batch axes it is summed as any other.
    Groups of one rank are left out. Every group over a subset of
    ``axes`` is made here, in one order on every rank."""
    env = env_mod.ensure_env()
    axes = env_mod._canon(axes) if axes else None
    if axes is not None:
        for k in range(1, len(axes)):
            for sub in itertools.combinations(axes, k):
                env.group(sub)
    by_axes = {}
    for p in params:
        lay = getattr(p, "_dist_layout", None)
        sub = axes if axes is None or lay is None \
            else tuple(a for a in axes if a not in lay.axes)
        if sub != ():
            by_axes.setdefault(sub, []).append(p)
    out = []
    for sub, ps in by_axes.items():
        g = pair if sub == axes and pair is not None else env.group(sub)
        if len(g[0]) > 1:
            out.append((g, ps))
    return out


def _sync_gradients(params, group, enabled=lambda: True):
    """Sum over ``group`` what each backward adds to a parameter's
    gradient while ``enabled()``; returns the hook handles.

    What ``p.grad`` already holds summed (an earlier synced backward) is
    not summed again: onto such a gradient the new part is summed before
    it is accumulated. A backward while not ``enabled()`` leaves its part
    local; the next enabled backward sums the local parts once, after
    accumulating its own, apart from the summed part ``p.grad`` held
    before them (kept aside meanwhile). A gradient cleared or written
    since the last backward (``None``, or a new version) holds no local
    part."""
    local = {}  # p -> [summed part kept aside or None, p.grad, its version]

    def before(p, g):
        held = local.get(p)
        if held is not None and (held[1] is not p.grad
                                 or p.grad._version != held[2]):
            del local[p]
            held = None
        if held is None and p.grad is not None:
            if enabled():
                return _comm.all_reduce(g.clone(), group)
            local[p] = [p.grad.clone(), None, None]
        local.setdefault(p, [None, None, None])
        return g

    def after(p):
        held = local.get(p)
        if held is None:
            return
        if not enabled():
            held[1:] = [p.grad, p.grad._version]
            return
        del local[p]
        with torch.no_grad():
            if held[0] is not None:
                p.grad.sub_(held[0])
            _comm.all_reduce(p.grad, group)
            if held[0] is not None:
                p.grad.add_(held[0])

    handles = []
    for p in params:
        if p.requires_grad:
            handles.append(p.register_hook(
                lambda g, p=p: before(p, g)))
            handles.append(p.register_post_accumulate_grad_hook(after))
    return handles


class DataParallel:
    """``paddle.DataParallel(layers)``: the layer's own forward; what
    each backward adds to a gradient is summed over the ``dp`` group
    (see the module note for why a sum). Inside :meth:`no_sync` a
    backward leaves its part local; the next backward outside it sums
    the local parts once. The reducer's knobs are accepted. Parameters
    keep their names (``named_parameters``, ``state_dict`` are the
    layer's)."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        from .collective import get_group

        object.__setattr__(self, "_layers", layers)
        object.__setattr__(self, "_sync", [True])
        group = get_group(group if group is not None else "dp")
        pair = group._pair()
        handles = []
        if len(pair[0]) > 1:
            for sub, params in _batch_sums(layers.parameters(), group.axes,
                                           pair):
                handles += _sync_gradients(params, sub,
                                           lambda: self._sync[0])
        object.__setattr__(self, "_handles", handles)

    def __getattr__(self, name):
        return getattr(self._layers, name)

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    @contextlib.contextmanager
    def no_sync(self):
        self._sync[0] = False
        try:
            yield
        finally:
            self._sync[0] = True

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.load_state_dict(*a, **k)

    def parameters(self, *a, **k):
        return self._layers.parameters(*a, **k)

    def named_parameters(self, *a, **k):
        return self._layers.named_parameters(*a, **k)

    def train(self, mode=True):
        self._layers.train(mode)
        return self

    def eval(self):
        self._layers.eval()
        return self


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(i, func, args, nprocs, master):
    os.environ["PADDLE_TRAINER_ID"] = str(i)
    os.environ["PADDLE_TRAINERS_NUM"] = str(nprocs)
    os.environ.setdefault("PADDLE_MASTER", master)
    func(*args)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Run ``func(*args)`` in ``nprocs`` new processes (one per CUDA
    device when -1, at least 1), each with ``PADDLE_TRAINER_ID``,
    ``PADDLE_TRAINERS_NUM`` and ``PADDLE_MASTER`` (a free local port
    unless set) exported. Raises if any process fails."""
    import torch.multiprocessing as mp

    if nprocs == -1:
        nprocs = max(torch.cuda.device_count(), 1)
    master = os.environ.get("PADDLE_MASTER") \
        or f"127.0.0.1:{_free_port()}"
    return mp.start_processes(_entry, args=(func, tuple(args), nprocs,
                                            master),
                              nprocs=nprocs, join=join, daemon=daemon,
                              start_method="spawn")
