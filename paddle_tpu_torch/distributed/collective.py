"""Process groups and collective communication on ``torch.distributed``.

Counterpart of ``paddle_tpu/distributed/collective.py``. There a group
is a set of mesh axes and an eager tensor is one global array; here a
group is a ``torch.distributed`` subgroup (see :mod:`.env`) and a
tensor is this rank's. The mapping every function keeps: a reference
global array sharded by a spec equals the ranks' tensors concatenated
in mesh order, and a replicated one equals every rank's copy. So a
collective on replicated tensors gives what N identical ranks give,
which is what the reference's docstring says its collectives give.

- ``src``/``dst`` are global ranks, as in Paddle;
- ``reduce`` leaves the result on every rank, as the reference's does
  (Paddle leaves the other ranks' tensors unspecified);
- ``scatter`` and ``gather`` without a list, ``reduce_scatter`` and the
  functional ``all_to_all`` take the reference's shapes: this rank's
  shard in, this rank's shard out;
- ``sync_op`` is accepted; every call completes before it returns;
- ``send``, ``recv``, ``isend`` and ``irecv`` raise, as the reference's
  do; ``ppermute`` is the point-to-point form, one batch of ``P2POp``\\ s,
  over :func:`p2p` (any batch of sends and receives, the pipeline's).

NCCL runs the CUDA tensors (it refuses two ranks on one card), gloo the
CPU ones, and CUDA tensors by way of the host. Every call goes through
``_comm.run``, which counts the host-staged ones.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from . import _comm
from . import env as env_mod

__all__ = ["ReduceOp", "Group", "new_group", "get_group", "all_reduce",
           "all_gather", "broadcast", "reduce", "scatter", "gather",
           "reduce_scatter", "all_to_all", "alltoall", "alltoall_single",
           "barrier", "wait", "ppermute", "p2p", "send", "recv", "isend",
           "irecv",
           "all_gather_object", "broadcast_object_list",
           "scatter_object_list", "destroy_process_group", "get_backend",
           "is_available"]


class ReduceOp:
    """The reference's reduce kinds."""

    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OP = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
             "min": dist.ReduceOp.MIN, "prod": dist.ReduceOp.PRODUCT}


class Group:
    """A communicator: the subgroup over mesh ``axes`` that holds this
    rank, or a subgroup of explicit ``ranks``. ``nranks`` members,
    ``rank`` this process's place among them (-1 if it is not one)."""

    def __init__(self, axes=None, name=None, ranks=None, pg=None):
        self.axes = tuple(axes) if axes is not None else None
        self.name = name or ("_".join(self.axes) if self.axes else "ranks")
        self._ranks = list(ranks) if ranks is not None else None
        self._pg = pg

    def _pair(self):
        """(member ranks, process group)."""
        if self._ranks is not None:
            return self._ranks, self._pg
        return env_mod.ensure_env().group(self.axes)

    @property
    def ranks(self) -> list:
        return list(self._pair()[0])

    @property
    def nranks(self) -> int:
        return len(self._pair()[0])

    world_size = nranks

    @property
    def rank(self) -> int:
        return self.get_group_rank(dist.get_rank())

    def get_group_rank(self, rank):
        """``rank``'s (a global rank) place in the group, -1 if it is not
        a member."""
        ranks = self._pair()[0]
        return ranks.index(rank) if rank in ranks else -1

    def __repr__(self):
        return f"Group(name={self.name!r}, ranks={self.ranks})"


def _world_group() -> Group:
    return Group(env_mod.AXIS_ORDER, name="world")


def get_group(group=None) -> Group:
    """``None``: every rank; a :class:`Group`; an axis name or a tuple of
    them."""
    if group is None:
        return _world_group()
    if isinstance(group, Group):
        return group
    return Group((group,) if isinstance(group, str) else tuple(group))


def new_group(ranks=None, backend=None, timeout=None, axes=None, name=None):
    """A group over mesh ``axes``, or over ``ranks`` (global ranks; like
    ``torch.distributed.new_group``, every rank must make it, members
    or not). ``ranks`` of every rank, or None, is the world."""
    if axes is not None:
        return Group(env_mod._canon(axes), name)
    env = env_mod.ensure_env()
    if ranks is None or sorted(ranks) == list(range(env.world_size)):
        return _world_group()
    kw = {} if timeout is None else {"timeout": timeout}
    pg = dist.new_group(sorted(ranks), backend=backend, **kw)
    return Group(name=name, ranks=sorted(ranks), pg=pg)


def _pair(group):
    return get_group(group)._pair()


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce ``tensor`` over the group in place (``AVG``: the sum over
    the group size); returns it."""
    pair = _pair(group)
    if op == ReduceOp.AVG:
        _comm.all_reduce(tensor, pair)
        return tensor.div_(len(pair[0]))
    return _comm.all_reduce(tensor, pair, _TORCH_OP[op])


def all_gather(tensor_or_list, tensor=None, group=None, sync_op=True,
               axis=0):
    """``all_gather(tensor_list, tensor)`` appends every member's tensor
    to ``tensor_list``; ``all_gather(tensor)`` returns them concatenated
    along ``axis``."""
    pair = _pair(group)
    if isinstance(tensor_or_list, list) and tensor is not None:
        tensor_or_list.extend(_comm.all_gather_list(tensor, pair))
        return tensor_or_list
    return _comm.all_gather(tensor_or_list, axis, pair)


def broadcast(tensor, src=0, group=None, sync_op=True):
    """``src``'s tensor on every member, in place."""
    _comm.run(dist.broadcast, tensor, _pair(group), tensor, src=src)
    return tensor


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """The reduction, left on every member (the reference's reading)."""
    return all_reduce(tensor, op=op, group=group)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Member ``i`` receives ``src``'s ``tensor_list[i]`` into ``tensor``;
    without a list, member ``i`` receives chunk ``i`` of ``src``'s
    ``tensor`` along dim 0, returned as a new tensor (the reference's
    form)."""
    pair = _pair(group)
    me = dist.get_rank()
    if tensor_list is None:
        chunks = [c.contiguous() for c in tensor.chunk(len(pair[0]), 0)]
        out = torch.empty_like(chunks[0])
        _comm.run(dist.scatter, out, pair, out,
                  chunks if me == src else None, src=src)
        return out
    _comm.run(dist.scatter, tensor, pair, tensor,
              [t.contiguous() for t in tensor_list] if me == src else None,
              src=src)
    return tensor


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """Every member's tensor, on every member (the reference delivers
    it everywhere; ``dst`` is advisory). Replaces ``gather_list``'s
    items."""
    parts = all_gather([], tensor, group=group)
    if gather_list is None:
        gather_list = []
    gather_list[:] = parts
    return gather_list


def reduce_scatter(tensor, op=ReduceOp.SUM, group=None, sync_op=True,
                   axis=0):
    """This member's chunk along ``axis`` of the group's reduction of
    ``tensor`` (sum, or ``op``)."""
    pair = _pair(group)
    if op == ReduceOp.SUM:
        return _comm.reduce_scatter_raw(tensor, axis, pair)
    red = all_reduce(tensor.clone(), op=op, group=group)
    return _comm.chunk_of(red, axis, pair).contiguous()


def _staged(t, pair):
    """Whether ``t`` crosses the group through the host: a CUDA tensor
    on a gloo group, which gloo's point-to-point and all-to-all read as
    host memory."""
    return t.is_cuda and dist.get_backend(pair[1]) == "gloo"


def _all_to_all_list(ins, pair):
    """Member ``j`` receives every member's ``ins[j]``, in member order
    (CUDA tensors staged through the host on gloo). Gloo has no list
    all-to-all on every torch version, so there chunks of one shape go
    as one ``all_to_all_single`` over their stack."""
    ins = [t.contiguous() for t in ins]
    staged = _staged(ins[0], pair)
    if dist.get_backend(pair[1]) == "gloo" and all(
            t.shape == ins[0].shape and t.dtype == ins[0].dtype
            for t in ins):
        x = torch.stack(ins)
        sent = x.cpu() if staged else x
        out = torch.empty_like(sent)
        _comm.run(dist.all_to_all_single, x, pair, out, sent)
        return list((out.to(x.device) if staged else out).unbind(0))
    sent = [t.cpu() for t in ins] if staged else ins
    outs = [torch.empty_like(t) for t in sent]
    _comm.run(dist.all_to_all, ins[0], pair, outs, sent)
    return [o.to(ins[0].device) for o in outs] if staged else outs


def all_to_all(out_tensor_list, in_tensor_list=None, group=None,
               sync_op=True, split_axis=0, concat_axis=0):
    """``all_to_all(out_list, in_list)``: member ``j`` receives every
    member's ``in_list[j]``, in member order. ``all_to_all(x,
    split_axis=, concat_axis=)``: ``x`` split into the group's count of
    chunks along ``split_axis``, chunk ``j`` sent to member ``j``, and
    the chunks received concatenated along ``concat_axis`` (the
    reference's tiled ``jax.lax.all_to_all`` on this rank's shard)."""
    pair = _pair(group)
    if isinstance(out_tensor_list, list) and in_tensor_list is not None:
        out_tensor_list.extend(_all_to_all_list(in_tensor_list, pair))
        return out_tensor_list
    x = out_tensor_list
    outs = _all_to_all_list(x.chunk(len(pair[0]), split_axis), pair)
    return torch.cat(outs, dim=concat_axis)


alltoall = all_to_all


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """The single-tensor all-to-all over equal splits of dim 0, into
    ``out_tensor`` (or a new tensor). Uneven splits raise, as in the
    reference."""
    if in_split_sizes is not None or out_split_sizes is not None:
        raise NotImplementedError(
            "alltoall_single with uneven split sizes is not supported "
            "(the reference refuses them too); pad to equal splits")
    out = torch.empty_like(in_tensor) if out_tensor is None else out_tensor
    _comm.run(dist.all_to_all_single, out, _pair(group), out,
              in_tensor.contiguous())
    return out


def ppermute(tensor, perm, group=None):
    """``jax.lax.ppermute`` on ranks: ``perm`` holds ``(source, dest)``
    pairs of group ranks; this member's tensor goes to its dest and what
    its source sends comes back (zeros when none does). One batch of
    ``P2POp``\\ s (:func:`p2p`); a pair onto itself is a copy."""
    pair = _pair(group)
    me = pair[0].index(dist.get_rank())
    dests = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    if len(dests) > 1 or len(srcs) > 1:
        raise ValueError(f"perm {perm} is not a permutation")
    out = torch.zeros_like(tensor)
    if srcs and srcs[0] == me:
        out.copy_(tensor)
    p2p([(tensor, dests[0])] if dests and dests[0] != me else [],
        [(out, srcs[0])] if srcs and srcs[0] != me else [], pair)
    return out


def p2p(sends, recvs, group=None):
    """One batch of point-to-point transfers: each ``(tensor, dest)`` of
    ``sends`` goes to group rank ``dest``, each ``(buffer, src)`` of
    ``recvs`` is filled in place from group rank ``src``; returns when
    all are done. The peers must post the matching transfers in the
    same order. ``group`` as the collectives take it, or a ``(ranks,
    process group)`` pair. On gloo, CUDA tensors go through the host."""
    pair = group if isinstance(group, tuple) and group \
        and isinstance(group[0], list) else _pair(group)
    ranks, pg = pair
    if not sends and not recvs:
        return
    first = (sends or recvs)[0][0]
    staged = _staged(first, pair)
    ops, back = [], []
    for t, dest in sends:
        t = t.contiguous()
        ops.append(dist.P2POp(dist.isend, t.cpu() if staged else t,
                              ranks[dest], pg))
    for buf, src in recvs:
        got = torch.empty(buf.shape, dtype=buf.dtype) if staged \
            or not buf.is_contiguous() else buf
        ops.append(dist.P2POp(dist.irecv, got, ranks[src], pg))
        if got is not buf:
            back.append((buf, got))
    _comm.run(_exchange, first, pair, ops)
    for buf, got in back:
        buf.copy_(got)


def _exchange(ops, group):
    """Run a batch of ``P2POp``\\ s (each names its group) to the end."""
    for work in dist.batch_isend_irecv(ops):
        work.wait()


def send(tensor, dst=0, group=None, sync_op=True):
    raise NotImplementedError(
        "point-to-point send/recv is not a collective of this package "
        "(the reference refuses it too); use ppermute")


recv = send


def isend(tensor, dst=0, group=None):
    return send(tensor, dst, group)


def irecv(tensor, src=0, group=None):
    return recv(tensor, src, group)


def barrier(group=None):
    """Every member reaches this point before any goes on."""
    _comm.run(dist.barrier, None, _pair(group))


def wait(tensor, group=None, use_calc_stream=True):
    """Wait for the device work on ``tensor``."""
    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.synchronize(tensor.device)


def all_gather_object(object_list, obj, group=None):
    """Every member's ``obj``, appended in member order."""
    pair = _pair(group)
    out = [None] * len(pair[0])
    _comm.run(dist.all_gather_object, None, pair, out, obj)
    object_list.extend(out)
    return object_list


def broadcast_object_list(object_list, src=0, group=None):
    """``src``'s objects in ``object_list`` on every member, in place."""
    _comm.run(dist.broadcast_object_list, None, _pair(group), object_list,
              src=src)
    return object_list


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    """Member ``i`` appends ``src``'s ``in_object_list[i]``."""
    pair = _pair(group)
    n = len(pair[0])
    if dist.get_rank() == src and (in_object_list is None
                                   or len(in_object_list) != n):
        raise ValueError(f"in_object_list must have nranks={n} entries")
    got = [None]
    _comm.run(dist.scatter_object_list, None, pair, got,
              in_object_list if dist.get_rank() == src else None, src=src)
    out_object_list.append(got[0])
    return out_object_list


def destroy_process_group(group=None):
    """``None``: tear down the mesh and the world process group; a
    group made by :func:`new_group` with ``ranks``: destroy it."""
    if group is None:
        env_mod.reset_env()
        if dist.is_initialized():
            dist.destroy_process_group()
        return None
    g = get_group(group)
    if g._ranks is not None and g._pg is not None:
        dist.destroy_process_group(g._pg)
        g._pg = None
    return None


def get_backend(group=None):
    """The group's backend: ``"nccl"`` or ``"gloo"``."""
    return str(dist.get_backend(_pair(group)[1]))


def is_available():
    return dist.is_available()
