"""Group-sharded data parallelism (ZeRO stages 1-3).

Counterpart of ``paddle_tpu/distributed/sharding/group_sharded.py``.
There ZeRO is a layout: the states (and under ``p_g_os`` the
parameters) are placed sharded over a mesh axis and GSPMD partitions the
update and inserts the gathers. With one process per rank the port runs
the stages Paddle runs:

- the slice of a tensor is its first dim that the axis's degree divides
  (``_sharded_put``'s choice); a tensor no dim of which divides stays
  whole on every rank. Each slice records a ``shard.Layout``
  (``_zero_layout``), so the clips and Lamb's trust ratio take global
  norms (``shard.global_sq_norms``);
- the axis is ``sharding`` when its degree is > 1, else ``dp``, else
  none, and then ZeRO returns the model and optimizer as they are;
- the batch is split over ``dp x sharding`` (Paddle's sharding ranks
  are data-parallel ranks; ``fleet.batch_axes``), and the losses divide
  by the global count, so the summed gradient is the reference's;
- ``os``: each backward's gradients are all-reduced over the batch
  group; each rank updates its slice of the parameter, of the fp32
  master and of the moments, and the parameter is all-gathered;
- ``os_g``: as ``os``, but each gradient is reduce-scattered over the
  axis (then all-reduced over dp when the axis is ``sharding``) into
  the rank's slice, and the whole gradient is dropped;
- ``p_g_os``: each rank keeps only its slice of each parameter
  (``_dist_layout``, so ``load_jax_weights`` cuts and
  ``gather_jax_layout`` gathers). Before a layer's forward (each module
  of an ``nn.ModuleList``, and the model for the rest) its slices are
  all-gathered, and they are dropped after it; autograd keeps no copy
  of a gathered weight (a saved-tensor hook records the slice and
  gathers it again when the backward needs it). The gradient comes
  back reduce-scattered;
- ``offload=True``: masters and moments are kept in pinned host memory
  (in plain CPU memory when the parameters are on the CPU, where
  pinning needs CUDA: the reference degrades the same way), and each
  parameter's are staged to its device just before its own update and
  dropped there just after it, so the device holds one parameter's at a
  time (``Optimizer._offload_state``).

The optimizer's ``state_dict`` gathers the slices whole and
``set_state_dict`` cuts them again. A parameter that already has a
layout (a tensor-parallel weight, an expert over dp) has no room for a
second axis (``shard.Layout``), so ZeRO under mp > 1 or pp > 1, and of
an MoE model, raises. Do not also wrap the model in ``DataParallel``:
ZeRO sums the gradients itself.
"""
from __future__ import annotations

import os

import torch
from torch import nn

from .. import _comm
from .. import env as env_mod
from ..parallel import _sync_gradients
from ..shard import Layout, gather_global, set_layout

__all__ = ["group_sharded_parallel", "save_group_sharded_model"]


def _shard_axis():
    env = env_mod.get_env()
    if env is None:
        return None
    if env.degree("sharding") > 1:
        return "sharding"
    if env.degree("dp") > 1:
        return "dp"
    return None


def _shard_dim(shape, n):
    """The first dim of ``shape`` that ``n`` divides, or None."""
    for d, size in enumerate(shape):
        if size > 0 and size % n == 0:
            return d
    return None


def _host_put(t):
    """Offload's placement: a pinned host copy of a CUDA tensor; a CPU
    tensor as it is."""
    if not t.is_cuda:
        return t
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return h.copy_(t)


class _Regather:
    """What autograd keeps of a gathered parameter: its slice."""
    __slots__ = ("piece", "dim")

    def __init__(self, piece, dim):
        self.piece, self.dim = piece, dim


class _GatherParam(torch.autograd.Function):
    """The whole parameter from the axis's slices; the backward
    reduce-scatters the gradient over the axis and sums it over dp."""

    @staticmethod
    def forward(ctx, piece, dim, shard, dp):
        ctx.dim, ctx.shard, ctx.dp = dim, shard, dp
        return _comm.all_gather(piece, dim, shard)

    @staticmethod
    def backward(ctx, g):
        part = _comm.reduce_scatter_raw(g.contiguous(), ctx.dim, ctx.shard)
        if ctx.dp is not None:
            _comm.all_reduce(part, ctx.dp)
        return part, None, None, None


class _Plan:
    """One ZeRO setup: its level, groups and slices (``layouts``: id of
    a parameter -> its slice's ``Layout``), and under ``os_g`` each
    parameter's reduced gradient slice."""

    def __init__(self, level, axis, model, params):
        env = env_mod.ensure_env()
        self.level = level
        self.shard = env.group(axis)
        self.n = len(self.shard[0])
        self.rank = self.shard[0].index(env.rank)
        self.dp = env.group("dp") \
            if axis == "sharding" and env.degree("dp") > 1 else None
        self.batch = env.group(("dp", "sharding") if axis == "sharding"
                               else "dp")
        self.layouts = {}
        self.grads = {}
        for p in params:
            d = _shard_dim(p.shape, self.n)
            if d is not None:
                lay = Layout(axis, d, ((p.shape[d], True),), tuple(p.shape))
                self.layouts[id(p)] = lay
                p._zero_layout = lay
        whole = [p for p in params if id(p) not in self.layouts]
        sliced = [p for p in params if id(p) in self.layouts]
        self.handles = _sync_gradients(
            params if level == "os" else whole, self.batch)
        if level == "os_g":
            for p in sliced:
                self.handles.append(p.register_post_accumulate_grad_hook(
                    self._reduce))
        if level == "p_g_os":
            self._stage3(model, sliced)

    # -- slices ---------------------------------------------------------------

    def view(self, t):
        """``t``'s slice (a view), by its shape; ``t`` if it has none."""
        d = _shard_dim(t.shape, self.n)
        if d is None:
            return t
        k = t.shape[d] // self.n
        return t.narrow(d, self.rank * k, k)

    def part(self, t):
        """The part of a parameter-shaped ``t`` this rank updates: its
        slice's view under ``os`` and ``os_g``; ``t`` under ``p_g_os``,
        where a parameter is its slice already."""
        return t if self.level == "p_g_os" else self.view(t)

    def cut(self, p, t):
        """``p``'s slice of a whole state or master ``t`` (a copy)."""
        lay = self.layouts.get(id(p))
        if lay is None or tuple(t.shape) != lay.shape:
            return t
        return self.view(t).clone()

    def full(self, p, v):
        """The whole tensor of ``p``'s state or master slice ``v`` (a
        copy; collective over the axis)."""
        lay = self.layouts.get(id(p))
        if lay is None:
            return v.detach().clone()
        return gather_global(v.detach().to(p.device).contiguous(), lay)

    # -- gradients and the update --------------------------------------------

    def _reduce(self, p):
        """``os_g``: the gradient a backward accumulated, reduce-scattered
        over the axis (and summed over dp) into this rank's slice; the
        whole gradient dropped."""
        g, p.grad = p.grad, None
        lay = self.layouts[id(p)]
        part = _comm.reduce_scatter_raw(g.contiguous(), lay.dim, self.shard)
        if self.dp is not None:
            _comm.all_reduce(part, self.dp)
        held = self.grads.get(id(p))
        self.grads[id(p)] = part if held is None else held.add_(part)

    def params_grads(self, params):
        """``(param, this rank's gradient slice)`` for each trainable
        parameter with a gradient (a whole one where it has no slice)."""
        out = []
        for p in params:
            if not p.requires_grad:
                continue
            sliced = id(p) in self.layouts
            if self.level == "os_g" and sliced:
                g = self.grads.get(id(p))
            elif self.level == "os" and sliced and p.grad is not None:
                g = self.view(p.grad)
            else:
                g = p.grad
            if g is not None:
                out.append((p, g))
        return out

    def clear_grads(self, set_to_zero=False):
        if set_to_zero:
            for g in self.grads.values():
                g.zero_()
        else:
            self.grads.clear()

    @torch.no_grad()
    def publish(self, params):
        """``os``/``os_g``: each updated parameter all-gathered from its
        slices."""
        if self.level == "p_g_os":
            return
        for p in params:
            lay = self.layouts.get(id(p))
            if lay is not None:
                p.copy_(_comm.all_gather(self.view(p.detach()).contiguous(),
                                         lay.dim, self.shard))

    # -- p_g_os -----------------------------------------------------------------

    def _stage3(self, model, sliced):
        """Keep only each parameter's slice, and gather the slices of
        each unit (a module of an ``nn.ModuleList``, or the model for the
        parameters under none) around its forward."""
        with torch.no_grad():
            for p in sliced:
                lay = self.layouts[id(p)]
                p.data = self.view(p.data).clone()
                set_layout(p, lay.axis, lay.dim, lay.segments, lay.shape)
        mine = {id(p) for p in sliced}
        self.units = {}  # unit -> [(owner, name, param)]

        def walk(mod, unit):
            for name, p in mod._parameters.items():
                if p is not None and id(p) in mine:
                    self.units.setdefault(unit, []).append((mod, name, p))
            for child in mod.children():
                walk(child, child if isinstance(mod, nn.ModuleList)
                     else unit)

        walk(model, model)
        self.installed = {}  # id(whole) -> (whole, slice)
        self.scopes = []
        for unit in self.units:
            self.handles.append(unit.register_forward_pre_hook(
                lambda m, args: self._enter(m)))
            self.handles.append(unit.register_forward_hook(
                lambda m, args, out: self._exit(m)))

    def _enter(self, unit):
        scope = torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                         self._unpack)
        scope.__enter__()
        self.scopes.append(scope)
        for owner, name, p in self.units[unit]:
            whole = _GatherParam.apply(p, p._dist_layout.dim, self.shard,
                                       self.dp)
            owner.__dict__[name] = whole  # found before _parameters
            self.installed[id(whole)] = (whole, p)

    def _exit(self, unit):
        for owner, name, _ in self.units[unit]:
            del self.installed[id(owner.__dict__.pop(name))]
        self.scopes.pop().__exit__(None, None, None)

    def _pack(self, t):
        hit = self.installed.get(id(t))
        if hit is not None and hit[0] is t:
            return _Regather(hit[1], hit[1]._dist_layout.dim)
        return t

    def _unpack(self, x):
        if not isinstance(x, _Regather):
            return x
        with torch.no_grad():
            return _comm.all_gather(x.piece.detach(), x.dim, self.shard)


def group_sharded_parallel(model, optimizer, level="p_g_os", scaler=None,
                           group=None, offload=False, sync_buffers=False,
                           buffer_max_size=2**23, segment_size=2**20,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None):
    """Shard ``optimizer``'s states (``os``), and its gradients
    (``os_g``), and the model's parameters (``p_g_os``) over the
    ``sharding`` axis (``dp`` when sharding is 1); see the module note.
    Returns ``(model, optimizer, scaler)`` as the reference does. The
    reducer's and the buffers' knobs are accepted and not read."""
    if level not in ("os", "os_g", "p_g_os"):
        raise ValueError("level must be os, os_g or p_g_os")
    axis = _shard_axis()
    if axis is None:
        return model, optimizer, scaler
    env = env_mod.ensure_env()
    if env.degree("mp") > 1 or env.degree("pp") > 1:
        raise NotImplementedError(
            "group_sharded_parallel under mp > 1 or pp > 1 is not ported "
            "(ROADMAP A.6): a tensor-parallel or pipelined parameter has "
            "no room for a second sharded axis")
    if not isinstance(model, nn.Module):
        raise TypeError("group_sharded_parallel takes the model itself, "
                        "not its DataParallel wrapper")
    params = [p for p in optimizer._parameter_list if p.requires_grad]
    if any(getattr(p, "_dist_layout", None) is not None for p in params):
        raise NotImplementedError(
            "group_sharded_parallel of a model with laid-out parameters "
            "(experts over dp) is not ported (ROADMAP A.6)")
    # states made before ZeRO: cut to this rank's slices
    old = (dict(optimizer._accumulators), dict(optimizer._master_weights))
    plan = _Plan(level, axis, model, params)
    optimizer._zero = plan
    if offload:
        optimizer._initial_state_placement = _host_put
    by_id = {id(p): p for p in params}
    for key, st in old[0].items():
        optimizer._accumulators[key] = {
            k: optimizer._keep(plan.cut(by_id[key], v))
            for k, v in st.items()}
    for key, m in old[1].items():
        optimizer._master_weights[key] = optimizer._keep(
            plan.cut(by_id[key], m))
    return model, optimizer, scaler


def _whole_state(model):
    """The model's ``state_dict`` with every sliced parameter gathered
    whole (collective)."""
    out = {}
    for name, t in model.state_dict(keep_vars=True).items():
        lay = getattr(t, "_dist_layout", None)
        out[name] = (t.detach() if lay is None
                     else gather_global(t.detach(), lay)).clone()
    return out


def save_group_sharded_model(model, output, optimizer=None):
    """Write ``output/model.pdparams`` (and ``model.pdopt`` with
    ``optimizer``) as whole tensors in the reference's format
    (``framework.io``), from global rank 0. Collective: every rank calls
    it."""
    from ...framework.io import save

    state = _whole_state(model)
    opt = optimizer.state_dict() if optimizer is not None else None
    if env_mod.ensure_env().rank != 0:
        return
    os.makedirs(output, exist_ok=True)
    save(state, os.path.join(output, "model.pdparams"))
    if opt is not None:
        save(opt, os.path.join(output, "model.pdopt"))
