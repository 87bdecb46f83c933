"""Group-sharded data parallelism (ZeRO stages 1-3).

Counterpart of ``paddle_tpu/distributed/sharding/group_sharded.py``.
There ZeRO is a layout: the states (and under ``p_g_os`` the
parameters) are placed sharded over a mesh axis and GSPMD partitions the
update and inserts the gathers. With one process per rank the port runs
the stages Paddle runs:

- the slice of a tensor is its first dim that its layer names no axis on
  (whatever that axis's degree: ``shard.annotate``) and whose *global*
  size the axis's degree divides (``_sharded_put``'s choice); a tensor
  no such dim of which exists stays whole on every rank, and one
  already laid out over the axis (an expert over dp under ZeRO over dp)
  is left as it is. The slice is cut from the rank's tensor-parallel
  piece, so a weight at mp 2 x sharding 2 holds a quarter. Each slice
  records a ``shard.Layout`` of both cuts (``_zero_layout``), so the
  clips and Lamb's trust ratio take global norms
  (``shard.global_sq_norms``);
- the axis is ``sharding`` when its degree is > 1, else ``dp``, else
  none, and then ZeRO returns the model and optimizer as they are;
- the batch is split over ``dp x sharding`` (Paddle's sharding ranks
  are data-parallel ranks; ``fleet.batch_axes``), and the losses divide
  by the global count, so the summed gradient is the reference's. The
  sums tensor parallelism needs (a replicated parameter's over mp under
  SP, the replicated K/V columns') run inside the model's backward, as
  without ZeRO; ZeRO's sums come on top of them. A parameter is never
  summed over an axis its layout cuts (an expert over dp);
- ``os``: each backward's gradients are all-reduced over the batch
  group; each rank updates its slice of the parameter, of the fp32
  master and of the moments, and the parameter is all-gathered;
- ``os_g``: as ``os``, but each gradient is reduce-scattered over the
  axis (then all-reduced over the rest of the batch group) into the
  rank's slice, and the whole gradient is dropped;
- ``p_g_os``: each rank keeps only its slice of each parameter
  (``_dist_layout``, so ``load_jax_weights`` cuts and
  ``gather_jax_layout`` gathers). Before a layer's forward (each module
  of an ``nn.ModuleList`` or of a ``PipelineLayer`` stage, and the
  model for the rest) its slices are all-gathered over the axis alone,
  giving the rank's tensor-parallel piece, and they are dropped after
  it; autograd keeps no copy of a gathered weight (a saved-tensor hook
  records the slice and gathers it again when the backward needs it,
  so under 1F1B no gathered copy outlives its microbatch's forward).
  The gradient comes back reduce-scattered;
- ``offload=True``: masters and moments are kept in pinned host memory
  (in plain CPU memory when the parameters are on the CPU, where
  pinning needs CUDA: the reference degrades the same way), and each
  parameter's are staged to its device just before its own update and
  dropped there just after it, so the device holds one parameter's at a
  time (``Optimizer._offload_state``).

The optimizer's ``state_dict`` gathers the slices whole (over the axis,
then over mp) and ``set_state_dict`` cuts them again. Under pp each
stage's optimizer shards its own parameters; ``PipelineParallel``
leaves the batch sums to ZeRO's hooks and sums a shared weight's
gradient over its stages on the slice. Do not also wrap the model in
``DataParallel``: ZeRO sums the gradients itself.
"""
from __future__ import annotations

import itertools
import os

import torch
from torch import nn

from .. import _comm
from .. import env as env_mod
from ..fleet import batch_axes
from ..fleet.meta_parallel.parallel_layers.pp_layers import PipelineLayer
from ..parallel import _batch_sums, _sync_gradients
from ..shard import (
    add_cut, gather_global, grad_layout, local_piece, set_layout,
)

__all__ = ["group_sharded_parallel", "save_group_sharded_model"]

# the axes whose cuts a global norm may sum over
_CUT_AXES = ("dp", "sharding", "sep", "mp")


def _shard_axis():
    env = env_mod.get_env()
    if env is None:
        return None
    if env.degree("sharding") > 1:
        return "sharding"
    if env.degree("dp") > 1:
        return "dp"
    return None


def _zero_dim(p, n):
    """The dim ZeRO cuts ``p`` on: the first one that its layer names no
    axis on and whose global size ``n`` divides; None."""
    lay = getattr(p, "_dist_layout", None)
    shape = lay.shape if lay is not None else tuple(p.shape)
    taken = getattr(p, "_axis_dims", frozenset())
    for d, size in enumerate(shape):
        if d not in taken and size > 0 and size % n == 0:
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
    """The rank's tensor-parallel piece of a parameter from the axis's
    slices; the backward reduce-scatters the gradient over the axis and
    sums it over ``rest`` (the batch axes the parameter is replicated
    on besides the axis)."""

    @staticmethod
    def forward(ctx, piece, dim, shard, rest):
        ctx.dim, ctx.shard, ctx.rest = dim, shard, rest
        return _comm.all_gather(piece, dim, shard)

    @staticmethod
    def backward(ctx, g):
        part = _comm.reduce_scatter_raw(g.contiguous(), ctx.dim, ctx.shard)
        if ctx.rest is not None:
            _comm.all_reduce(part, ctx.rest)
        return part, None, None, None


class _Plan:
    """One ZeRO setup: its level, groups and slices (``layouts``: id of
    a parameter -> its slice's ``Layout``, ``dims``: -> the dim ZeRO
    cuts, ``rest``: -> the group its gradient slice is summed over
    besides the axis, or None), and under ``os_g`` each parameter's
    reduced gradient slice."""

    def __init__(self, level, axis, model, params):
        env = env_mod.ensure_env()
        self.level = level
        # every group a sum below or a global norm may use, made in one
        # order on every rank (a pipeline stage holds other parameters)
        live = [a for a in _CUT_AXES if env.degree(a) > 1]
        for k in range(1, len(live) + 1):
            for sub in itertools.combinations(live, k):
                env.group(sub)
        self.shard = env.group(axis)
        self.n = len(self.shard[0])
        self.rank = self.shard[0].index(env.rank)
        batch = batch_axes(getattr(model, "config", None))
        self.layouts, self.dims, self.rest = {}, {}, {}
        self.grads = {}
        for p in params:
            lay = getattr(p, "_dist_layout", None)
            if lay is not None and axis in lay.axes:
                continue  # laid out over the axis already
            d = _zero_dim(p, self.n)
            if d is None:
                continue
            z = add_cut(lay, axis, d, p.shape)
            self.layouts[id(p)], self.dims[id(p)] = z, d
            rest = tuple(a for a in batch if a not in z.axes)
            self.rest[id(p)] = env.group(rest) \
                if rest and len(env.group(rest)[0]) > 1 else None
            p._zero_layout = z
        whole = [p for p in params if id(p) not in self.layouts]
        sliced = [p for p in params if id(p) in self.layouts]
        self.handles = []
        for pair, ps in _batch_sums(params if level == "os" else whole,
                                    batch):
            self.handles += _sync_gradients(ps, pair)
        if level == "os_g":
            for p in sliced:
                self.handles.append(p.register_post_accumulate_grad_hook(
                    self._reduce))
        if level == "p_g_os":
            self._stage3(model, sliced)

    # -- slices ---------------------------------------------------------------

    def view(self, p, t):
        """The slice (a view) of ``t``, shaped as ``p``'s tensor-parallel
        piece; ``t`` when ZeRO does not cut ``p``."""
        d = self.dims.get(id(p))
        if d is None:
            return t
        k = t.shape[d] // self.n
        return t.narrow(d, self.rank * k, k)

    def part(self, p, t):
        """The part of ``p``-shaped ``t`` this rank updates: its slice's
        view under ``os`` and ``os_g``; ``t`` under ``p_g_os``, where a
        parameter is its slice already."""
        return t if self.level == "p_g_os" else self.view(p, t)

    def cut(self, p, t):
        """``p``'s part of a whole (global) state or master ``t`` (a
        copy): this rank's slice, or its tensor-parallel piece."""
        lay = grad_layout(p)
        if lay is None or tuple(t.shape) != lay.shape:
            return t
        return local_piece(t, lay).clone()

    def full(self, p, v):
        """The whole (global) tensor of ``p``'s state or master ``v`` (a
        copy; collective over the axis, then over mp)."""
        lay = grad_layout(p)
        if lay is None:
            return v.detach().clone()
        return gather_global(v.detach().to(p.device).contiguous(), lay)

    # -- gradients and the update --------------------------------------------

    def _reduce(self, p):
        """``os_g``: the gradient a backward accumulated, reduce-scattered
        over the axis (and summed over the rest of the batch group) into
        this rank's slice; the whole gradient dropped."""
        g, p.grad = p.grad, None
        part = _comm.reduce_scatter_raw(g.contiguous(), self.dims[id(p)],
                                        self.shard)
        if self.rest[id(p)] is not None:
            _comm.all_reduce(part, self.rest[id(p)])
        held = self.grads.get(id(p))
        self.grads[id(p)] = part if held is None else held.add_(part)

    def holds_grad(self, p):
        """Whether ``p``'s gradient lives here (``os_g``'s slices), not
        on ``p.grad``."""
        return self.level == "os_g" and id(p) in self.dims

    def sum_grad(self, p, group):
        """Sum the gradient slice held for ``p`` over ``group`` (a shared
        weight's stages)."""
        g = self.grads.get(id(p))
        if g is None:
            g = self.view(p, torch.zeros_like(p)).contiguous()
        self.grads[id(p)] = _comm.all_reduce(g, group)

    def params_grads(self, params):
        """``(param, this rank's gradient slice)`` for each trainable
        parameter with a gradient (a whole one where it has no slice)."""
        out = []
        for p in params:
            if not p.requires_grad:
                continue
            sliced = id(p) in self.dims
            if self.level == "os_g" and sliced:
                g = self.grads.get(id(p))
            elif self.level == "os" and sliced and p.grad is not None:
                g = self.view(p, p.grad)
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
            d = self.dims.get(id(p))
            if d is not None:
                p.copy_(_comm.all_gather(self.view(p, p.detach())
                                         .contiguous(), d, self.shard))

    # -- p_g_os -----------------------------------------------------------------

    def _stage3(self, model, sliced):
        """Keep only each parameter's slice, and gather the slices of
        each unit (a module of an ``nn.ModuleList`` or of a
        ``PipelineLayer``, or the model for the parameters under none)
        around its forward."""
        with torch.no_grad():
            for p in sliced:
                p.data = self.view(p, p.data).clone()
                set_layout(p, self.layouts[id(p)])
        mine = {id(p) for p in sliced}
        self.units = {}  # unit -> [(owner, name, param)]

        def walk(mod, unit):
            for name, p in mod._parameters.items():
                if p is not None and id(p) in mine:
                    self.units.setdefault(unit, []).append((mod, name, p))
            for child in mod.children():
                walk(child, child if isinstance(
                    mod, (nn.ModuleList, PipelineLayer)) else unit)

        walk(model, model)
        self.installed = {}  # id(whole) -> (whole, slice)
        self.scopes = {}  # unit -> (depth, saved-tensor scope)
        for unit in self.units:
            self.handles.append(unit.register_forward_pre_hook(
                lambda m, args: self._enter(m)))
            self.handles.append(unit.register_forward_hook(
                lambda m, args, out: self._exit(m)))
        if isinstance(model, PipelineLayer):
            # a shared layer's occurrence with a forward_func runs without
            # calling the layer: gather around that call too
            for idx, run in list(model._run.items()):
                unit = model._modules[str(idx)]
                if run is not unit and unit in self.units:
                    model._run[idx] = self._around(unit, run)

    def _around(self, unit, run):
        def call(x):
            self._enter(unit)
            try:
                return run(x)
            finally:
                self._exit(unit)
        return call

    def _enter(self, unit):
        depth, scope = self.scopes.get(unit, (0, None))
        if depth:  # already gathered (a forward_func calling its layer)
            self.scopes[unit] = (depth + 1, scope)
            return
        scope = torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                         self._unpack)
        scope.__enter__()
        self.scopes[unit] = (1, scope)
        for owner, name, p in self.units[unit]:
            whole = _GatherParam.apply(p, self.dims[id(p)], self.shard,
                                       self.rest[id(p)])
            owner.__dict__[name] = whole  # found before _parameters
            self.installed[id(whole)] = (whole, p)

    def _exit(self, unit):
        depth, scope = self.scopes[unit]
        if depth > 1:
            self.scopes[unit] = (depth - 1, scope)
            return
        del self.scopes[unit]
        for owner, name, _ in self.units[unit]:
            del self.installed[id(owner.__dict__.pop(name))]
        scope.__exit__(None, None, None)

    def _pack(self, t):
        hit = self.installed.get(id(t))
        if hit is not None and hit[0] is t:
            return _Regather(hit[1], self.dims[id(hit[1])])
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
    ``model`` may be a ``PipelineParallel`` (its stage's layers are
    sharded). Returns ``(model, optimizer, scaler)`` as the reference
    does. The reducer's and the buffers' knobs are accepted and not
    read."""
    if level not in ("os", "os_g", "p_g_os"):
        raise ValueError("level must be os, os_g or p_g_os")
    axis = _shard_axis()
    if axis is None:
        return model, optimizer, scaler
    from ..fleet.meta_parallel.pipeline_parallel import PipelineParallel

    given = model
    if isinstance(model, PipelineParallel):
        model = model._layers
    if not isinstance(model, nn.Module):
        raise TypeError("group_sharded_parallel takes the model itself, "
                        "not its DataParallel wrapper")
    params = [p for p in optimizer._parameter_list if p.requires_grad]
    # states made before ZeRO: cut to this rank's slices
    old = (dict(optimizer._accumulators), dict(optimizer._master_weights))
    plan = _Plan(level, axis, model, params)
    optimizer._zero = plan
    if offload:
        optimizer._initial_state_placement = _host_put
    by_id = {id(p): p for p in params}
    for key, st in old[0].items():
        optimizer._accumulators[key] = {
            k: optimizer._keep(plan.view(by_id[key], v).clone())
            for k, v in st.items()}
    for key, m in old[1].items():
        optimizer._master_weights[key] = optimizer._keep(
            plan.view(by_id[key], m).clone())
    return given, optimizer, scaler


def _whole_state(model):
    """The model's ``state_dict`` with every sliced parameter gathered
    whole (collective: over the axis, then over mp)."""
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
