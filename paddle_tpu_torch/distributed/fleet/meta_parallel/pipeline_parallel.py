"""The pipeline-parallel training driver.

Counterpart of ``paddle_tpu/distributed/fleet/meta_parallel/
pipeline_parallel.py``. The reference compiles its schedule into one
XLA program; here, as in Paddle, the host drives it: each rank runs its
own stage (``PipelineLayer`` builds only that) over the microbatches,
and the boundary activations and their gradients cross between stages
as point-to-point transfers (``collective.p2p``: one batch of
``P2POp``\\ s, through ``_comm.run``, so counted, and host-staged for
CUDA tensors on gloo).

The schedule is worked out on every rank alike, as lock-step ticks:
each tick a stage runs at most one step, forward or backward of one
microbatch on one of its chunks, once what it needs has arrived, and
then the ticks' transfers are made, each between its two ranks. Three
orders of the steps:

- F-then-B (GPipe), the default: every forward, then every backward;
- 1F1B (``pipeline_configs["schedule"] == "1F1B"`` or the layer's
  ``remat_ticks=True``): stage ``d`` runs ``pp - d - 1`` forwards, then
  alternates, so it holds at most ``pp - d`` microbatches' activations
  (the reference gets the same memory profile from remat of each tick,
  with the same numbers);
- interleaved, with ``v > 1`` virtual stages: Megatron's order over
  ``(microbatch, chunk)``, 1F1B when asked for (its warm-up ``(pp - d -
  1) * 2 + (v - 1) * pp``), else every forward first. It needs the
  microbatch count to be a multiple of pp.

In every order a stage's backwards of one chunk run in microbatch
order, so the gradients accumulate alike and GPipe and 1F1B give the
same bits.

The loss is the reference's whole-batch loss. With a ``loss_fn`` that
has ``token_count`` (the pipe models') the last stage divides each
microbatch's summed token loss by the whole batch's count (over the
batch group as well) and sums the microbatches; any other ``loss_fn``
is averaged over the microbatches, as Paddle does. The loss is then
broadcast over the pp group, so every rank's ``train_batch`` returns
it. ``train_batch`` then sums the shared weights' gradients over their
stages, sums every gradient over the batch group once (after the last
microbatch's backward; an expert laid out over dp only over the other
batch axes), and steps the optimizer. Under ZeRO
(``group_sharded_parallel``) its hooks sum each backward's gradients
over the batch group into this rank's slices instead, and the shared
weights' sums act on the slices; with a ``GradScaler`` the stages agree on
whether any gradient was not finite. The batch group is
``fleet.batch_axes`` of the layer's ``config``: dp, and sep for a
context-parallel model, whose ranks hold sequence chunks.

What crosses a stage boundary is whatever the stage's layers give: under
sequence parallelism ``[mb, s / mp, h]``, under context parallelism
``[mb, s / sep, h]``. A boundary's first activation is preceded by its
shape and dtype, sent by the rank that made it to the one that takes
it (the two share their dp, mp and sep coordinates), so each receive
buffer is allocated by its own peer's layout; a gradient's buffer is
the receiving stage's own output's shape. ``PipelineLayer.counters``
count the bytes of the tensors actually sent.

Under dp > 1 a rank's batch holds, for each microbatch in turn, its dp
chunk of that microbatch: rank ``r`` of ``dp`` takes rows
``global.reshape(n_micro, dp, -1, ...)[:, r]`` of the global batch, so
the dp ranks' microbatch ``m`` together is the reference's microbatch
``m`` (its rows ``m * B / n_micro`` onwards) in the reference's order.
A dense model's loss does not depend on that order; an MoE layer's gate
does, as it fills each expert's slots in token order over the whole
microbatch.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ... import _comm
from ... import env as env_mod
from ...collective import p2p
from ...parallel import _batch_sums
from .parallel_layers.pp_layers import PipelineLayer

__all__ = ["PipelineParallel"]

_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32]


def _orders(n_micro, pp, v, one_f_one_b):
    """Each stage's steps in order: ``("F" | "B", microbatch, chunk)``."""
    out = []
    for d in range(pp):
        if v == 1:
            fwd = [("F", m, 0) for m in range(n_micro)]
            bwd = [("B", m, 0) for m in range(n_micro)]
            warm = min(pp - d - 1, n_micro)
        else:
            def mb(k):
                return (k // (pp * v)) * pp + k % pp

            total = n_micro * v
            fwd = [("F", mb(k), (k // pp) % v) for k in range(total)]
            bwd = [("B", mb(k), v - 1 - (k // pp) % v) for k in range(total)]
            warm = min((pp - d - 1) * 2 + (v - 1) * pp, total)
        if not one_f_one_b:
            out.append(fwd + bwd)
            continue
        steps = fwd[:warm]
        for i in range(len(fwd) - warm):
            steps += [fwd[warm + i], bwd[i]]
        out.append(steps + bwd[len(fwd) - warm:])
    return out


def make_schedule(n_micro, pp, v=1, one_f_one_b=False, forward_only=False):
    """The lock-step ticks: each a list over stages of the step it runs
    (``(kind, microbatch, chunk)`` or None). A forward of virtual stage
    ``g = chunk * pp + stage`` waits for ``g - 1``'s output; a backward
    for its own forward and for ``g + 1``'s input gradient. What a tick
    produces arrives for the next."""
    orders = _orders(n_micro, pp, v, one_f_one_b)
    if forward_only:
        orders = [[s for s in o if s[0] == "F"] for o in orders]
    last = pp * v - 1
    pos = [0] * pp
    ready = set()  # ("F" done | "act" arrived | "grad" arrived, mb, g)
    ticks = []
    while any(p < len(o) for p, o in zip(pos, orders)):
        tick, made = [None] * pp, []
        for d in range(pp):
            if pos[d] == len(orders[d]):
                continue
            kind, m, c = orders[d][pos[d]]
            g = c * pp + d
            if kind == "F":
                ok = g == 0 or ("act", m, g) in ready
            else:
                ok = ("F", m, g) in ready and (
                    g == last or ("grad", m, g) in ready)
            if not ok:
                continue
            tick[d] = (kind, m, c)
            pos[d] += 1
            if kind == "F":
                made.append(("F", m, g))
                if g < last:
                    made.append(("act", m, g + 1))
            elif g > 0:
                made.append(("grad", m, g - 1))
        if not any(tick):
            raise RuntimeError("the pipeline schedule cannot proceed")
        ready.update(made)
        ticks.append(tick)
    return ticks


_META = 10  # ndim, dtype code, then up to 8 dims


def _meta(t):
    """What the receiver of ``t`` allocates by, as an int64 tensor."""
    return torch.tensor([t.dim(), _DTYPES.index(t.dtype)] + list(t.shape)
                        + [0] * (_META - 2 - t.dim()), dtype=torch.int64,
                        device=t.device)


class PipelineParallel:
    """``PipelineParallel(layers, hcg, strategy)``: ``layers`` a
    ``PipelineLayer``; ``strategy.pipeline_configs`` gives
    ``accumulate_steps`` and ``micro_batch_size`` (and ``schedule``).
    The batch is cut into ``n_micro = max(accumulate_steps, pp)``
    microbatches along dim 0. Attributes not found here are the
    layer's."""

    def __init__(self, layers, hcg, strategy=None):
        if not isinstance(layers, PipelineLayer):
            raise TypeError("PipelineParallel expects a PipelineLayer")
        cfg = (strategy.pipeline_configs if strategy is not None else {}) \
            or {}
        self.__dict__.update(
            _layers=layers, _hcg=hcg, _strategy=strategy,
            accumulate_steps=int(cfg.get("accumulate_steps", 1) or 1),
            micro_batch_size=int(cfg.get("micro_batch_size", 1) or 1),
            total_loss=None)
        remat = layers._remat_ticks
        if remat is None:
            remat = str(cfg.get("schedule", "")).upper() == "1F1B"
        self.one_f_one_b = bool(remat)
        self._pp = hcg.get_pipe_parallel_world_size()
        self._stage = hcg.get_stage_id()
        from .. import batch_axes

        self._pp_pair = hcg.get_pipe_parallel_group()._pair()
        self._batch_axes = batch_axes(getattr(layers, "config", None))
        self._batch_pair = env_mod.ensure_env().group(self._batch_axes)
        self._batch_sums = _batch_sums(layers.parameters(),
                                       self._batch_axes, self._batch_pair)

    def __getattr__(self, name):
        return getattr(self.__dict__["_layers"], name)

    def __call__(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def _n_micro(self):
        return max(self.accumulate_steps, self._pp)

    def _split(self, t, n):
        if t.shape[0] % n:
            raise ValueError(f"batch {t.shape[0]} not divisible into {n} "
                             f"microbatches")
        return list(t.chunk(n, 0))

    # -- the schedule -------------------------------------------------------

    def _run(self, inputs, labels, train, scaler=None):
        """Run the schedule over the microbatches; returns the summed
        loss on the last stage (None elsewhere) and, without labels, the
        last stage's outputs."""
        layers = self._layers
        pp, d, v = self._pp, self._stage, layers.num_chunks
        n = self._n_micro()
        if v > 1 and n % pp:
            raise ValueError(f"interleaved stages need the microbatch "
                             f"count ({n}) to be a multiple of pp ({pp})")
        last = pp * v - 1
        note = getattr(layers, "note_batch", None)
        if note is not None and inputs is not None:
            note(inputs)  # what every stage must know of the batch
        xs = self._split(inputs, n) if d == 0 else None
        ys = self._split(labels, n) \
            if labels is not None and d == pp - 1 else None
        loss_fn = layers.loss_fn
        count = None
        if ys is not None and hasattr(loss_fn, "token_count"):
            count = sum(loss_fn.token_count(y) for y in ys)
            if len(self._batch_pair[0]) > 1:
                count = _comm.all_reduce(count.clone(), self._batch_pair)
        ticks = make_schedule(n, pp, v, train and self.one_f_one_b,
                              forward_only=not train)
        held = {}      # (mb, chunk) -> (input, output)
        arrived = {}   # ("act" | "grad", mb, chunk) -> tensor
        shapes = {}    # chunk boundary g -> (shape, dtype) of what crosses
        losses, outs = [], []
        counters = layers.counters
        counters["forwards"] += 1
        counters["microbatches"] += n
        for tick in ticks:
            sends = []
            step = tick[d]
            if step is not None:
                kind, m, c = step
                g = c * pp + d
                if kind == "F":
                    if g == 0:
                        x = xs[m]
                    else:
                        x = arrived.pop(("act", m, c))
                        if train and x.is_floating_point():
                            x.requires_grad_(True)
                    with torch.set_grad_enabled(train):
                        out = layers(x, chunk_id=c)
                        if g == last and ys is not None:
                            if count is not None:
                                out = loss_fn(out, ys[m], count=count)
                            else:
                                out = loss_fn(out, ys[m]) / n
                            losses.append(out.detach())
                        elif g == last:
                            outs.append(out)
                    if train:
                        held[(m, c)] = (x, out)
                    if g < last:
                        sends.append((out.detach(), g + 1, "act", m))
                else:
                    x, out = held.pop((m, c))
                    if g == last:
                        (scaler.scale(out) if scaler is not None
                         else out).backward()
                    else:
                        torch.autograd.backward(
                            out, grad_tensors=arrived.pop(("grad", m, c)))
                    if g > 0:
                        gx = x.grad if x.grad is not None \
                            else torch.zeros_like(x)
                        sends.append((gx, g - 1, "grad", m))
            self._exchange(tick, sends, shapes, arrived, held)
        total = torch.stack(losses).sum() if losses else None
        return total, outs

    def _exchange(self, tick, sends, shapes, arrived, held):
        """This tick's transfers to and from this stage: a boundary's
        first activation is preceded by its shape and dtype."""
        pp, d = self._pp, self._stage
        v = self._layers.num_chunks
        last = pp * v - 1
        recvs, metas_out, metas_in = [], [], []
        out = [(t, g % pp) for t, g, _, _ in sends]
        for t, g, kind, _ in sends:
            if kind == "act" and g not in shapes:
                shapes[g] = None
                metas_out.append((_meta(t), g % pp))
        for s, step in enumerate(tick):
            if step is None or s == d:
                continue
            kind, m, c = step
            g = c * pp + s
            if kind == "F" and g < last and (g + 1) % pp == d:
                if g + 1 not in shapes:
                    shapes[g + 1] = torch.empty(_META, dtype=torch.int64,
                                                device=self._device())
                    metas_in.append((shapes[g + 1], s))
                recvs.append(("act", m, (g + 1) // pp, g + 1, s))
            elif kind == "B" and g > 0 and (g - 1) % pp == d:
                recvs.append(("grad", m, (g - 1) // pp, g - 1, s))
        # (pp > 1 here: consecutive virtual stages lie on two ranks)
        if metas_out or metas_in:
            p2p(metas_out, metas_in, self._pp_pair)
        bufs = []
        for kind, m, c, g, s in recvs:
            if kind == "act":
                meta = shapes[g]
                if isinstance(meta, torch.Tensor):
                    ndim, code = int(meta[0]), int(meta[1])
                    shapes[g] = (tuple(int(x) for x in meta[2:2 + ndim]),
                                 _DTYPES[code])
                shape, dtype = shapes[g]
                buf = torch.empty(shape, dtype=dtype,
                                  device=self._device())
            else:
                buf = torch.empty_like(held[(m, c)][1])
            bufs.append(((kind, m, c), buf, s))
        if out or bufs:
            p2p(out, [(b, s) for _, b, s in bufs], self._pp_pair)
        counters = self._layers.counters
        for t, _ in out:
            counters["sends"] += 1
            counters["bytes_sent"] += t.numel() * t.element_size()
        for key, buf, _ in bufs:
            arrived[key] = buf

    def _device(self):
        for p in self._layers.parameters():
            return p.device
        return torch.device("cpu")

    def _broadcast_final_loss(self, total):
        """The last stage's loss on every stage of the pp group."""
        if self._pp == 1:
            return total
        if total is None:
            total = torch.zeros((), dtype=torch.float32,
                                device=self._device())
        total = total.detach().to(torch.float32).contiguous()
        src = self._pp_pair[0][-1]
        _comm.run(dist.broadcast, total, self._pp_pair, total, src=src)
        return total

    # -- the API ------------------------------------------------------------

    def forward_backward_pipeline(self, data, scaler=None):
        """Forward and backward over the microbatches of one batch
        ``(inputs, labels)``; returns the whole batch's loss on every
        rank, its gradients accumulated in the parameters."""
        if self._layers.loss_fn is None:
            raise ValueError("PipelineLayer needs loss_fn for train_batch")
        inputs, labels = data
        total, _ = self._run(inputs, labels, train=True, scaler=scaler)
        self.total_loss = self._broadcast_final_loss(total)
        return self.total_loss

    def _reduce_gradients(self, optimizer=None):
        """After the microbatches' backwards: each shared weight's
        gradient summed over its stages, then every gradient over the
        batch group (an expert over dp over the other batch axes), once,
        in one all-reduce per group and dtype. Under ZeRO
        (``optimizer._zero``) the plan's hooks have summed every gradient
        over the batch group already, each into this rank's slice, and
        the shared weights' sums act on those."""
        zero = getattr(optimizer, "_zero", None)
        self._layers.allreduce_shared_weight_gradients(zero)
        if zero is not None:
            return
        for pair, params in self._batch_sums:
            by_dtype = {}
            for p in params:
                if p.grad is not None:
                    by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
            for grads in by_dtype.values():
                flat = torch.cat([g.reshape(-1) for g in grads])
                _comm.all_reduce(flat, pair)
                off = 0
                for g in grads:
                    g.copy_(flat[off:off + g.numel()].view_as(g))
                    off += g.numel()

    def _found_inf_anywhere(self, scaler):
        """The scaler's ``found_inf`` maxed over every rank."""
        flag = torch.tensor([float(scaler._found_inf)],
                            device=self._device())
        world = env_mod.ensure_env().group(env_mod.AXIS_ORDER)
        _comm.all_reduce(flag, world, op=dist.ReduceOp.MAX)
        scaler._found_inf = bool(flag.item())

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """One optimizer step on the batch ``data = (inputs, labels)``:
        the schedule's forward and backward, the shared and dp gradient
        sums, the step (through ``scaler`` if given), ``clear_grad``,
        and ``lr_scheduler.step()``. Returns the loss."""
        loss = self.forward_backward_pipeline(data, scaler)
        self._reduce_gradients(optimizer)
        if scaler is not None:
            scaler.unscale_(optimizer)
            self._found_inf_anywhere(scaler)
            scaler.step(optimizer)
            scaler.update()
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    @torch.no_grad()
    def eval_batch(self, data, compute_loss=True):
        """The forward over the microbatches: the loss on every rank, or
        with ``compute_loss=False`` the last stage's output (None on the
        other stages)."""
        inputs, labels = data
        if not compute_loss or self._layers.loss_fn is None:
            _, outs = self._run(inputs, None, train=False)
            return torch.cat(outs, 0) if outs else None
        total, _ = self._run(inputs, labels, train=False)
        return self._broadcast_final_loss(total)
