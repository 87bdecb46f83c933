"""The pipeline-parallel layer container.

Counterpart of ``paddle_tpu/distributed/fleet/meta_parallel/
parallel_layers/pp_layers.py``: a model written as a flat list of layer
descriptors (:class:`LayerDesc`, :class:`SharedLayerDesc`), cut into
stages. The reference holds every stage in one SPMD program, the
repeated blocks stacked along an axis sharded over ``pp``. The port does
what Paddle does: one process per rank, and each rank builds only its
own stage:

- the repeated blocks are the longest run of descriptors of one class
  (the reference's ``_repeated_run``); they are split evenly, and with
  ``num_virtual_pipeline_stages=v`` stage ``d`` holds the chunks ``c``
  of blocks ``[(c * pp + d) * bpc, +bpc)`` (the reference's storage
  order), ``bpc = n_blocks / (pp * v)``;
- stage 0 also builds the descriptors before the run (the head, in its
  first chunk), the last stage those after it (the tail, in its last
  chunk);
- every layer is registered under its canonical flat index, so
  ``state_dict`` gives the reference's canonical ``"<index>.<param>"``
  keys whatever the layout: a rank saves its own layers, and
  :meth:`PipelineLayer.set_state_dict` takes its own keys from a whole
  canonical dict, so a checkpoint moves between pp 1, 2 and 4 and any
  ``v``. At pp 1 the container is a plain sequential.

A :class:`SharedLayerDesc` layer is built once per rank for all its
occurrences there. When its occurrences lie on several stages, each of
those stages holds a copy: the first stage's weight is broadcast to
the others at construction and, after the backward,
:meth:`PipelineLayer.allreduce_shared_weight_gradients` sums its
gradient over them (Paddle's ``allreduce_shared_weight_gradients``).
The later stages' copies are marked ``_pp_shared_dup``, so the global
gradient norm counts the weight once.

The reference reports each pipelined forward to its monitor slot, with
an analytic byte count of permuting the ``[pp, mb, ...]`` state. The
port keeps plain-int :attr:`PipelineLayer.counters` instead (forwards,
microbatches, sends and bytes sent), which
``pipeline_parallel.PipelineParallel`` adds to as it runs: they count
the transfers that really happen.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from .... import _comm
from .... import env as env_mod
from ...utils.recompute import recompute

__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer"]


class LayerDesc:
    """A layer to build later: ``layer_func(*inputs, **kwargs)``, an
    ``nn.Module`` class."""

    def __init__(self, layer_func, *inputs, **kwargs):
        if not (isinstance(layer_func, type)
                and issubclass(layer_func, nn.Module)):
            raise TypeError("LayerDesc expects an nn.Module subclass")
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_func.__name__})"


class SharedLayerDesc(LayerDesc):
    """A layer shared by every descriptor with the same ``key`` (tied
    weights). ``forward_func(layer, x)``, when given, runs that
    occurrence in place of the layer's forward; ``shared_weight_attr``
    names the parameter kept equal across stages."""

    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr

    def build_layer(self, registry=None):
        if registry is None:
            return super().build_layer()
        if self.layer_name not in registry:
            registry[self.layer_name] = super().build_layer()
        return registry[self.layer_name]


def _layer_class(desc):
    return desc.layer_func if isinstance(desc, LayerDesc) else type(desc)


def _repeated_run(descs):
    """(start, length) of the longest contiguous run of descriptors of
    one class (the first such run on a tie)."""
    best = (0, 1)
    i, n = 0, len(descs)
    while i < n:
        j = i
        cls = _layer_class(descs[i])
        while j < n and _layer_class(descs[j]) is cls:
            j += 1
        if j - i > best[1]:
            best = (i, j - i)
        i = j
    return best


class PipelineLayer(nn.Module):
    """``layers``: :class:`LayerDesc`\\ s, :class:`SharedLayerDesc`\\ s
    or built modules, in order. ``loss_fn(output, labels)`` is the last
    stage's loss; one that also has ``token_count(labels)`` is called as
    ``loss_fn(output, labels, count=n)`` with the whole batch's count
    (see ``PipelineParallel``). ``recompute_interval > 0`` recomputes
    the repeated blocks in segments of that many
    (``fleet.utils.recompute``); ``remat_ticks`` (or the strategy's
    ``pipeline_configs["schedule"] == "1F1B"``) selects the 1F1B
    schedule. The pp degree and this rank's stage come from the hybrid
    group (pp 1 without one)."""

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0,
                 num_virtual_pipeline_stages=None, remat_ticks=None,
                 **kwargs):
        super().__init__()
        from ...base.topology import get_hcg

        self._loss_fn = loss_fn
        self._recompute = int(recompute_interval or 0)
        self._remat_ticks = remat_ticks
        hcg = get_hcg()
        pp = hcg.get_pipe_parallel_world_size() if hcg is not None else 1
        stage = hcg.get_stage_id() if hcg is not None else 0
        self._pp, self._stage = pp, stage
        self._num_stages = num_stages or pp
        descs = list(layers)
        self._n_layers = len(descs)
        start, length = _repeated_run(descs)
        self._flat_start, self._n_blocks = start, length
        v = max(int(num_virtual_pipeline_stages or 1), 1) if pp > 1 else 1
        if pp > 1 and length % (pp * v):
            raise ValueError(
                f"pipeline blocks ({length}) must divide evenly over pp "
                f"stages ({pp}) x virtual stages ({v})")
        self._virtual = v
        self._chunks = self._partition(pp, stage, v)
        self.counters = {"forwards": 0, "microbatches": 0, "sends": 0,
                         "bytes_sent": 0}
        # each shared key's canonical indices, on every stage
        self._tied = {}
        for i, d in enumerate(descs):
            if isinstance(d, SharedLayerDesc):
                self._tied.setdefault(d.layer_name, []).append(i)
        registry: dict = {}
        self._run = {}  # canonical index -> callable on x
        for idx in sorted(i for c in self._chunks for i in c):
            d = descs[idx]
            if isinstance(d, SharedLayerDesc):
                layer = d.build_layer(registry)
            elif isinstance(d, LayerDesc):
                layer = d.build_layer()
            else:
                layer = d
            self.add_module(str(idx), layer)
            if isinstance(d, SharedLayerDesc) and d.forward_func is not None:
                self._run[idx] = (lambda x, f=d.forward_func, m=layer:
                                  f(m, x))
            else:
                self._run[idx] = layer
        self._shared = self._share(descs, registry, pp, stage, v)

    # -- layout -------------------------------------------------------------

    def _partition(self, pp, stage, v):
        """This stage's chunks: each a list of canonical indices."""
        start, length, n = self._flat_start, self._n_blocks, self._n_layers
        if pp == 1:
            return [list(range(n))]
        bpc = length // (pp * v)
        chunks = [[start + (c * pp + stage) * bpc + i for i in range(bpc)]
                  for c in range(v)]
        if stage == 0:
            chunks[0] = list(range(start)) + chunks[0]
        if stage == pp - 1:
            chunks[-1] = chunks[-1] + list(range(start + length, n))
        return chunks

    def _stage_of(self, idx, pp, v):
        """The stage that holds canonical index ``idx``."""
        start, length = self._flat_start, self._n_blocks
        if idx < start:
            return 0
        if idx >= start + length:
            return pp - 1
        return ((idx - start) // (length // (pp * v))) % pp

    def _share(self, descs, registry, pp, stage, v):
        """For each shared key held on several stages: its weight here,
        the group of those stages' ranks (made on every rank, in one
        order), and the weight broadcast from the first of them."""
        out = []
        keys = {}
        for i, d in enumerate(descs):
            if isinstance(d, SharedLayerDesc):
                keys.setdefault(d.layer_name, (d.shared_weight_attr, set()))
                keys[d.layer_name][1].add(self._stage_of(i, pp, v))
        e = env_mod.get_env()
        for key, (attr, stages) in keys.items():
            stages = sorted(stages)
            if len(stages) < 2:
                continue
            mine = None
            pp_groups = sorted({tuple(e.members("pp", r))
                                for r in range(e.world_size)})
            for ranks in pp_groups:
                sub = [ranks[s] for s in stages]
                pg = dist.new_group(sub)
                if e.rank in sub:
                    mine = (sub, pg)
            if mine is None:
                continue
            w = getattr(registry[key], attr)
            if stage != stages[0]:
                w._pp_shared_dup = True
            with torch.no_grad():
                _comm.run(dist.broadcast, w, mine, w.data, src=mine[0][0])
            out.append((w, mine))
        return out

    def allreduce_shared_weight_gradients(self, zero=None):
        """Sum each shared weight's gradient over the stages that hold
        it (collective over them). Under ZeRO (``zero``, the optimizer's
        plan) the sum acts on the gradient as the plan holds it: this
        rank's slice of it under ``os_g``."""
        for w, group in self._shared:
            if zero is not None and zero.holds_grad(w):
                zero.sum_grad(w, group)
                continue
            g = w.grad if w.grad is not None else torch.zeros_like(w)
            w.grad = _comm.all_reduce(g.contiguous(), group)

    @property
    def num_chunks(self) -> int:
        """This stage's chunks (``num_virtual_pipeline_stages``)."""
        return len(self._chunks)

    def get_num_stages(self):
        return self._num_stages

    @property
    def loss_fn(self):
        return self._loss_fn

    # -- canonical checkpoint surface ---------------------------------------

    def held_elsewhere(self, key):
        """Whether canonical ``key`` names a layer another stage holds."""
        head = key.split(".", 1)[0]
        return head.isdigit() and int(head) < self._n_layers \
            and str(int(head)) not in self._modules

    def tied_keys(self, key):
        """The canonical keys that name the same tensor as ``key``: its
        other occurrences when it belongs to a shared layer."""
        head, _, leaf = key.partition(".")
        for indices in self._tied.values():
            if head.isdigit() and int(head) in indices:
                return [f"{i}.{leaf}" for i in indices if i != int(head)]
        return []

    def pp_group(self):
        """The pp group's ``(ranks, process group)``, or None at pp 1."""
        from ...base.topology import get_hcg

        if self._pp == 1:
            return None
        return get_hcg().get_pipe_parallel_group()._pair()

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Load this rank's canonical keys from ``state_dict`` (which may
        hold every stage's); returns (missing, unexpected): this rank's
        keys it lacks, and keys that name no layer of the model."""
        own = self.state_dict()
        found = {}
        for k in own:
            for name in [k] + self.tied_keys(k):
                if name in state_dict:
                    found[k] = state_dict[name]
                    break
        missing = [k for k in own if k not in found]
        unexpected = [k for k in state_dict
                      if k not in own and not self.held_elsewhere(k)]
        with torch.no_grad():
            for k, t in own.items():
                if k in found:
                    src = torch.as_tensor(found[k])
                    if tuple(src.shape) != tuple(t.shape):
                        raise ValueError(
                            f"{k}: loaded shape {tuple(src.shape)}, the "
                            f"layer holds {tuple(t.shape)}")
                    t.copy_(src.to(t.dtype))
        return missing, unexpected

    load_dict = set_state_dict

    # -- forward ------------------------------------------------------------

    def _run_indices(self, indices, x):
        start, stop = self._flat_start, self._flat_start + self._n_blocks
        seg = self._recompute
        i = 0
        while i < len(indices):
            idx = indices[i]
            if seg > 0 and start <= idx < stop and torch.is_grad_enabled():
                group = [j for j in indices[i:i + seg] if start <= j < stop]
                fns = [self._run[j] for j in group]

                def run(h, fns=fns):
                    for f in fns:
                        h = f(h)
                    return h

                x = recompute(run, x)
                i += len(group)
                continue
            x = self._run[idx](x)
            i += 1
        return x

    def forward(self, x, chunk_id=None):
        """Run chunk ``chunk_id`` of this stage (all of its layers when
        None: the whole model at pp 1)."""
        if chunk_id is None:
            indices = [i for c in self._chunks for i in c]
        else:
            indices = self._chunks[chunk_id]
        return self._run_indices(indices, x)
