"""Mixture-of-experts with the experts over a mesh axis.

Counterpart of ``paddle_tpu/incubate/distributed/models/moe/
moe_layer.py``. The reference routes with GShard's dense one-hot
tensors: ``combine`` and ``dispatch`` ``[T, E, C]`` (tokens, experts,
capacity slots), the expert buffers and the combine as einsums over
them, and GSPMD derives the token all-to-all from the experts' sharding
over ``dp``. At T = 8192, E = 8 and C = 2560 one such tensor is 671 MB
in fp32, and autograd would keep several per layer. The port computes
the same routing by index:

- each token's expert (``argmax`` of the fp32 softmax; ties to the
  lowest index, as in JAX) and its slot in that expert's buffer, from
  the same running counts (``cumsum``) as the reference's positions;
  a second choice's slot comes after every first choice of its expert;
- the kept tokens are copied into an ``[E * C + 1, H]`` buffer whose
  last row takes every dropped token, so no shape depends on the data
  and the forward never reads the host (a CUDA graph captures it);
- the experts run as two batched products (``torch.bmm``), and each
  token gathers its one or two outputs, weighted by its gates (cast to
  ``x.dtype`` first, as the reference casts ``combine``). A dropped
  token's row is 0: the residual carries it.

The batch is split over the batch axes (``fleet.batch_axes``: dp, and
sharding at degree > 1), but the gate is the reference's, global over
every token any rank holds: the capacity counts every rank's tokens, a
rank's slots start after the earlier ranks' tokens of the same expert
(one all-gather of the per-expert counts over the batch group, in its
order, which is the batch's), and the aux loss's means are over every
token (the sum of the probabilities through ``_comm.reduce_from``).

Expert parallelism (``expert_axis``, dp by default; any of dp,
sharding, sep and mp, or a tuple of them, as the reference puts ``[E,
C, H]`` over any mesh axes): at degree > 1 each rank holds ``E / n``
experts (``w_in`` and ``w_out`` cut on dim 0 over the axes, a
``shard.Layout``, the rank's block its place over them; at degree 1
dim 0 is only annotated, so ZeRO cuts another). The buffer's expert
dim is cut axis by axis, in mesh order. Over an axis the tokens are
split on (a batch axis, or a sequence axis: mp under SP, sep under
context parallelism) each rank fills the slots of all the experts that
its tokens take; a reduce-scatter over the axis along the experts
gives each rank its part of the buffers (the slots of two ranks never
meet, so the sum is exact), and after the experts an all-gather
returns every expert's outputs (its backward a reduce-scatter, as each
rank's tokens read them). Those moves carry the bytes the reference's
token all-to-all carries; ``comm_bytes`` counts them. Over an axis the
tokens are replicated on (mp without SP, sep without context
parallelism) every rank computes the same gate and takes its part of
the buffer (no reduce-scatter), and the outputs come back by an
all-gather whose backward takes the rank's own part; the tokens'
gradient from the buffer is summed over those axes. The ranks of a
batch axis the experts do not lie over run them on their own tokens'
slots, so the experts' gradients are partial over it, and the model's
batch sum (which skips only the axes a parameter is cut on) adds them
up: each expert's gradient counts every token once.

Under sequence or context parallelism (``sequence_axis`` ``"mp"`` or
``"sep"``, or ``("sep", "mp")`` under both, a sep chunk split further
over mp: sequence rank ``sep_rank * mp + mp_rank``) a rank's input is
its column chunk ``[r * S / n, (r + 1) * S / n)`` of every row of its
rows, not a contiguous run of the global token
order (row by row) that the gate counts in. A token's slot then counts
the tokens of its expert in every rank's earlier rows, in the earlier
sequence ranks' chunks of its own row, and before it in its chunk: each
rank's per-row counts ``[k, rows, E]`` (a few KB) are all-gathered over
the sequence group, then the per-rank totals over dp as before. The
capacity and the aux loss's means count the global tokens (the
probabilities summed over dp and the sequence axis together). Each
sequence rank runs its experts on its own tokens' slots, so their
gradients, and the gate's, are partial over the sequence axes. Under SP
(``"mp"``) the layer sums all three over mp in the backward (the
experts not when they lie over mp). A sequence that mp does not divide
arrives padded at its end (``forward``'s ``seq_len``): its padding
rows take no slot and count in neither the capacity nor the aux
loss. Under
context parallelism ``"sep"`` is one of the model's batch axes, over
which ``fleet.distributed_model`` (and ``PipelineParallel``) sums every
gradient, a parameter laid out over a batch axis over the others. Under
both, the sums over each axis follow the same rules.

:func:`moe_dense` is the plain version: the reference's one-hot
tensors and einsums in PyTorch, on one rank.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .....distributed import _comm
from .....distributed import env as env_mod
from .....distributed import shard
from .....distributed.fleet import batch_axes
from .....distributed.fleet.base.topology import get_hcg
from .....framework.device import resolve_device

__all__ = ["MoELayer", "moe_dense", "capacity"]

_ACT = {"gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
        "relu": torch.relu,
        "silu": torch.nn.functional.silu}


def capacity(top_k, tokens, experts, capacity_factor):
    """Slots per expert: ``ceil(top_k * T / E * capacity_factor)``, T the
    global token count (the reference's expression)."""
    return int(math.ceil(top_k * tokens / experts * capacity_factor))


def _axes_group(axes):
    """(degree, this rank's place, group) over the mesh axes ``axes`` of
    the hybrid group; (1, 0, None) for none, at degree 1 or without a
    hybrid group (``fleet.init``), as the tensor-parallel layers take
    theirs."""
    if not axes or get_hcg() is None:
        return 1, 0, None
    env = env_mod.ensure_env()
    pair = env.group(axes)
    if len(pair[0]) == 1:
        return 1, 0, None
    return len(pair[0]), pair[0].index(env.rank), pair


_EXPERT_AXES = ("dp", "sharding", "sep", "mp")


def expert_axes(expert_axis):
    """The mesh axes the experts lie over, in mesh order (``expert_axis``
    a name or a tuple of names); raises naming a bad one."""
    axes = (expert_axis,) if isinstance(expert_axis, str) \
        else tuple(expert_axis)
    bad = [a for a in axes if a not in _EXPERT_AXES]
    if bad or not axes:
        raise ValueError(f"expert_axis={expert_axis!r}: the experts lie "
                         f"over one or more of {_EXPERT_AXES}")
    return env_mod._canon(axes)


def layer_groups(expert_axis, sequence_axis):
    """The groups of more than one axis a layer of these axes uses, in
    the order it makes them (a model makes them on every rank first: a
    pipeline stage builds only its own layers)."""
    experts = expert_axes(expert_axis)
    batch = tuple(a for a in batch_axes() if a != "sep")
    seq = (sequence_axis,) if isinstance(sequence_axis, str) \
        else tuple(sequence_axis or ())
    moving = batch + seq
    rep = tuple(a for a in experts if a not in moving)
    return [g for g in (experts, rep, batch, seq, batch + seq) if g]


def _check_top_k(top_k):
    if top_k not in (1, 2):
        raise NotImplementedError(
            f"top_k={top_k}: only top-1 (switch) and top-2 (gshard) "
            "gates are implemented")


class MoELayer(nn.Module):
    """The expert-parallel FFN block: ``gate_weight [H, E]``, ``w_in [E,
    H, F]``, ``w_out [E, F, H]`` (each rank's ``E / dp`` experts under
    dp > 1), the activation ``gelu`` (tanh form, JAX's default),
    ``relu`` or ``silu``, and the top-2 (GShard) or top-1 (Switch)
    gate. ``forward([B, S, H])`` keeps the load-balancing aux loss on
    ``self.aux_loss`` (fp32, global) for the caller to add, and the
    count of this rank's tokens dispatched by each choice on
    ``self.dispatched`` (``[top_k]``). Weights are drawn (Xavier normal
    on each expert's matrix) from ``generator`` on their global shapes
    and cut; ``generator=False`` leaves them unset."""

    def __init__(self, d_model, d_hidden, num_experts, top_k=2,
                 capacity_factor=1.25, activation="gelu", expert_axis="dp",
                 gate="gshard", name=None, *, sequence_axis=None,
                 dtype=torch.float32, device="cuda", generator=None):
        super().__init__()
        _check_top_k(top_k)
        axes = expert_axes(expert_axis)
        if activation not in _ACT:
            raise ValueError(f"activation must be one of {sorted(_ACT)}, "
                             f"got {activation!r}")
        dev = resolve_device(device)
        self.d_model, self.d_hidden = d_model, d_hidden
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor = capacity_factor
        self.gate_type, self.act = gate, activation
        self.expert_axis = expert_axis
        seq = (sequence_axis,) if isinstance(sequence_axis, str) \
            else tuple(sequence_axis or ())
        if seq not in ((), ("mp",), ("sep",), ("sep", "mp")):
            raise ValueError(f"sequence_axis must be None, 'mp', 'sep' or "
                             f"('sep', 'mp'), got {sequence_axis!r}")
        # the experts' axes; the batch axes the tokens are split over (dp,
        # and sharding when its degree is > 1, as fleet.batch_axes)
        self._n, self._rank, self._group = _axes_group(axes)
        batch = tuple(a for a in batch_axes() if a != "sep")
        # the buffer's expert dim cut axis by axis, in mesh order: over an
        # axis the tokens are split on, a reduce-scatter (True); over one
        # they are replicated on, the rank's part (False)
        self._steps = [(a in batch + seq, g) for a, g in
                       ((a, _axes_group((a,))) for a in axes) if g[0] > 1]
        # the tokens' gradient from the buffer sums over the replicated
        self._rep_group = _axes_group(
            tuple(a for a in axes if a not in batch + seq))[2]
        self._batch_n, self._batch_rank, self._batch_group = \
            _axes_group(batch)
        self._seq_n, self._seq_rank, self._seq_group = _axes_group(seq)
        # under SP the gate's and the experts' gradients are partial over
        # mp (the batch axes' sums are the model's: a parameter laid out
        # over one of them is summed over the others); experts that lie
        # over mp hold every mp rank's tokens of their slots already
        self._mp = _axes_group(("mp",) if "mp" in seq else ())
        self._sp_group = self._mp[2]
        self._expert_sp_group = None if "mp" in axes else self._sp_group
        # the group the tokens are split over: the batch and the sequence
        self._token_group = _axes_group(batch + seq)[2]
        if num_experts % self._n:
            raise ValueError(f"num_experts = {num_experts} does not split "
                             f"evenly over {expert_axis} = {self._n}")
        cut = axes if len(axes) > 1 else axes[0]
        self.gate_weight = nn.Parameter(torch.empty(
            (d_model, num_experts), dtype=dtype, device=dev))
        self.w_in = nn.Parameter(torch.empty(
            (num_experts // self._n, d_model, d_hidden), dtype=dtype,
            device=dev))
        self.w_out = nn.Parameter(torch.empty(
            (num_experts // self._n, d_hidden, d_model), dtype=dtype,
            device=dev))
        for w, shape in ((self.w_in, (num_experts, d_model, d_hidden)),
                         (self.w_out, (num_experts, d_hidden, d_model))):
            if self._n > 1:
                shard.set_layout(w, shard.cut_layout(cut, 0, shape))
            else:
                shard.annotate(w, 0)
        if generator is not False:
            self._draw(generator)
        self.aux_loss = None
        self.dispatched = None
        self.comm_bytes = 0

    @torch.no_grad()
    def _draw(self, generator):
        for p in (self.gate_weight, self.w_in, self.w_out):
            layout = getattr(p, "_dist_layout", None)
            shape = p.shape if layout is None else layout.shape
            w = torch.empty(shape, dtype=torch.float32, device=p.device)
            fan_in, fan_out = shape[-2], shape[-1]
            w.normal_(0.0, (2.0 / (fan_in + fan_out)) ** 0.5,
                      generator=generator)
            p.copy_(w if layout is None else shard.local_piece(w, layout))

    def _global_counts(self, counts):
        """From this rank's per-row counts ``[top_k, rows, E]``: for each
        of its rows, the tokens of each choice and expert that come
        before the row's first token here in the global order, less this
        rank's own in its earlier rows (the running count adds those),
        ``[top_k, rows, E]``; and every rank's totals ``[top_k, E]``."""
        own_before = torch.cumsum(counts, 1) - counts
        if self._seq_n > 1:
            every = _comm.all_gather_list(counts, self._seq_group)
            rows = sum(every[1:], every[0])
            in_row = sum(every[:self._seq_rank], torch.zeros_like(counts))
        else:
            rows, in_row = counts, torch.zeros_like(counts)
        before = torch.cumsum(rows, 1) - rows + in_row - own_before
        mine = rows.sum(1)
        if self._batch_n == 1:
            return before, mine
        every = _comm.all_gather_list(mine, self._batch_group)
        before = before + sum(every[:self._batch_rank],
                              torch.zeros_like(mine))[:, None, :]
        return before, sum(every[1:], every[0])

    def _choose(self, probs):
        """Each token's expert by choice, ``[T]`` each: the argmax of the
        softmax ``probs`` (ties to the lowest index, as in JAX), and under
        top-2 the argmax of the rest."""
        first = torch.argmax(probs, dim=-1)
        if self.top_k == 1:
            return [first]
        mask = first[:, None] == torch.arange(self.num_experts,
                                              device=probs.device)
        return [first, torch.argmax(probs * (1.0 - mask.to(probs.dtype)),
                                    dim=-1)]

    def route(self, tokens, cap, n_rows=1, valid=None):
        """The gate on this rank's ``tokens`` ``[T, H]`` (``n_rows`` rows
        of ``T / n_rows`` tokens: the rank's chunk of each under sequence
        parallelism) at ``cap`` slots an expert: ``(probs, gates, rows,
        first)``: the fp32 softmax ``[T, E]``; for each choice the gate
        weights ``[T]`` (normalized over the two under top-2, 0 where
        dropped) and the buffer rows ``[T]`` (``expert * cap + slot``,
        ``E * cap`` where the token is not dispatched); and every rank's
        count of first choices by expert ``[E]``. ``valid`` ``[T]``
        (None: all) marks the real tokens: the others (a padded
        sequence's tail) take no slot and are counted nowhere."""
        E, k = self.num_experts, self.top_k
        gate_weight = _comm.copy_to(self.gate_weight, self._sp_group)
        logits = torch.matmul(tokens, gate_weight.to(tokens.dtype))
        probs = torch.softmax(logits.to(torch.float32), dim=-1)
        experts = torch.arange(E, device=tokens.device)
        idx = self._choose(probs)
        masks = [i[:, None] == experts for i in idx]
        if valid is not None:
            masks = [m & valid[:, None] for m in masks]
        row_of = torch.arange(tokens.shape[0], device=tokens.device) \
            // (tokens.shape[0] // n_rows)
        counts = torch.stack([m.reshape(n_rows, -1, E).sum(1)
                              for m in masks])  # [k, n_rows, E]
        before, total = self._global_counts(counts)
        gates, slots = [], []
        for j, (i, m) in enumerate(zip(idx, masks)):
            # the token's place among its expert's tokens in global order;
            # the running count runs along the last dim of the [E, T]
            # transpose (a scan down [T, E]'s 8 columns is ~100x slower)
            run = torch.cumsum(m.t().to(torch.int32).contiguous(), 1)
            pos = (run.gather(0, i[None, :])[0] - 1).to(torch.int64) \
                + before[j][row_of, i]
            if j == 1:  # after every first choice of the expert
                pos = pos + total[0][i]
            keep = pos < cap if valid is None else (pos < cap) & valid
            gates.append(probs.gather(1, i[:, None])[:, 0] * keep)
            slots.append((i * cap + pos, keep))
        if k == 2:
            denom = torch.clamp(gates[0] + gates[1], min=1e-9)
            gates = [g / denom for g in gates]
        # dispatched as the reference's dispatch = combine > 0
        rows = [torch.where(keep & (g > 0), row,
                            torch.full_like(row, E * cap))
                for g, (row, keep) in zip(gates, slots)]
        return probs, gates, rows, total[0]

    def forward(self, x, seq_len=None):
        """``x`` ``[B, S, H]`` -> ``[B, S, H]``. ``seq_len``: under SP,
        the real length of the sequence mp splits (a sep chunk under
        context parallelism), when it was padded at its end to ``S *
        mp`` because mp does not divide it; the padding is kept out of
        the gate."""
        B, S, H = x.shape
        E, k = self.num_experts, self.top_k
        dt = x.dtype
        # the global tokens: the batch and the sequence are split evenly
        # (less the padding of each sequence mp splits)
        T = B * S * self._batch_n * self._seq_n
        valid = None
        mp_n, mp_rank, _ = self._mp
        if seq_len is not None and seq_len < S * mp_n:
            T = T // (S * mp_n) * seq_len
            valid = (torch.arange(S, device=x.device)
                     + mp_rank * S < seq_len).repeat(B)
        C = capacity(k, T, E, self.capacity_factor)
        tokens = x.reshape(B * S, H)
        probs, gates, rows, first = self.route(tokens, C, B, valid=valid)
        # over an axis the tokens are replicated on, a rank's experts
        # read only their slots, so the tokens' gradient from the buffer
        # is partial and summed over it
        src = _comm.copy_to(tokens, self._rep_group)
        buf = tokens.new_zeros((E * C + 1, H)).index_copy(
            0, torch.cat(rows), src.repeat(k, 1))
        buf = buf[:E * C].view(E, C, H)
        for moving, (n, rank, group) in self._steps:
            if moving:
                self.comm_bytes += buf.numel() * buf.element_size()
                buf = _comm.reduce_scatter(buf, 0, group)
            else:
                buf = buf.narrow(0, rank * (buf.shape[0] // n),
                                 buf.shape[0] // n)
        # each sequence rank ran its own tokens' slots
        w_in = _comm.copy_to(self.w_in, self._expert_sp_group)
        w_out = _comm.copy_to(self.w_out, self._expert_sp_group)
        h = _ACT[self.act](torch.bmm(buf, w_in.to(dt)))
        out = torch.bmm(h, w_out.to(dt))
        for moving, (n, rank, group) in reversed(self._steps):
            # over a replicated axis every rank reads the same outputs:
            # the backward takes this rank's part (a sum would count the
            # upstream gradient n times); over a split one each rank's
            # tokens read them, and the backward sums those parts
            out = _comm.gather_reduce(out, 0, group) if moving \
                else _comm.gather_from(out, 0, group)
            if moving:
                self.comm_bytes += out.numel() * out.element_size()
        flat = torch.cat([out.reshape(E * C, H), out.new_zeros((1, H))])
        y = None
        for g, r in zip(gates, rows):
            # index_select's backward is an index_add: each slot row has
            # one token, so it adds exactly, unlike indexing's sort
            part = g.to(dt)[:, None] * flat.index_select(0, r)
            y = part if y is None else y + part
        # the aux loss: E * sum(mean probability x share of first
        # choices), both over the global tokens
        if valid is not None:
            probs = probs * valid[:, None]
        me = _comm.reduce_from(probs.sum(0), self._token_group) / T
        self.aux_loss = torch.sum(me * (first.to(torch.float32) / T)) * E
        self.dispatched = torch.stack([(r < E * C).sum() for r in rows])
        return y.reshape(B, S, H)


def _gating_dense(logits, cap, top_k):
    """The reference's gates (``_top2_gating``, ``_top1_gating``) on one
    rank: ``(combine, dispatch, aux)``, combine and dispatch ``[T, E,
    C]`` in fp32."""
    T, E = logits.shape
    probs = torch.softmax(logits.to(torch.float32), dim=-1)

    def one_hot(i, n):
        return (i[:, None] == torch.arange(n, device=i.device)).to(
            probs.dtype)

    mask1 = one_hot(torch.argmax(probs, -1), E)
    pos1 = torch.cumsum(mask1, 0) * mask1 - mask1
    keep1 = mask1 * (pos1 < cap)
    g1 = torch.sum(probs * keep1, -1)
    loc1 = torch.sum(pos1 * keep1, -1).to(torch.int64)
    combine = g1[:, None, None] * keep1[:, :, None] \
        * one_hot(loc1, cap)[:, None, :]
    if top_k == 2:
        mask2 = one_hot(torch.argmax(probs * (1.0 - mask1), -1), E)
        pos2 = (torch.cumsum(mask2, 0) - mask2
                + torch.sum(mask1, 0, keepdim=True)) * mask2
        keep2 = mask2 * (pos2 < cap)
        g2 = torch.sum(probs * keep2, -1)
        denom = torch.clamp(g1 + g2, min=1e-9)
        g1, g2 = g1 / denom, g2 / denom
        loc2 = torch.sum(pos2 * keep2, -1).to(torch.int64)
        combine = (g1[:, None, None] * keep1[:, :, None]
                   * one_hot(loc1, cap)[:, None, :]
                   + g2[:, None, None] * keep2[:, :, None]
                   * one_hot(loc2, cap)[:, None, :])
    dispatch = (combine > 0).to(probs.dtype)
    aux = torch.sum(torch.mean(probs, 0) * torch.mean(mask1, 0)) * E
    return combine, dispatch, aux


def moe_dense(x, gate_weight, w_in, w_out, top_k=2, capacity_factor=1.25,
              activation="gelu"):
    """The plain version of :class:`MoELayer` on one rank: the
    reference's dense one-hot routing and einsums. Returns ``(y,
    aux_loss, dispatch)``."""
    _check_top_k(top_k)
    B, S, H = x.shape
    E = gate_weight.shape[1]
    dt = x.dtype
    cap = capacity(top_k, B * S, E, capacity_factor)
    tokens = x.reshape(B * S, H)
    combine, dispatch, aux = _gating_dense(
        tokens @ gate_weight.to(dt), cap, top_k)
    buf = torch.einsum("tec,th->ech", dispatch.to(dt), tokens)
    h = _ACT[activation](torch.einsum("ech,ehf->ecf", buf, w_in.to(dt)))
    out = torch.einsum("ecf,efh->ech", h, w_out.to(dt))
    y = torch.einsum("tec,ech->th", combine.to(dt), out)
    return y.reshape(B, S, H), aux, dispatch
