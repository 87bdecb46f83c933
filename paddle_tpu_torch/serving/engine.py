"""Continuous-batching decode engine over the block KV pool.

Counterpart of ``paddle_tpu/serving/engine.py``. Requests of unequal
prompt and output lengths share one decode step: per-lane block tables
and valid lengths are *data*, so admission, eviction and growth never
change a shape. Three phase programs serve the engine's lifetime:

- **prefill chunk** ``[1, C]``: one lane's context enters the pool C
  tokens at a time (a padded tail chunk writes only below the context
  length — pads are redirected to the null block), and the final chunk
  samples the first generated token from the last real position. With
  the prefix cache on (``PT_SERVE_PREFIX_CACHE``, default) prefill
  starts at the first token not covered by acquired shared blocks.
- **decode step** ``[L, 1]``: every occupied lane advances one token —
  write the pending token's K/V at ``pool_len``, attend over the lane's
  blocks up to that slot, greedy-sample the next. With the paged read
  on (the default) the attention is the hand-written CUDA kernel
  ``ops/cuda/paged_attention.py::paged_attend`` (``paged_attend_int8``
  for int8 pools), once per layer.
- **verify step** ``[L, k+1]`` (speculative decoding, ``PT_SERVE_SPEC``):
  when the host-side drafter (:mod:`.speculative`) proposed tokens for
  any lane, every lane's pending token plus its (possibly empty) draft
  is scored in one pass; the host accepts each lane's longest prefix
  matching the step's own greedy argmaxes, plus one bonus token.
  Rejected positions roll back by rewinding ``pool_len`` only (the tail
  blocks are lane-private).

Prefill and verify attend with the dense gathered read
(:func:`_attend_lanes`), as in the reference. Under tensor parallelism
(mp > 1) each rank runs the phases on its own shards and its own heads'
pools (``models/generation.py``'s note); the scheduler, the prefix
cache, the drafter and preemption run on the host alike on every rank,
which sees the same tokens. The layer math reuses
``models/generation.py``'s helpers, so engine outputs are
token-identical to per-request greedy ``generate()`` calls, with
``int8_weights`` to ``generate(int8_weights=True)``'s.

**Each phase program is built once.** The reference compiles the three
programs in ``warmup()``/``_ensure_compiled`` through
``jit/exec_cache.get_or_compile``; on a CUDA device the port captures
each as a CUDA graph through ``jit/exec_cache.get_or_capture`` (in
:meth:`ServingEngine.warmup`, or lazily in the first :meth:`step`), and
a round copies its host-built inputs (block tables, lengths, tokens —
every per-round value, packed into one int32 buffer per phase) into the
graph's static buffer and replays it. No phase function runs eagerly
on CUDA, apart from the one warm-up call of each capture and the phases
of a tensor-parallel engine whose collectives go through the host
(gloo; :meth:`ServingEngine._ensure_graphs`), and a capture that fails
raises with the phase's name. The graph key holds what the
reference's key holds (pool shape and dtype, ``kv_int8``,
``int8_weights``, the model config, lanes, M, C, k) plus the addresses
of the weights and pools the graph binds; the pools of a collected
engine go to the next engine of the same geometry, so its keys hit.
What stays eager: the host side of a round (scheduler, drafter,
packing the inputs, emitting tokens) and, on the CPU, the phase
functions themselves.

Unlike the reference, whose programs return new pools (donated on the
TPU), the port updates its pools **in place**: ``kpool[li, blk, off] =
k``. Pad and idle-lane writes all land on null block 0; with duplicate
indices their order is undefined, which is harmless only because no
live lane's visible slot ever maps to block 0 (idle lanes read it, and
their outputs are dropped).

Host syncs: one per admission (the first token) and one per decode or
verify round (the sampled tokens), as in the reference. The reference's
monitor, blackbox, live-telemetry and span hooks are not ported yet;
the always-on plain-int ``counters`` are, with ``graph_captures`` and
``graph_replays`` beside them.
"""
from __future__ import annotations

import functools
import math
import os
import time
import weakref

import numpy as np
import torch

from ..distributed import _comm
from ..framework.device import resolve_device
from ..framework.dtype import to_torch_dtype
from ..jit import exec_cache
from ..models.generation import (
    _GenCfg, _check_model_device, _collect_params, _embed, _kv_per_head,
    _layer, _logits, _mlp, _qkv, _row, _tensor_parallel,
)
from ..nn.functional.norm import rms_norm
from ..ops.cuda import paged_attention as pa
from ..quantization import dequantize_kv, quantize_kv
from .kv_cache import BlockPool, blocks_needed
from .scheduler import RUNNING, FCFSScheduler, Request
from .speculative import NgramDrafter

_EMPTY_DRAFT = np.zeros((0,), np.int32)

__all__ = ["ServingConfig", "ServingEngine"]


def _env_int(name, default):
    v = os.environ.get(name)
    return int(v) if v else default


class ServingConfig:
    """Engine geometry. Every field has the reference's ``PT_SERVE_*``
    env default:

    - ``max_lanes`` (``PT_SERVE_LANES``, 8): decode-batch width.
    - ``block_size`` (``PT_SERVE_BLOCK``, 16): tokens per KV block.
    - ``num_blocks`` (``PT_SERVE_BLOCKS``): pool size incl. the reserved
      null block; default sizes every lane for ``max_seq_len``.
    - ``prefill_chunk`` (``PT_SERVE_PREFILL_CHUNK``, 32): prefill width.
    - ``max_seq_len`` (``PT_SERVE_MAX_LEN``): per-request prompt+output
      ceiling; defaults to the model's max_position_embeddings.
    - ``int8_weights`` (``PT_DECODE_INT8``): weight-only int8 matmuls,
      the same packs as ``generate(int8_weights=True)``.
    - ``kv_int8`` (``PT_SERVE_KV_INT8``, off): int8 block pool with
      paired fp32 per-position scales, quantized on write
      (``quantization.quantize_kv``) and dequantized on read.
    - ``paged`` (``PT_SERVE_PAGED``): decode-attention read path.
      ``"auto"`` (default) and ``"1"`` engage the paged kernel for every
      decode round (the reference's auto mode consults a TPU tune table
      that the port does not have); ``"0"`` keeps the dense gathered
      read.
    - ``prefix_cache`` (``PT_SERVE_PREFIX_CACHE``, on): ref-counted
      prefix sharing in the block pool.
    - ``spec`` (``PT_SERVE_SPEC``, auto = on) and ``spec_k``
      (``PT_SERVE_SPEC_K``, 4): speculative decoding; ``spec_k=0`` is
      plain decode.
    """

    def __init__(self, max_lanes=None, block_size=None, num_blocks=None,
                 prefill_chunk=None, max_seq_len=None, int8_weights=None,
                 paged=None, prefix_cache=None, spec=None, spec_k=None,
                 kv_int8=None):
        self.max_lanes = max_lanes if max_lanes is not None \
            else _env_int("PT_SERVE_LANES", 8)
        self.block_size = block_size if block_size is not None \
            else _env_int("PT_SERVE_BLOCK", 16)
        self.num_blocks = num_blocks if num_blocks is not None \
            else _env_int("PT_SERVE_BLOCKS", 0) or None
        self.prefill_chunk = prefill_chunk if prefill_chunk is not None \
            else _env_int("PT_SERVE_PREFILL_CHUNK", 32)
        self.max_seq_len = max_seq_len if max_seq_len is not None \
            else _env_int("PT_SERVE_MAX_LEN", 0) or None
        if int8_weights is None:
            int8_weights = os.environ.get("PT_DECODE_INT8") == "1"
        self.int8_weights = bool(int8_weights)
        if kv_int8 is None:
            kv_int8 = os.environ.get("PT_SERVE_KV_INT8") == "1"
        self.kv_int8 = bool(kv_int8)
        if paged is None:
            paged = os.environ.get("PT_SERVE_PAGED", "auto")
        if paged in (True, 1, "1", "on"):
            self.paged = "on"
        elif paged in (False, 0, "0", "off"):
            self.paged = "off"
        else:
            self.paged = "auto"
        if prefix_cache is None:
            prefix_cache = os.environ.get(
                "PT_SERVE_PREFIX_CACHE", "1") not in ("0", "off")
        self.prefix_cache = bool(prefix_cache)
        if spec is None:
            spec = os.environ.get("PT_SERVE_SPEC", "auto")
        # "auto" == on: the engine is greedy-only, and greedy is exactly
        # where verification preserves token identity for free
        self.spec = spec not in (False, 0, "0", "off")
        self.spec_k = spec_k if spec_k is not None \
            else _env_int("PT_SERVE_SPEC_K", 4)
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {self.spec_k}")
        if self.spec_k == 0:
            self.spec = False  # k=0 IS plain decode; skip the program
        for name in ("max_lanes", "block_size", "prefill_chunk"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, "
                                 f"got {getattr(self, name)}")


# -- phase programs -----------------------------------------------------------

def _attend_lanes(q, kc, vc, pos, cfg):
    """``models/generation.py:_attend`` with PER-TOKEN positions: q
    ``[b, s, nh, d]`` against the gathered block slots kc/vc
    ``[b, S, nkv, d]``. Slot ``l`` is visible to the query at absolute
    position ``p = pos[b, t]`` iff ``l <= p`` (block tables lay a lane's
    positions out in order, so slot index == absolute position). Same
    math as ``_attend``: fp32 einsum, 1/sqrt(d), -1e30 mask, fp32
    softmax and AV."""
    b, s, nh, d = q.shape
    S = kc.shape[1]
    kc, g = _kv_per_head(kc, cfg)
    vc, _ = _kv_per_head(vc, cfg)
    sliding_window = cfg.sliding_window
    dev = q.device
    qg = q.reshape(b, s, nh // g, g, d)
    logits = torch.einsum("bskgd,blkd->bskgl", qg.to(torch.float32),
                          kc.to(torch.float32)) / math.sqrt(d)
    slots = torch.arange(S, device=dev)[None, None, :]
    vis = slots <= pos[:, :, None]  # [b, s, S]
    if sliding_window > 0:
        vis &= slots > pos[:, :, None] - sliding_window
    logits = torch.where(vis[:, :, None, None, :], logits,
                         torch.full((), -1e30, device=dev))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bskgl,blkd->bskgd", p, vc.to(torch.float32))
    return out.reshape(b, s, nh, d).to(q.dtype)


def _pool_forward(params, kpool, vpool, kscale, vscale, tables, ids, pos,
                  wlimit, cfg, paged=False, tp=None):
    """Forward ``ids`` ``[b, s]`` at absolute positions ``pos``
    ``[b, s]`` against the block pool: per layer, write each token's K/V
    into its lane's block at ``pos`` — in place; writes at positions
    ``>= wlimit[b]`` (pad tail of a prefill chunk or draft, idle lanes)
    go to null block 0 — then attend. ``kscale``/``vscale`` are the int8
    mode's fp32 scale pools (None otherwise). With ``paged`` and
    ``s == 1`` the attention is the paged kernel; otherwise the dense
    read over each lane's whole gathered table. Returns x
    ``[b, s, hidden]``. Under tensor parallelism (``tp``) the layer math
    is the rank's (``models/generation.py``'s note), and the pools hold
    the kv heads its q heads read."""
    b, s = ids.shape
    nh = cfg.num_attention_heads
    nkv = cfg.num_key_value_heads
    d = cfg.head_dim
    B = kpool.shape[2]
    M = tables.shape[1]
    dt = to_torch_dtype(cfg.dtype)
    quant = kscale is not None
    x = _embed(params, ids, dt, tp)
    # pad positions can run past the table
    idx = torch.clamp_max(pos // B, M - 1).long()
    blk = torch.gather(tables, 1, idx)
    ok = pos < wlimit[:, None]
    blk = torch.where(ok, blk, 0).long()
    off = torch.where(ok, pos % B, 0).long()
    tab = tables.long()
    paged = paged and s == 1
    cur = pos[:, 0].contiguous() if paged else None
    for li in range(params["ln1"].shape[0]):
        layer_p = _layer(params, li)
        q, k, v = _qkv(x, layer_p, pos, cfg)
        if quant:
            k, k_s = quantize_kv(k)
            v, v_s = quantize_kv(v)
            kscale[li, blk, off] = k_s
            vscale[li, blk, off] = v_s
        kpool[li, blk, off] = k
        vpool[li, blk, off] = v
        if nh == 0:  # a tensor-parallel rank without heads adds nothing
            out = q
        elif paged:
            qd = q.reshape(b, nh, d)
            heads = dict(window=cfg.sliding_window, kv_group=cfg.kv_group,
                         head_offset=cfg.head_offset)
            if quant:
                out = pa.paged_attend_int8(
                    qd, kpool[li], vpool[li], kscale[li], vscale[li],
                    tables, cur, **heads)
            else:
                out = pa.paged_attend(qd, kpool[li], vpool[li], tables, cur,
                                      **heads)
            out = out[:, None]
        else:
            kc = kpool[li][tab].reshape(b, M * B, nkv, d)
            vc = vpool[li][tab].reshape(b, M * B, nkv, d)
            if quant:
                kc = dequantize_kv(
                    kc, kscale[li][tab].reshape(b, M * B, nkv), dt)
                vc = dequantize_kv(
                    vc, vscale[li][tab].reshape(b, M * B, nkv), dt)
            out = _attend_lanes(q, kc, vc, pos, cfg)
        x = x + _row(out.reshape(b, s, nh * d), layer_p["o"], tp)
        x = _mlp(x, layer_p, cfg, tp)
    return x


def _greedy(x, params, cfg, tp=None):
    """(greedy tokens, fp32 logits) of the final hidden states ``x``
    (under tensor parallelism the whole vocabulary's, on every rank)."""
    x = rms_norm(x, params["norm"], cfg.rms_norm_eps)
    logits = _logits(x, params, tp)
    return torch.argmax(logits, dim=-1).to(torch.int32), logits


def _prefill_chunk(params, kpool, vpool, kscale, vscale, table, ids, start,
                   ctx_len, last_idx, *, cfg, tp=None):
    """One lane's prefill chunk: ``ids`` ``[1, C]`` at positions
    ``[start, start+C)``, writes below ``ctx_len``; greedy-samples from
    position ``last_idx`` within the chunk (``start``, ``ctx_len`` and
    ``last_idx`` are int32 ``[1]`` tensors). Returns tok ``[1]`` and its
    logits."""
    C = ids.shape[1]
    pos = (start + torch.arange(C, dtype=torch.int32,
                                device=ids.device))[None, :]
    x = _pool_forward(params, kpool, vpool, kscale, vscale, table, ids, pos,
                      ctx_len, cfg, tp=tp)
    return _greedy(x[0, last_idx.long()], params, cfg, tp)


def _decode_step(params, kpool, vpool, kscale, vscale, tables, cur_len,
                 last_tok, *, cfg, paged=False, tp=None):
    """Every lane feeds its pending token at position ``cur_len``
    (write-then-attend, so the token sees itself) and greedy-samples the
    next. Idle lanes (cur_len 0, table row 0) write to the null block;
    their outputs are ignored host-side. Returns tok ``[L]`` and its
    logits."""
    x = _pool_forward(params, kpool, vpool, kscale, vscale, tables,
                      last_tok[:, None], cur_len[:, None], cur_len + 1, cfg,
                      paged=paged, tp=tp)
    return _greedy(x[:, -1], params, cfg, tp)


def _verify_step(params, kpool, vpool, kscale, vscale, tables, cur_len, toks,
                 wlimit, *, cfg, tp=None):
    """The speculative verify step: ``toks`` ``[L, k+1]`` holds each
    lane's pending token then its draft, at positions ``cur_len + j``;
    writes at ``>= wlimit[b]`` go to the null block. Returns the greedy
    argmaxes ``[L, k+1]`` — the tokens plain decode WOULD emit after
    each draft prefix — and their logits."""
    S = toks.shape[1]
    pos = cur_len[:, None] + torch.arange(S, dtype=torch.int32,
                                          device=toks.device)[None, :]
    x = _pool_forward(params, kpool, vpool, kscale, vscale, tables, toks,
                      pos, wlimit, cfg, tp=tp)
    return _greedy(x, params, cfg, tp)


def _layouts(L, M, C, k):
    """Each phase's per-round inputs, int32, in the order they lie in the
    phase's one input buffer (``k == 0``: no verify phase)."""
    out = {"decode": (("tables", (L, M)), ("cur_len", (L,)),
                      ("last_tok", (L,))),
           "prefill": (("table", (1, M)), ("ids", (1, C)), ("start", (1,)),
                       ("ctx_len", (1,)), ("last_idx", (1,)))}
    if k:
        out["verify"] = (("tables", (L, M)), ("cur_len", (L,)),
                         ("toks", (L, k + 1)), ("wlimit", (L,)))
    return out


def _packed(fn, layout, *, flat, **state):
    """``fn`` (a phase function) on the engine's ``state`` (weights,
    pools) and the round's inputs, unpacked as views of ``flat``."""
    views, i = {}, 0
    for name, shape in layout:
        n = math.prod(shape)
        views[name] = flat[i:i + n].view(shape)
        i += n
    return fn(**state, **views)


# pools of collected engines, one spare set per geometry: the next engine
# of that geometry takes it (zeroed), so its graph keys, which name the
# pools' addresses, hit the exec cache
_SPARE_POOLS: dict = {}


# -- the engine ---------------------------------------------------------------

class ServingEngine:
    """Submit requests, call :meth:`step` (or :meth:`run`) — the engine
    admits, prefills, decodes and reclaims between steps. ``device``
    (default ``"cuda"``) must be where the model lives; the CPU is used
    only when asked for."""

    def __init__(self, model, config: ServingConfig | None = None,
                 drafter=None, *, device="cuda"):
        if getattr(model.config, "moe_num_experts", 0) > 1:
            raise NotImplementedError(
                "ServingEngine does not decode MoE Llama configs (the "
                "reference refuses them too, as generate() does)")
        self.device = resolve_device(device)
        _check_model_device(model, self.device)
        self.model = model
        self.config = config or ServingConfig()
        cfg = self.config
        # under tensor parallelism the rank's shards, heads and pools
        self._tp = _tensor_parallel(model)
        self._gcfg = _GenCfg(model.config, self._tp)
        self._params = _collect_params(model,
                                       int8_weights=cfg.int8_weights)
        self.max_seq_len = int(cfg.max_seq_len
                               or model.config.max_position_embeddings)
        self.blocks_per_lane = blocks_needed(self.max_seq_len,
                                             cfg.block_size)
        num_blocks = int(cfg.num_blocks
                         or cfg.max_lanes * self.blocks_per_lane + 1)
        nkv = self._gcfg.num_key_value_heads
        d = self._gcfg.head_dim
        layers = self._params["ln1"].shape[0]
        dt = torch.int8 if cfg.kv_int8 else to_torch_dtype(self._gcfg.dtype)
        shape = (layers, num_blocks, cfg.block_size, nkv, d)
        pool_key = (shape, dt, cfg.kv_int8, self.device)
        pools = _SPARE_POOLS.pop(pool_key, None)
        if pools is None:
            # int8 mode: paired per-position fp32 amax scales (null block
            # included — masked writes land there like K/V pad writes do)
            scales = (torch.zeros(shape[:-1], dtype=torch.float32,
                                  device=self.device)
                      for _ in range(2 if cfg.kv_int8 else 0))
            pools = (torch.zeros(shape, dtype=dt, device=self.device),
                     torch.zeros(shape, dtype=dt, device=self.device),
                     *scales)
        else:
            for t in pools:
                t.zero_()
        weakref.finalize(self, _SPARE_POOLS.setdefault, pool_key, pools)
        self._kpool, self._vpool = pools[:2]
        self._kscale, self._vscale = pools[2:] if cfg.kv_int8 \
            else (None, None)
        self.kv_pool_bytes = sum(
            t.numel() * t.element_size() for t in
            (self._kpool, self._vpool, self._kscale, self._vscale)
            if t is not None)
        self.scheduler = FCFSScheduler(
            BlockPool(num_blocks, cfg.block_size), cfg.max_lanes,
            self.blocks_per_lane, self.max_seq_len,
            prefix_cache=cfg.prefix_cache)
        # live (waiting/running) requests only; finished ones move to
        # _finished until collected
        self._requests: dict = {}
        self._finished: dict = {}
        self.spec_active = bool(cfg.spec and cfg.spec_k > 0)
        self.drafter = drafter if drafter is not None \
            else (NgramDrafter() if self.spec_active else None)
        self.paged_active = cfg.paged != "off"
        self._paged_family = ("paged_attention_int8" if cfg.kv_int8
                              else "paged_attention")
        # always-on plain-int accounting, same keys as the reference.
        # kv_read_tokens counts the LIVE prefix (what the paged kernel
        # reads); kv_dense_read_tokens the full-table slots the dense
        # gather reads. prefix_{hit,miss}_tokens split every
        # (re-)prefilled context; spec_* are post-trim.
        self.counters = {
            "admits": 0, "finished": 0, "preemptions": 0,
            "prefill_chunks": 0, "decode_steps": 0, "verify_steps": 0,
            "decoded_tokens": 0,
            "spec_proposed_tokens": 0, "spec_accepted_tokens": 0,
            "spec_bonus_tokens": 0,
            "prefix_hit_tokens": 0, "prefix_miss_tokens": 0,
            "kv_read_tokens": 0, "kv_dense_read_tokens": 0,
            "kv_quant_writes": 0, "kv_quant_tokens": 0,
            "decode_wall_s": 0.0,
            "graph_captures": 0, "graph_replays": 0,
        }
        # the phase programs: each phase function on the engine's state
        # and one packed int32 input buffer; on CUDA captured as graphs
        # (_ensure_graphs), on the CPU called eagerly
        self._state = dict(params=self._params, kpool=self._kpool,
                           vpool=self._vpool, kscale=self._kscale,
                           vscale=self._vscale)
        self._layouts = _layouts(cfg.max_lanes, self.blocks_per_lane,
                                 cfg.prefill_chunk,
                                 cfg.spec_k if self.spec_active else 0)
        run = dict(cfg=self._gcfg, tp=self._tp)
        fns = {"decode": functools.partial(_decode_step, **run,
                                           paged=self.paged_active),
               "prefill": functools.partial(_prefill_chunk, **run),
               "verify": functools.partial(_verify_step, **run)}
        self._programs = {ph: functools.partial(_packed, fns[ph], layout)
                          for ph, layout in self._layouts.items()}
        self._graphs = None

    # -- intake --------------------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens=32, eos_token_id=None,
               request_id=None) -> Request:
        """Queue one request (prompt as a 1-D list, numpy array or CPU or
        CUDA ``torch.Tensor`` of ints). Returns the :class:`Request`;
        drive it with :meth:`step` / :meth:`run`."""
        if isinstance(prompt_ids, torch.Tensor):
            prompt_ids = prompt_ids.detach().cpu().numpy()
        req = Request(prompt_ids, max_new_tokens=max_new_tokens,
                      eos_token_id=eos_token_id, request_id=request_id)
        if (req.request_id in self._requests
                or req.request_id in self._finished):
            raise ValueError(
                f"duplicate request_id {req.request_id!r} (live or "
                f"finished-but-uncollected — pop_finished() first)")
        req.t_submit = time.perf_counter()
        req._t_mark = req.t_submit  # attribution clock starts here
        self.scheduler.submit(req)
        self._requests[req.request_id] = req
        return req

    @torch.no_grad()
    def warmup(self) -> None:
        """Capture (or take from the exec cache) the phase programs now,
        so the first request pays no capture and no kernel build. A no-op
        on the CPU, where the phases run eagerly."""
        self._ensure_graphs()

    def _graph_key(self, phase) -> dict:
        """The reference's ``_ensure_compiled`` key fields, plus the
        addresses of every buffer the graph binds."""
        cfg = self.config
        params = [t for k in sorted(self._params) for t in
                  (self._params[k].values()
                   if isinstance(self._params[k], dict)
                   else (self._params[k],))]
        extra = {"decode": {"paged": self.paged_active},
                 "prefill": {"chunk": cfg.prefill_chunk},
                 "verify": {"k": cfg.spec_k}}[phase]
        return {"kind": f"serving_{phase}", "gen_cfg": self._gcfg._key(),
                "params": [(exec_cache.array_spec(t), t.data_ptr())
                           for t in params],
                "pool": (tuple(self._kpool.shape), str(self._kpool.dtype)),
                "pool_ptrs": [t.data_ptr() for t in
                              (self._kpool, self._vpool, self._kscale,
                               self._vscale) if t is not None],
                "kv_int8": cfg.kv_int8, "int8_weights": cfg.int8_weights,
                "lanes": cfg.max_lanes, "m": self.blocks_per_lane, **extra}

    def _ensure_graphs(self) -> None:
        """On CUDA: every phase program as a graph from
        ``exec_cache.get_or_capture``, once per engine. Under tensor
        parallelism the phases hold collectives, so each phase's first
        call runs eagerly (on zero inputs, whose writes land in the null
        block, as a capture's warm-up call does) and the phase is
        captured only if none of its collectives was host-staged
        (``_comm.host_staged``: gloo, which two ranks sharing one card
        run); else it stays eager, as ``jit.TrainStep`` does."""
        if self._graphs is not None or self.device.type != "cuda":
            return
        graphs = {}
        for phase, program in self._programs.items():
            n = sum(math.prod(shape) for _, shape in self._layouts[phase])
            state = dict(self._state, flat=torch.zeros(
                n, dtype=torch.int32, device=self.device))
            if self._tp is not None and self._host_staged(program, state):
                continue  # eager: _run calls the program itself
            before = exec_cache.stats()["captures"]
            graphs[phase] = exec_cache.get_or_capture(
                self._graph_key(phase), program, state,
                label=f"serving_{phase}",
                counters=(pa.paged_attend, pa.paged_attend_int8),
                warmup=self._tp is None)
            self.counters["graph_captures"] += \
                exec_cache.stats()["captures"] - before
        self._graphs = graphs

    def _host_staged(self, program, state) -> bool:
        """Whether one call of ``program`` on ``state`` ran a collective
        through the host; the call runs on the capture stream and counts
        no kernel launch (it is no round of the engine)."""
        launches = [(w, w.launches) for w in (pa.paged_attend,
                                              pa.paged_attend_int8)]
        side = exec_cache.side_stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        mark = _comm.host_staged()
        with torch.cuda.stream(side):
            program(**state)
        torch.cuda.current_stream(self.device).wait_stream(side)
        for w, n in launches:
            w.launches = n
        return _comm.host_staged() != mark

    def _pack(self, phase, **inputs) -> np.ndarray:
        """A phase's host-built inputs as its one int32 buffer."""
        return np.concatenate([np.asarray(inputs[name], np.int32).ravel()
                               for name, _ in self._layouts[phase]])

    def _run(self, phase, **inputs) -> torch.Tensor:
        """One call of a phase program on host-built int32 ``inputs``:
        a graph replay on CUDA, an eager call on the CPU and for a phase
        left eager (``_ensure_graphs``). Returns the sampled tokens (a
        graph's output is overwritten by its next replay)."""
        flat = self._pack(phase, **inputs)
        entry = (self._graphs or {}).get(phase)
        if entry is None:
            return self._programs[phase](
                flat=torch.from_numpy(flat).to(self.device),
                **self._state)[0]
        entry.inputs["flat"].copy_(torch.from_numpy(flat).pin_memory(),
                                   non_blocking=True)
        self.counters["graph_replays"] += 1
        return entry.replay()[0]

    # -- the step loop -------------------------------------------------------

    @torch.no_grad()
    def step(self) -> bool:
        """One scheduling round: admit + prefill newly admitted lanes
        (they join this same round's decode — continuous batching), run
        the shared decode (or verify) step, emit/reclaim. Returns whether
        any work was done. Admission is one lane at a time with the
        prefill (and its prefix publish) in between, so burst arrivals
        sharing a prompt hit the cache from the second lane on."""
        self._ensure_graphs()
        worked = False
        while True:
            admitted = self.scheduler.admit(limit=1)
            if not admitted:
                break
            worked = True
            self.counters["admits"] += 1
            self._prefill(admitted[0])
        if self.scheduler.has_running():
            self._decode_round()
            worked = True
        return worked

    def run(self) -> dict:
        """Drain: step until no request is waiting or running, then
        collect-and-retire — returns ``{request_id: np.ndarray(generated
        tokens)}`` for every request finished since the last
        collection."""
        while self.scheduler.has_work():
            self.step()
        return self.pop_finished()

    def pop_finished(self) -> dict:
        """Collect + retire finished requests (see :meth:`run`)."""
        out = {rid: np.asarray(r.output)
               for rid, r in self._finished.items()}
        self._finished.clear()
        return out

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    # -- phases --------------------------------------------------------------

    def _prefill(self, req) -> None:
        """Fill the lane's blocks chunk by chunk — starting at
        ``cached_len``, the span already covered by acquired prefix-cache
        blocks (block-aligned, capped at ctx-1, so at least one chunk
        always runs and every write lands in a private block) — and
        greedy-sample the first token on the final chunk. Then publish
        the lane's full blocks to the prefix index. A re-admitted
        (preempted) request only rebuilds the pool: its pending token is
        already known."""
        toks = req.prefill_tokens
        ctx = int(toks.size)
        cached = int(req.cached_len)
        C = self.config.prefill_chunk
        row = np.zeros((1, self.blocks_per_lane), np.int32)
        row[0, :len(req.blocks)] = req.blocks
        p_t0 = req._t_mark  # admission stamped it just before this call
        nchunks = 0
        tok = None
        for start in range(cached, ctx, C):
            piece = toks[start:start + C]
            chunk = np.zeros((1, C), np.int32)
            chunk[0, :piece.size] = piece
            last_idx = ctx - 1 - start if start + C >= ctx else 0
            tok = self._run("prefill", table=row, ids=chunk, start=start,
                            ctx_len=ctx, last_idx=last_idx)
            nchunks += 1
        req.pool_len = ctx
        self.scheduler.publish_prefix(req)
        c = self.counters
        c["prefill_chunks"] += nchunks
        c["prefix_hit_tokens"] += cached
        c["prefix_miss_tokens"] += ctx - cached
        if self.config.kv_int8:
            c["kv_quant_writes"] += nchunks
            c["kv_quant_tokens"] += ctx - cached
        # recompute-refund: cached tokens on a re-admission are context
        # the preemption forced us to rebuild but the cache served back
        req.prefill_refunded_tokens += cached if req.output else 0
        first_tok = None
        if not req.output:
            first_tok = int(tok[0].item())  # the TTFT host sync
        end = time.perf_counter()
        if p_t0 is not None:
            req.prefill_ms += (end - p_t0) * 1e3
            req._t_mark = end
        if req.output:
            return  # recompute path: the pending token is output[-1]
        self._emit(req, first_tok, end)

    def _decode_round(self) -> None:
        sched = self.scheduler
        # growth walks FCFS order so older requests claim blocks first;
        # a victim preempted mid-walk is skipped by the state check
        for req in sched.running():
            if req.state == RUNNING:
                sched.ensure_capacity(req, on_preempt=self._note_preempt)
        act = sched.running()
        if not act:
            return
        drafts = self._draft(act) if self.spec_active else {}
        if any(d.size for d in drafts.values()):
            self._verify_round(act, drafts)
        else:
            self._plain_decode_round(act)

    def _draft(self, act) -> dict:
        """Per-lane draft proposals for this round, keyed by ``id(req)``
        — trimmed to the request's remaining-token budget and to the
        blocks the pool can back WITHOUT preempting anyone
        (``scheduler.grow_for_draft``)."""
        k = self.config.spec_k
        drafts = {}
        for req in act:
            cap = min(k, req.max_new_tokens - len(req.output) - 1)
            d = _EMPTY_DRAFT
            if cap > 0:
                ctx = np.concatenate(
                    [req.prompt, np.asarray(req.output, np.int32)])
                d = np.asarray(self.drafter.propose(ctx, cap),
                               np.int32).reshape(-1)[:cap]
                if d.size:
                    d = d[:self.scheduler.grow_for_draft(
                        req, int(d.size))]
            drafts[id(req)] = d
        return drafts

    def _verify_round(self, act, drafts) -> None:
        """One ``[L, k+1]`` verify step for every occupied lane: accept
        each lane's longest draft prefix matching the step's greedy picks
        plus one bonus token; rejected positions roll back by rewinding
        ``pool_len`` (their K/V sits above it in lane-private blocks until
        overwritten)."""
        L, M = self.config.max_lanes, self.blocks_per_lane
        K = self.config.spec_k
        tables = np.zeros((L, M), np.int32)
        cur = np.zeros((L,), np.int32)
        toks = np.zeros((L, K + 1), np.int32)
        wlim = np.zeros((L,), np.int32)
        for req in act:
            d = drafts.get(id(req), _EMPTY_DRAFT)
            tables[req.lane, :len(req.blocks)] = req.blocks
            cur[req.lane] = req.pool_len
            toks[req.lane, 0] = req.output[-1]
            if d.size:
                toks[req.lane, 1:1 + d.size] = d
            wlim[req.lane] = req.pool_len + 1 + d.size
        t0 = time.perf_counter()
        pred = self._run("verify", tables=tables, cur_len=cur, toks=toks,
                         wlimit=wlim)
        preds = pred.cpu().numpy()  # the round's ONE host sync
        now = time.perf_counter()
        c = self.counters
        c["decode_wall_s"] += now - t0
        c["verify_steps"] += 1
        proposed = accepted = bonus = emitted = 0
        for req in act:
            if req._t_mark is not None:
                req.decode_ms += (now - req._t_mark) * 1e3
                req._t_mark = now
            d = drafts.get(id(req), _EMPTY_DRAFT)
            n = int(d.size)
            row = preds[req.lane]
            a = 0
            while a < n and row[a] == d[a]:
                a += 1
            proposed += n
            accepted += a
            if n:
                req.spec_rounds += 1
                req.accepted_tokens += a
                observe = getattr(self.drafter, "observe", None)
                if observe is not None:
                    observe(d, a)
            # emit the a accepted drafts (== row[:a]) + the bonus token
            # row[a]; stop early when max_new_tokens/eos finishes it
            got = 0
            for j in range(a + 1):
                req.pool_len += 1
                got += 1
                self._emit(req, int(row[j]), now)
                if req.finished:
                    break
            if n and got == a + 1:
                bonus += 1
            emitted += got
            if req.state == RUNNING:
                self.scheduler.release_draft_blocks(req)
        c["decoded_tokens"] += emitted
        c["spec_proposed_tokens"] += proposed
        c["spec_accepted_tokens"] += accepted
        c["spec_bonus_tokens"] += bonus
        # a verify round reads densely (no paged verify kernel), so both
        # byte models bill the full table
        dense_slots = len(act) * M * self.config.block_size
        c["kv_read_tokens"] += dense_slots
        c["kv_dense_read_tokens"] += dense_slots
        if self.config.kv_int8:
            c["kv_quant_writes"] += 1
            c["kv_quant_tokens"] += len(act) + proposed

    def _plain_decode_round(self, act) -> None:
        L, M = self.config.max_lanes, self.blocks_per_lane
        tables = np.zeros((L, M), np.int32)
        cur = np.zeros((L,), np.int32)
        last = np.zeros((L,), np.int32)
        for req in act:
            tables[req.lane, :len(req.blocks)] = req.blocks
            cur[req.lane] = req.pool_len
            last[req.lane] = req.output[-1]
        t0 = time.perf_counter()
        tok = self._run("decode", tables=tables, cur_len=cur, last_tok=last)
        toks = tok.cpu().numpy()  # the round's ONE host sync
        now = time.perf_counter()
        c = self.counters
        c["decode_wall_s"] += now - t0
        c["decode_steps"] += 1
        c["decoded_tokens"] += len(act)
        c["kv_read_tokens"] += sum(r.pool_len + 1 for r in act)
        c["kv_dense_read_tokens"] += len(act) * M * self.config.block_size
        if self.config.kv_int8:
            c["kv_quant_writes"] += 1
            c["kv_quant_tokens"] += len(act)
        for req in act:
            if req._t_mark is not None:
                req.decode_ms += (now - req._t_mark) * 1e3
                req._t_mark = now
            req.pool_len += 1
            self._emit(req, int(toks[req.lane]), now)

    def _emit(self, req, tok: int, now: float) -> None:
        req.output.append(tok)
        if req.t_first is None:
            req.t_first = now
        if (len(req.output) >= req.max_new_tokens
                or (req.eos_token_id is not None
                    and tok == req.eos_token_id)):
            req.t_done = now
            self.scheduler.finish(req)
            self._finished[req.request_id] = \
                self._requests.pop(req.request_id, req)
            self.counters["finished"] += 1

    def _note_preempt(self, req) -> None:
        self.counters["preemptions"] += 1

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        """Plain-int account of the engine's lifetime (always on)."""
        out = dict(self.counters)
        pool = self.scheduler.pool
        out.update(
            decode_rounds=(self.counters["decode_steps"]
                           + self.counters["verify_steps"]),
            spec=self.spec_active,
            spec_k=self.config.spec_k if self.spec_active else 0,
            lanes=self.config.max_lanes,
            block_size=self.config.block_size,
            num_blocks=pool.num_blocks,
            free_blocks=pool.free_count,
            allocatable_blocks=pool.allocatable,
            blocks_per_lane=self.blocks_per_lane,
            max_seq_len=self.max_seq_len,
            prefill_chunk=self.config.prefill_chunk,
            int8_weights=self.config.int8_weights,
            kv_int8=self.config.kv_int8,
            kv_pool_bytes=self.kv_pool_bytes,
            paged_attention=self.paged_active,
            graphs=bool(self._graphs),
            phase_modes={ph: "graph" if ph in (self._graphs or {})
                         else "eager" for ph in self._programs},
            weight_bytes=sum(
                t.numel() * t.element_size() for k in self._params
                for t in (self._params[k].values()
                          if isinstance(self._params[k], dict)
                          else (self._params[k],))),
            paged_family=self._paged_family,
            prefix_cache=self.config.prefix_cache,
            shared_blocks=pool.shared_count,
            cold_blocks=pool.cold_count,
            indexed_blocks=pool.indexed_count,
            lanes_occupied=self.scheduler.lanes_occupied,
            waiting=len(self.scheduler.waiting),
            requests=len(self._requests),
            uncollected=len(self._finished),
            device=str(self.device),
        )
        return out
