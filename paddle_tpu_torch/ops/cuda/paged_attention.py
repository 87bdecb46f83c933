"""Paged-attention decode: hand-written CUDA kernels and their plain
PyTorch versions.

``paged_attend`` replaces the Pallas TPU kernel ``_paged_kernel``
(``paddle_tpu/ops/pallas/paged_attention.py``, ``paged_attend``) and
``paged_attend_int8`` replaces ``_paged_kernel_int8``
(``paged_attend_int8``) there. The serving engine's decode step calls
one of them once per layer: each lane's single pending query attends
over the K/V that its block table points at, slots ``0..pos[lane]``
(and ``> pos - window`` with a sliding window).

What bounds them: bytes. A call reads ``2 * sum(visible slots) * nkv *
d`` K/V elements (plus the int8 scales) once, at about 4 flops per
element, so its least time is those bytes over the card's 3.35 TB/s;
the card gets there only with MB of loads in flight on every SM.

The kernels (``csrc/paged_attention.cu``) are split-K (flash-decoding):
a call is two CUDA launches. The split kernel's grid is (lane, kv head,
split), a split being ``_split_slots`` slots, a whole number of pool
blocks; blocks whose span holds no visible slot exit at once, the
others copy their pool rows to shared memory with 16-byte ``cp.async``
(all of the span's rows in flight together, no registers held by the
copies), and keep an fp32 online softmax per group of lanes; the block
writes its partial ``(m, l, acc)`` to a workspace this wrapper
allocates. The merge kernel, a programmatic dependent launch of the
split grid, combines each (lane, head)'s live splits in split order,
divides by ``max(l, 1e-30)`` and casts to q's dtype. Every sum runs in
a fixed order, so two calls on the same inputs give the same bits.

The split rule (``_split_slots``): about 32 KB of K+V per split (64
slots of bf16 at d 128, 128 of int8), halved while the grid would hold
fewer than two blocks per SM over the whole table. It depends on the
call's shapes and the card's SM count only. ``_split_partials_ref`` and
``_merge_splits_ref`` model the two launches in plain PyTorch; only the
tests call them. Left to later work: TMA copies, a ring across the
steps of long spans, and a persistent grid that skips dead splits.

A rank of a tensor-parallel decode runs them on its own heads: its q
heads ``[L, nh_local, d]`` over a pool of the kv heads they read.
Local q head ``i`` reads pool head ``(i + head_offset) // kv_group``
(``kv_group`` the model's q heads per kv head): when mp divides the kv
heads the offset is 0 and the groups are whole, as on one card; when
it does not, a rank's q heads may start inside a group (12 q over 3 kv
heads at mp 2: rank 1's six read kv heads 1, 1, 2, 2, 2, 2, its pool
holds kv heads 1 and 2, offset 2), and the split kernel's blocks skip
the heads that lie outside the rank's range. The pool then holds only
the kv heads the rank reads, not K and V repeated per q head.

Wrapper rules: CPU tensors go to the plain version
(``paged_attend_ref``/``paged_attend_int8_ref``); CUDA tensors launch
the kernels or raise — there is no fallback. Both paths first check
device, dtype, shape and contiguity. ``paged_attend.launches`` and
``paged_attend_int8.launches`` count calls that launched the kernels,
one per call whatever the number of CUDA launches inside (plain ints;
reset them by assignment).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

__all__ = ["paged_attend", "paged_attend_int8", "paged_attend_ref",
           "paged_attend_int8_ref"]

NEG_INF = -1e30
_MAX_SMEM = 232448  # bytes a block may use on sm_90 (227 KB)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1,  # paged_attention.cu
               torch.float16: 2}
_SPLIT_BYTES = 32 * 1024  # K+V bytes one split block reads


def _heads_per_block(g, d, elt):
    """csrc/paged_attention.cu::launch: query heads one split block takes
    (a power of two; at most 8, or 4 where a lane holds 16 columns)."""
    nvec = d * elt // 16
    cols = (2 if nvec > 32 else 1) * 16 // elt
    return min(1 << (g - 1).bit_length(), 8 if cols <= 8 else 4)


def _smem_bytes(g, d, B, split, elt):
    """csrc/paged_attention.cu::smem_bytes: the split kernel's shared
    memory, each thread's staged rows (which the warps' [gt, d]
    accumulators, max and sum reuse) and the split's table entries."""
    gt = _heads_per_block(g, d, elt)
    vpl = 2 if d * elt // 16 > 32 else 1
    f = gt * vpl * 16 // elt
    ahead = 8 if f <= 16 else 4 if f <= 32 else 2  # rows_ahead
    stage = 2 * ahead * vpl * 128 * 16
    merge = 4 * (4 * gt * d + 2 * 4 * gt)
    return max(stage, merge) + 4 * (split // B)


def _split_slots(L, nkv, M, B, row_bytes, n_sm):
    """Slots per split, a whole number of pool blocks: about
    ``_SPLIT_BYTES`` of K+V (``row_bytes`` per pool row), halved while
    the grid over the whole table would hold fewer than two blocks per
    SM."""
    nb = min(M, max(1, -(-_SPLIT_BYTES // (2 * row_bytes * B))))
    while nb > 1 and L * nkv * -(-M // nb) < 2 * n_sm:
        nb //= 2
    return nb * B


@functools.cache
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q, kpool, vpool, kscale, vscale, tables, pos, window, kv_group,
           head_offset):
    """Raise ``ValueError`` on anything the kernel does not take."""
    quant = kscale is not None
    named = [("q", q), ("kpool", kpool), ("vpool", vpool),
             ("tables", tables), ("pos", pos)]
    if quant:
        named += [("kscale", kscale), ("vscale", vscale)]
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name} must be a torch.Tensor")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 3 or kpool.dim() != 4:
        raise ValueError(f"q must be [L, nh, d] and kpool [num_blocks, B, "
                         f"nkv, d]; got {tuple(q.shape)}, "
                         f"{tuple(kpool.shape)}")
    L, nh, d = q.shape
    nblocks, B, nkv, dk = kpool.shape
    if vpool.shape != kpool.shape or vpool.dtype != kpool.dtype:
        raise ValueError("vpool must match kpool in shape and dtype")
    if dk != d:
        raise ValueError(f"head_dim of q ({d}) and the pools ({dk}) differ")
    if d % 8 or d > 256:
        raise ValueError(f"head_dim must be a multiple of 8 and <= 256, "
                         f"got {d}")
    if kv_group is None:
        if nkv < 1 or nh % nkv:
            raise ValueError(f"num_heads {nh} is not a multiple of kv "
                             f"heads {nkv}")
    elif not (isinstance(kv_group, int) and isinstance(head_offset, int)
              and kv_group >= 1 and 0 <= head_offset < kv_group
              and (nh - 1 + head_offset) // kv_group < nkv):
        raise ValueError(f"kv_group {kv_group!r} and head_offset "
                         f"{head_offset!r} do not map {nh} q heads onto "
                         f"{nkv} kv heads")
    if tables.dim() != 2 or tables.shape[0] != L \
            or tables.dtype != torch.int32:
        raise ValueError(f"tables must be int32 [L={L}, M]")
    if pos.shape != (L,) or pos.dtype != torch.int32:
        raise ValueError(f"pos must be int32 [L={L}]")
    if not isinstance(window, int) or window < 0:
        raise ValueError(f"window must be an int >= 0, got {window!r}")
    if quant:
        if kpool.dtype != torch.int8:
            raise ValueError("paged_attend_int8 takes int8 pools")
        if d % 16:
            raise ValueError(f"int8 pools need head_dim % 16 == 0 (16-byte "
                             f"loads), got {d}")
        for name, s in (("kscale", kscale), ("vscale", vscale)):
            if s.shape != (nblocks, B, nkv) or s.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 "
                                 f"[{nblocks}, {B}, {nkv}]")
        if q.dtype not in _DTYPE_CODE:
            raise ValueError(f"q must be float32, bfloat16 or float16, got "
                             f"{q.dtype}")
    elif kpool.dtype not in _DTYPE_CODE or q.dtype != kpool.dtype:
        raise ValueError(f"q and the pools must share dtype float32, "
                         f"bfloat16 or float16; got {q.dtype} and "
                         f"{kpool.dtype}")
    # the kernel reads pool rows as 16-byte vectors
    if q.is_cuda and (kpool.data_ptr() % 16 or vpool.data_ptr() % 16):
        raise ValueError("kpool and vpool must be 16-byte aligned")


def _heads(nh, nkv, kv_group, head_offset):
    """(kv_group, head_offset) with their defaults: whole groups of
    ``nh // nkv``."""
    return (nh // nkv, 0) if kv_group is None else (kv_group, head_offset)


def _per_head(kc, nh, kv_group, head_offset):
    """K or V ``[..., S, nkv, d]`` as ``nh`` q heads read it: as it is
    when the q heads are whole groups of its kv heads, else one kv row
    per q head (``(i + head_offset) // kv_group``)."""
    if head_offset == 0 and nh == kc.shape[2] * kv_group:
        return kc
    idx = (torch.arange(nh, device=kc.device) + head_offset) // kv_group
    return kc.index_select(2, idx)


def _attend_gathered(q, kc, vc, pos, window, kv_group=None, head_offset=0):
    """Plain fp32 attention of q ``[L, nh, d]`` over gathered fp32
    ``[L, S, nkv, d]`` K/V with the kernel's masking and head map; cast
    to q.dtype."""
    L, nh, d = q.shape
    kv_group, head_offset = _heads(nh, kc.shape[2], kv_group, head_offset)
    kc = _per_head(kc, nh, kv_group, head_offset)
    vc = _per_head(vc, nh, kv_group, head_offset)
    S, nkv = kc.shape[1], kc.shape[2]
    qg = q.to(torch.float32).reshape(L, nkv, nh // nkv, d)
    s = torch.einsum("lkgd,lskd->lkgs", qg, kc) * (1.0 / math.sqrt(d))
    slots = torch.arange(S, device=q.device)
    vis = slots[None, :] <= pos[:, None]
    if window > 0:
        vis &= slots[None, :] > pos[:, None] - window
    s = torch.where(vis[:, None, None, :], s,
                    torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("lkgs,lskd->lkgd", p, vc)
    return out.reshape(L, nh, d).to(q.dtype)


def paged_attend_ref(q, kpool, vpool, tables, pos, *, window=0,
                     kv_group=None, head_offset=0):
    """Plain version of :func:`paged_attend`: gather every table slot,
    then a non-streaming fp32 softmax attention."""
    L, _, d = q.shape
    B, nkv = kpool.shape[1], kpool.shape[2]
    idx = tables.long()
    kc = kpool[idx].reshape(L, -1, nkv, d).to(torch.float32)
    vc = vpool[idx].reshape(L, -1, nkv, d).to(torch.float32)
    return _attend_gathered(q, kc, vc, pos, window, kv_group, head_offset)


def paged_attend_int8_ref(q, kpool, vpool, kscale, vscale, tables, pos, *,
                          window=0, kv_group=None, head_offset=0):
    """Plain version of :func:`paged_attend_int8`: gather, dequantize as
    ``int8.f32 * scale`` in fp32 (no cast to the model dtype, like the
    TPU kernel), then the same attention."""
    L, _, d = q.shape
    nkv = kpool.shape[2]
    idx = tables.long()
    kc = kpool[idx].reshape(L, -1, nkv, d).to(torch.float32) \
        * kscale[idx].reshape(L, -1, nkv, 1)
    vc = vpool[idx].reshape(L, -1, nkv, d).to(torch.float32) \
        * vscale[idx].reshape(L, -1, nkv, 1)
    return _attend_gathered(q, kc, vc, pos, window, kv_group, head_offset)


def _split_partials_ref(q, kpool, vpool, tables, pos, *, window, split,
                        kscale=None, vscale=None, kv_group=None,
                        head_offset=0):
    """Plain model of the split kernel: per split of ``split`` slots of
    each lane's gathered table, each (lane, head)'s max ``m``, sum ``l``
    and accumulator ``acc`` of its visible slots in fp32, ``[L, nh,
    n_split]`` twice and ``[L, nh, n_split, d]``. A split with no visible
    slot holds ``m = NEG_INF``, ``l = 0``, ``acc = 0``. With ``kscale``
    the pools are int8, dequantized as in ``paged_attend_int8_ref``.
    ``kv_group`` and ``head_offset`` map the q heads onto the kv heads
    as the kernel does."""
    L, nh, d = q.shape
    nkv = kpool.shape[2]
    idx = tables.long()
    kc = kpool[idx].reshape(L, -1, nkv, d).to(torch.float32)
    vc = vpool[idx].reshape(L, -1, nkv, d).to(torch.float32)
    if kscale is not None:
        kc = kc * kscale[idx].reshape(L, -1, nkv, 1)
        vc = vc * vscale[idx].reshape(L, -1, nkv, 1)
    kv_group, head_offset = _heads(nh, nkv, kv_group, head_offset)
    kc = _per_head(kc, nh, kv_group, head_offset)
    vc = _per_head(vc, nh, kv_group, head_offset)
    nkv = kc.shape[2]
    g = nh // nkv
    S = kc.shape[1]
    n = -(-S // split)
    pad = n * split - S
    qg = q.to(torch.float32).reshape(L, nkv, g, d)
    s = torch.einsum("lkgd,lskd->lkgs", qg, kc) * (1.0 / math.sqrt(d))
    s = torch.nn.functional.pad(s, (0, pad)).reshape(L, nkv, g, n, split)
    slots = torch.arange(n * split, device=q.device)
    vis = (slots[None, :] <= pos[:, None]) & (slots[None, :] < S)
    if window > 0:
        vis &= slots[None, :] > pos[:, None] - window
    vis = vis.reshape(L, 1, 1, n, split)
    m = torch.where(vis, s, torch.full((), NEG_INF, device=q.device)) \
        .amax(-1)
    p = torch.where(vis, torch.exp(s - m[..., None]),
                    torch.zeros((), device=q.device))
    vc = torch.nn.functional.pad(vc, (0, 0, 0, 0, 0, pad)) \
        .reshape(L, n, split, nkv, d)
    acc = torch.einsum("lkgns,lnskd->lkgnd", p, vc)
    return (m.reshape(L, nh, n), p.sum(-1).reshape(L, nh, n),
            acc.reshape(L, nh, n, d))


def _merge_splits_ref(m, l, acc, dtype):
    """Plain model of the merge kernel: each (lane, head)'s splits
    weighted by ``exp(m - max m)`` and summed in split order (an empty
    split's weight is 0), then ``acc / max(l, 1e-30)`` cast to
    ``dtype``."""
    w = torch.exp(m - m.amax(-1, keepdim=True))
    tot_l = torch.zeros_like(l[..., 0])
    tot = torch.zeros_like(acc[..., 0, :])
    for i in range(m.shape[-1]):
        tot_l = tot_l + w[..., i] * l[..., i]
        tot = tot + w[..., i, None] * acc[..., i, :]
    return (tot / tot_l.clamp(min=1e-30)[..., None]).to(dtype)


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.cache
def _lib():
    lib = _build.library("paged_attention")
    lib.pt_paged_attend.argtypes = [_P] * 7 + [_I] * 11 + [_F, _I, _P]
    lib.pt_paged_attend.restype = _I
    lib.pt_paged_attend_int8.argtypes = [_P] * 9 + [_I] * 11 + [_F, _I, _P]
    lib.pt_paged_attend_int8.restype = _I
    return lib


def _launch(entry, q, pools, tables, pos, window, heads, stream, n_sm):
    """Run the C entry point ``entry`` on ``q``, ``pools`` (kpool, vpool
    and, for int8, kscale, vscale), ``tables`` and ``pos``, the q heads
    mapped by ``heads`` (``kv_group``, ``head_offset``): choose the
    split, allocate the output and the fp32 workspace of the partials.
    Returns (the entry's error code, out)."""
    L, nh, d = q.shape
    B, nkv = pools[0].shape[1], pools[0].shape[2]
    g, off = _heads(nh, nkv, *heads)
    M = tables.shape[1]
    elt = pools[0].element_size()
    split = _split_slots(L, nkv, M, B, d * elt, n_sm)
    n_split = -(-M * B // split)
    # the merge launch takes each split's max and sum, within the 48 KB
    # a block gets without asking
    if _smem_bytes(g, d, B, split, elt) > _MAX_SMEM \
            or 8 * n_split > 48 * 1024:
        raise ValueError(f"block_size {B} x head_dim {d} x {M} blocks needs "
                         f"more shared memory than a block has")
    out = torch.empty_like(q)
    work = torch.empty(L * nh * n_split * (d + 2), dtype=torch.float32,
                       device=q.device)
    err = entry(q.data_ptr(), *(t.data_ptr() for t in pools),
                tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
                work.data_ptr(), L, nh, nkv, g, off, d, B, M, window, split,
                n_split, 1.0 / math.sqrt(d), _DTYPE_CODE[q.dtype], stream)
    return err, out


def _stream_and_sms(q):
    return (torch.cuda.current_stream(q.device).cuda_stream,
            _sm_count(q.device.index))


def paged_attend(q, kpool, vpool, tables, pos, *, window=0, kv_group=None,
                 head_offset=0):
    """Decode attention over one layer's block pool.

    q ``[L, nh, d]`` (each lane's pending query, RoPE applied);
    kpool/vpool ``[num_blocks, B, nkv, d]``; tables ``[L, M]`` int32;
    pos ``[L]`` int32 (slot ``l`` is visible iff ``l <= pos``, and
    ``l > pos - window`` when ``window > 0``). Returns ``[L, nh, d]`` in
    q's dtype. Pools and q share dtype float32, bfloat16 or float16.
    Query head ``i`` reads kv head ``(i + head_offset) // kv_group``
    (default: ``nh // nkv``, offset 0; a tensor-parallel rank's heads,
    see the module note). On CUDA tensors a call is two kernel launches
    (split, merge) and counts one in ``paged_attend.launches``."""
    _check(q, kpool, vpool, None, None, tables, pos, window, kv_group,
           head_offset)
    if not q.is_cuda:
        return paged_attend_ref(q, kpool, vpool, tables, pos, window=window,
                                kv_group=kv_group, head_offset=head_offset)
    err, out = _launch(_lib().pt_paged_attend, q, (kpool, vpool), tables,
                       pos, window, (kv_group, head_offset),
                       *_stream_and_sms(q))
    if err:
        raise RuntimeError(f"paged_attend kernel launch failed "
                           f"(cudaError {err})")
    paged_attend.launches += 1
    return out


def paged_attend_int8(q, kpool, vpool, kscale, vscale, tables, pos, *,
                      window=0, kv_group=None, head_offset=0):
    """:func:`paged_attend` over int8 pools: kpool/vpool ``[num_blocks,
    B, nkv, d]`` int8 with their fp32 scales ``[num_blocks, B, nkv]``
    (``quantization.quantize_kv``), dequantized in registers. q is
    float32, bfloat16 or float16; the result has q's dtype; the heads
    map as in :func:`paged_attend`. Counts one in
    ``paged_attend_int8.launches`` per call on CUDA tensors."""
    _check(q, kpool, vpool, kscale, vscale, tables, pos, window, kv_group,
           head_offset)
    if not q.is_cuda:
        return paged_attend_int8_ref(q, kpool, vpool, kscale, vscale,
                                     tables, pos, window=window,
                                     kv_group=kv_group,
                                     head_offset=head_offset)
    err, out = _launch(_lib().pt_paged_attend_int8, q,
                       (kpool, vpool, kscale, vscale), tables, pos, window,
                       (kv_group, head_offset), *_stream_and_sms(q))
    if err:
        raise RuntimeError(f"paged_attend_int8 kernel launch failed "
                           f"(cudaError {err})")
    paged_attend_int8.launches += 1
    return out


paged_attend.launches = 0
paged_attend_int8.launches = 0
