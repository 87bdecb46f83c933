"""Paged-attention decode: hand-written CUDA kernels and their plain
PyTorch versions.

``paged_attend`` replaces the Pallas TPU kernel ``_paged_kernel``
(``paddle_tpu/ops/pallas/paged_attention.py``, ``paged_attend``) and
``paged_attend_int8`` replaces ``_paged_kernel_int8``
(``paged_attend_int8``) there. The serving engine's decode step calls
one of them once per layer: each lane's single pending query attends
over the K/V that its block table points at, slots ``0..pos[lane]``
(and ``> pos - window`` with a sliding window).

The kernels (``csrc/paged_attention.cu``) give each (lane, kv_head) one
thread block that loops over the lane's live blocks only, stages K/V
tiles in shared memory with 16-byte loads, dequantizes int8 tiles by
their fp32 scales as they load, and keeps an fp32 streaming softmax.
They are bound by bytes: ``2 * sum(pos + 1) * nkv * d`` elements of
K/V (plus the int8 scales) per call, over the card's 3.35 TB/s; reading
only live blocks is what the design does about it. The source's note
lists the known gaps (no split-K, no TMA).

Wrapper rules: CPU tensors go to the plain version
(``paged_attend_ref``/``paged_attend_int8_ref``); CUDA tensors launch
the kernel or raise — there is no fallback. Both paths first check
device, dtype, shape and contiguity. ``paged_attend.launches`` and
``paged_attend_int8.launches`` count kernel launches (plain ints; reset
them by assignment).
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
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}  # paged_attention.cu


def _smem_bytes(g, d, B):
    # csrc/paged_attention.cu::smem_floats
    return 4 * (2 * g * d + 2 * B * d + g * B + 3 * g)


def _check(q, kpool, vpool, kscale, vscale, tables, pos, window):
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
    if nkv < 1 or nh % nkv:
        raise ValueError(f"num_heads {nh} is not a multiple of kv heads "
                         f"{nkv}")
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
            raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    elif kpool.dtype not in _DTYPE_CODE or q.dtype != kpool.dtype:
        raise ValueError(f"q and the pools must share dtype float32 or "
                         f"bfloat16; got {q.dtype} and {kpool.dtype}")
    if _smem_bytes(nh // nkv, d, B) > _MAX_SMEM:
        raise ValueError(f"block_size {B} x head_dim {d} needs more shared "
                         f"memory than a block has")
    # the kernel reads pool rows as 16-byte vectors
    if q.is_cuda and (kpool.data_ptr() % 16 or vpool.data_ptr() % 16):
        raise ValueError("kpool and vpool must be 16-byte aligned")


def _attend_gathered(q, kc, vc, pos, window):
    """Plain fp32 attention of q ``[L, nh, d]`` over gathered fp32
    ``[L, S, nkv, d]`` K/V with the kernel's masking; cast to q.dtype."""
    L, nh, d = q.shape
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


def paged_attend_ref(q, kpool, vpool, tables, pos, *, window=0):
    """Plain version of :func:`paged_attend`: gather every table slot,
    then a non-streaming fp32 softmax attention."""
    L, _, d = q.shape
    B, nkv = kpool.shape[1], kpool.shape[2]
    idx = tables.long()
    kc = kpool[idx].reshape(L, -1, nkv, d).to(torch.float32)
    vc = vpool[idx].reshape(L, -1, nkv, d).to(torch.float32)
    return _attend_gathered(q, kc, vc, pos, window)


def paged_attend_int8_ref(q, kpool, vpool, kscale, vscale, tables, pos, *,
                          window=0):
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
    return _attend_gathered(q, kc, vc, pos, window)


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.cache
def _lib():
    lib = _build.library("paged_attention")
    lib.pt_paged_attend.argtypes = [_P] * 6 + [_I] * 7 + [_F, _I, _P]
    lib.pt_paged_attend.restype = _I
    lib.pt_paged_attend_int8.argtypes = [_P] * 8 + [_I] * 7 + [_F, _I, _P]
    lib.pt_paged_attend_int8.restype = _I
    return lib


def _geometry(q, kpool, tables):
    L, nh, d = q.shape
    B, nkv = kpool.shape[1], kpool.shape[2]
    return L, nkv, nh // nkv, d, B, tables.shape[1]


def paged_attend(q, kpool, vpool, tables, pos, *, window=0):
    """Decode attention over one layer's block pool.

    q ``[L, nh, d]`` (each lane's pending query, RoPE applied);
    kpool/vpool ``[num_blocks, B, nkv, d]``; tables ``[L, M]`` int32;
    pos ``[L]`` int32 (slot ``l`` is visible iff ``l <= pos``, and
    ``l > pos - window`` when ``window > 0``). Returns ``[L, nh, d]`` in
    q's dtype. Pools and q share dtype float32 or bfloat16."""
    _check(q, kpool, vpool, None, None, tables, pos, window)
    if not q.is_cuda:
        return paged_attend_ref(q, kpool, vpool, tables, pos, window=window)
    L, nkv, g, d, B, M = _geometry(q, kpool, tables)
    out = torch.empty_like(q)
    err = _lib().pt_paged_attend(
        q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(), tables.data_ptr(),
        pos.data_ptr(), out.data_ptr(), L, nkv, g, d, B, M, window,
        1.0 / math.sqrt(d), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_attend kernel launch failed "
                           f"(cudaError {err})")
    paged_attend.launches += 1
    return out


def paged_attend_int8(q, kpool, vpool, kscale, vscale, tables, pos, *,
                      window=0):
    """:func:`paged_attend` over int8 pools: kpool/vpool ``[num_blocks,
    B, nkv, d]`` int8 with their fp32 scales ``[num_blocks, B, nkv]``
    (``quantization.quantize_kv``), dequantized in the tile. q is
    float32 or bfloat16; the result has q's dtype."""
    _check(q, kpool, vpool, kscale, vscale, tables, pos, window)
    if not q.is_cuda:
        return paged_attend_int8_ref(q, kpool, vpool, kscale, vscale,
                                     tables, pos, window=window)
    L, nkv, g, d, B, M = _geometry(q, kpool, tables)
    out = torch.empty_like(q)
    err = _lib().pt_paged_attend_int8(
        q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(), kscale.data_ptr(),
        vscale.data_ptr(), tables.data_ptr(), pos.data_ptr(),
        out.data_ptr(), L, nkv, g, d, B, M, window, 1.0 / math.sqrt(d),
        _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_attend_int8 kernel launch failed "
                           f"(cudaError {err})")
    paged_attend_int8.launches += 1
    return out


paged_attend.launches = 0
paged_attend_int8.launches = 0
