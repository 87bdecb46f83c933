"""Flash attention for training: hand-written CUDA kernels, their plain
PyTorch versions, and the autograd Function that joins them.

The three kernels of ``csrc/flash_attention.cu`` replace the Pallas TPU
kernels of ``paddle_tpu/ops/pallas/flash_attention.py``:

- :func:`flash_fwd` (O and lse) replaces ``_fwd_kernel``;
- :func:`flash_bwd_dq` replaces ``_bwd_dq_kernel``;
- :func:`flash_bwd_dkv` replaces ``_bwd_dkv_kernel``.

Every layer of the Llama training step runs each once: the forward in
``scaled_dot_product_attention(is_causal=True)`` (or
``sliding_window_attention``), the two backward kernels from
:class:`_FlashFn`'s backward, which first computes ``delta =
rowsum(dO * O)`` in fp32 as a torch expression (JAX computes it outside
Pallas too).

The arithmetic is the reference's: fp32 scores (the forward scales q
before the product, the backward scales the product), bottom-right
causal masking with an optional sliding window, masked scores at the
finite ``NEG_INF = -1e30``, lse ``= m + log(max(l, 1e-30))``, exact
zeros for rows that see no key, and ``p = exp(s - lse)`` (0 where lse
``<= -0.5e30``) in the backward. lse and delta are plain ``[b * h, sq]``
fp32 tensors (the TPU's ``[bh, sq, 128]`` lane broadcast is a Mosaic
tiling rule), and the backward entries take them as arguments, so ring
attention can later call them with an external lse.

What bounds the kernels: at the headline shape (b8, s1024, h12, d128,
bf16, causal) about 26 GFLOP forward and 90 GFLOP backward against
~100 MB of operands each, so they are bound by tensor-core operations.
For bf16 with ``d <= 128`` the kernels compute their products with
``mma.sync`` bf16 tensor-core instructions (fp32 accumulators); fp32
inputs and ``d > 128`` take fp32-FMA kernels, so fp32 results match the
CPU's plain versions to fp32 rounding. All read q/k/v through their
(batch, seq, head) strides, so the ``[b, s, h, d]`` views of the fused
QKV projection go in without the three transposes JAX makes; the
source's note lists what later work adds (wgmma, TMA, a persistent
grid).

Wrapper rules: CPU tensors go to the plain versions
(:func:`flash_fwd_ref`, :func:`flash_bwd_dq_ref`,
:func:`flash_bwd_dkv_ref`); CUDA tensors launch the kernel or raise —
there is no fallback. ``flash_fwd.launches``, ``flash_bwd_dq.launches``
and ``flash_bwd_dkv.launches`` count kernel launches (plain ints; reset
them by assignment). The key-padding mask and in-kernel dropout of the
TPU kernels belong to the encoder slice (ROADMAP queue B) and raise
``NotImplementedError``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
           "flash_fwd_ref", "flash_bwd_dq_ref", "flash_bwd_dkv_ref"]

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}  # flash_attention.cu
_ENCODER_SLICE = ("belongs to the encoder slice of the port (ROADMAP "
                  "queue B, with kernels 4-6 of head_flash.py)")


# -- checks -------------------------------------------------------------------

def _check(q, k, v, causal, window, extra=()):
    """Raise ``ValueError`` on anything the kernels do not take. ``extra``
    names further ``[b, sq, h, d]`` tensors (dO) checked like q."""
    named = [("q", q), ("k", k), ("v", v), *extra]
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name} must be a torch.Tensor")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be [b, s, heads, head_dim], got "
                             f"{tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous "
                             f"(stride 1), got strides {t.stride()}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"q, k and v must be float32 or bfloat16, got "
                         f"{q.dtype}")
    b, sq, h, d = q.shape
    bk, sk, h_kv, dk = k.shape
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"v {tuple(v.shape)} must match k {tuple(k.shape)}")
    if bk != b or dk != d:
        raise ValueError(f"k {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)}: batch and head_dim must match")
    for name, t in extra:
        if tuple(t.shape) != tuple(q.shape):
            raise ValueError(f"{name} {tuple(t.shape)} must match q "
                             f"{tuple(q.shape)}")
    if d % 8 or d > 256:
        raise ValueError(f"head_dim must be a multiple of 8 and <= 256, "
                         f"got {d}")
    if h_kv < 1 or h % h_kv:
        raise ValueError(f"num_heads {h} is not a multiple of kv heads "
                         f"{h_kv}")
    if sq < 1 or sk < 1:
        raise ValueError("sequence lengths must be >= 1")
    if b * h > 65535:  # the kernels' grid.y is batch x heads
        raise ValueError(f"batch x heads must be <= 65535, got {b * h}")
    if not isinstance(window, int) or window < 0:
        raise ValueError(f"window must be an int >= 0, got {window!r}")
    if window and not causal:
        raise ValueError("a sliding window needs causal=True (the band is "
                         "bottom-right aligned on the causal diagonal)")
    if q.is_cuda:
        for name, t in named:
            if not _vector_aligned(t):
                raise ValueError(
                    f"{name} must start 16-byte aligned with batch, seq "
                    f"and head strides that are multiples of 16 bytes; got "
                    f"strides {t.stride()}")


def _vector_aligned(t):
    """Whether the kernels can read ``t``'s rows as 16-byte vectors."""
    vec = 16 // t.element_size()
    return t.stride(-1) == 1 and not t.data_ptr() % 16 \
        and not any(s % vec for s in t.stride()[:3])


def _scale(scale, d):
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


# -- plain versions -----------------------------------------------------------

def _visible(sq, sk, causal, window, device):
    """``[sq, sk]`` bool: query row r sees key c (bottom-right causal,
    optional window), or None when every key is visible."""
    if not causal:
        return None
    rows = torch.arange(sq, device=device)[:, None] + (sk - sq)
    cols = torch.arange(sk, device=device)[None, :]
    vis = cols <= rows
    if window > 0:
        vis &= cols > rows - window
    return vis


def _grouped(q, h_kv):
    """``[b, s, h, d]`` -> fp32 ``[b, s, h_kv, g, d]`` (GQA groups)."""
    b, s, h, d = q.shape
    return q.to(torch.float32).reshape(b, s, h_kv, h // h_kv, d)


def _masked_scores(q, k, scale, causal, window, prescale):
    """fp32 scores ``[b, h_kv, g, sq, sk]`` with masked entries at
    NEG_INF. ``prescale`` multiplies q by the scale before the product
    (the forward), else the product is scaled (the backward)."""
    qg = _grouped(q, k.shape[2])
    kf = k.to(torch.float32)
    if prescale:
        s = torch.einsum("bqkgd,bckd->bkgqc", qg * scale, kf)
    else:
        s = scale * torch.einsum("bqkgd,bckd->bkgqc", qg, kf)
    vis = _visible(q.shape[1], k.shape[1], causal, window, q.device)
    if vis is not None:
        s = torch.where(vis, s, torch.full((), NEG_INF, device=q.device))
    return s


def flash_fwd_ref(q, k, v, *, causal, scale=None, window=0):
    """Plain version of :func:`flash_fwd`: a one-pass fp32 softmax
    attention with the kernel's masking. Returns (O ``[b, sq, h, d]`` in
    q's dtype, lse ``[b * h, sq]`` fp32)."""
    b, sq, h, d = q.shape
    s = _masked_scores(q, k, _scale(scale, d), causal, window, True)
    lse = torch.logsumexp(s, dim=-1)  # [b, h_kv, g, sq]
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bkgqc,bckd->bqkgd", p, v.to(torch.float32))
    # rows with no visible key: lse stays ~NEG_INF and O is exactly 0
    out = torch.where((lse > 0.5 * NEG_INF).permute(0, 3, 1, 2)[..., None],
                      out, torch.zeros((), device=q.device))
    return out.reshape(b, sq, h, d).to(q.dtype), lse.reshape(b * h, sq)


def _probs_and_ds(q, k, v, do, lse, delta, scale, causal, window):
    """Recomputed p and ds ``[b, h_kv, g, sq, sk]`` fp32."""
    b, sq, h, d = q.shape
    h_kv = k.shape[2]
    s = _masked_scores(q, k, scale, causal, window, False)
    lse = lse.reshape(b, h_kv, h // h_kv, sq, 1)
    p = torch.where(lse > 0.5 * NEG_INF, torch.exp(s - lse),
                    torch.zeros((), device=q.device))
    dp = torch.einsum("bqkgd,bckd->bkgqc", _grouped(do, h_kv),
                      v.to(torch.float32))
    ds = p * (dp - delta.reshape(b, h_kv, h // h_kv, sq, 1)) * scale
    return p, ds


def flash_bwd_dq_ref(q, k, v, do, lse, delta, *, causal, scale=None,
                     window=0):
    """Plain version of :func:`flash_bwd_dq`: dQ ``[b, sq, h, d]`` in q's
    dtype from the recomputed probabilities."""
    b, sq, h, d = q.shape
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, _scale(scale, d), causal,
                          window)
    dq = torch.einsum("bkgqc,bckd->bqkgd", ds, k.to(torch.float32))
    return dq.reshape(b, sq, h, d).to(q.dtype)


def flash_bwd_dkv_ref(q, k, v, do, lse, delta, *, causal, scale=None,
                      window=0):
    """Plain version of :func:`flash_bwd_dkv`: (dK, dV) ``[b, sk, h_kv,
    d]`` in k's dtype, summed over each kv head's query-head group."""
    d = q.shape[-1]
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, _scale(scale, d), causal,
                          window)
    h_kv = k.shape[2]
    dv = torch.einsum("bkgqc,bqkgd->bckd", p, _grouped(do, h_kv))
    dk = torch.einsum("bkgqc,bqkgd->bckd", ds, _grouped(q, h_kv))
    return dk.to(k.dtype), dv.to(v.dtype)


# -- kernels ------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.cache
def _lib():
    lib = _build.library("flash_attention")
    lib.pt_flash_fwd.argtypes = [_P] * 6 + [_F, _P, _I, _P]
    lib.pt_flash_fwd.restype = _I
    lib.pt_flash_bwd_dq.argtypes = [_P] * 8 + [_F, _P, _I, _P]
    lib.pt_flash_bwd_dq.restype = _I
    lib.pt_flash_bwd_dkv.argtypes = [_P] * 9 + [_F, _P, _I, _P]
    lib.pt_flash_bwd_dkv.restype = _I
    return lib


def _launch(entry, name, tensors, q, k, causal, window, scale, strided):
    """Call one C entry: data pointers, then the geometry and the
    (batch, seq, head) strides of the ``strided`` tensors, as host
    arrays the entry reads before it returns."""
    b, sq, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    geom = (ctypes.c_int * 8)(b, h, h_kv, sq, sk, d, int(causal), window)
    strides = (ctypes.c_longlong * (3 * len(strided)))(
        *(s for t in strided for s in t.stride()[:3]))
    err = entry(*(t.data_ptr() for t in tensors), ctypes.addressof(geom),
                scale, ctypes.addressof(strides), _DTYPE_CODE[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {err})")


def flash_fwd(q, k, v, *, causal, scale=None, window=0):
    """Attention forward. q ``[b, sq, h, d]``, k/v ``[b, sk, h_kv, d]``
    (float32 or bfloat16, last dim contiguous, ``h % h_kv == 0``, ``d %
    8 == 0``, ``d <= 256``). Returns (O ``[b, sq, h, d]`` in q's dtype,
    lse ``[b * h, sq]`` fp32)."""
    _check(q, k, v, causal, window)
    scale = _scale(scale, q.shape[-1])
    if not q.is_cuda:
        return flash_fwd_ref(q, k, v, causal=causal, scale=scale,
                             window=window)
    b, sq, h, _ = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    _launch(_lib().pt_flash_fwd, "flash_fwd", (q, k, v, out, lse), q, k,
            causal, window, scale, (q, k, v, out))
    flash_fwd.launches += 1
    return out, lse


def _check_stats(q, lse, delta):
    b, sq, h, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 \
                or tuple(t.shape) != (b * h, sq) or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"[b * h, sq] = [{b * h}, {sq}] tensor on "
                             f"{q.device}")


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal, scale=None, window=0):
    """dQ ``[b, sq, h, d]`` (q's dtype) from dO (q's shape and dtype), the
    forward's lse and ``delta = rowsum(dO * O)``, both ``[b * h, sq]``
    fp32."""
    _check(q, k, v, causal, window, extra=(("do", do),))
    _check_stats(q, lse, delta)
    scale = _scale(scale, q.shape[-1])
    if not q.is_cuda:
        return flash_bwd_dq_ref(q, k, v, do, lse, delta, causal=causal,
                                scale=scale, window=window)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(_lib().pt_flash_bwd_dq, "flash_bwd_dq",
            (q, k, v, do, lse, delta, dq), q, k, causal, window, scale,
            (q, k, v, do, dq))
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal, scale=None,
                  window=0):
    """(dK, dV) ``[b, sk, h_kv, d]`` (k's dtype), each summed over the
    query heads that share its kv head; arguments as
    :func:`flash_bwd_dq`."""
    _check(q, k, v, causal, window, extra=(("do", do),))
    _check_stats(q, lse, delta)
    scale = _scale(scale, q.shape[-1])
    if not q.is_cuda:
        return flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal=causal,
                                 scale=scale, window=window)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch(_lib().pt_flash_bwd_dkv, "flash_bwd_dkv",
            (q, k, v, do, lse, delta, dk, dv), q, k, causal, window, scale,
            (q, k, v, do, dk, dv))
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


# -- autograd -----------------------------------------------------------------

class _FlashFn(torch.autograd.Function):
    """Forward kernel 1; backward: delta in fp32, then kernels 2 and 3."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window):
        out, lse = flash_fwd(q, k, v, causal=causal, scale=scale,
                             window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(causal=causal, scale=scale, window=window)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.to(q.dtype)
        if not _vector_aligned(do):  # an upstream gradient with odd strides
            do = do.contiguous()
        b, sq, h, _ = q.shape
        delta = (do.to(torch.float32) * out.to(torch.float32)).sum(-1)
        delta = delta.permute(0, 2, 1).reshape(b * h, sq).contiguous()
        dq = flash_bwd_dq(q, k, v, do, lse, delta, **ctx.args)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal, scale=None, window=0, kmask=None,
                    dropout=0.0):
    """Differentiable flash attention on the JAX public layout: q
    ``[b, sq, h, d]``, k/v ``[b, sk, h_kv, d]`` -> ``[b, sq, h, d]``.
    ``scale`` defaults to ``1/sqrt(d)``; ``window > 0`` (with ``causal``)
    bounds each row's lookback to ``window`` keys. ``kmask`` and
    ``dropout > 0`` raise ``NotImplementedError``."""
    if kmask is not None:
        raise NotImplementedError(f"the additive key-padding mask "
                                  f"{_ENCODER_SLICE}")
    if dropout > 0.0:
        raise NotImplementedError(f"in-kernel attention dropout "
                                  f"{_ENCODER_SLICE}")
    _check(q, k, v, causal, window)
    return _FlashFn.apply(q, k, v, causal, _scale(scale, q.shape[-1]),
                          window)
