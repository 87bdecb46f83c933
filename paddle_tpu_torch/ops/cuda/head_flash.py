"""Head-batched flash attention: kernels 4-6, their plain PyTorch
versions, and the autograd Function that joins them.

Counterpart of ``paddle_tpu/ops/pallas/head_flash.py``. The entries
of ``csrc/flash_attention.cu`` replace its Pallas TPU kernels:

- :func:`hb_fwd` (``pt_hb_fwd``: O and lse) replaces ``_hb_fwd_kernel``;
- :func:`hb_bwd_dq` (``pt_hb_bwd_dq``) and :func:`hb_bwd_dq_delta`
  (``pt_hb_bwd_dq_delta``: dQ and delta in one launch, what the CUDA
  backward runs in bfloat16 and float16) replace ``_hb_dq_kernel``;
- :func:`hb_bwd_dkv` (``pt_hb_bwd_dkv``: dK, dV and dmask) replaces
  ``_hb_dkv_kernel``.

On the TPU the head-batched kernels exist to read native ``[b, s, h,
d]`` blocks without the ``[b * h, s, d]`` transposes of kernels 1-3, and
their key mask is one row per batch row (``[b, 1, sk]``) whose gradient
sums over heads and rows in the kernel. On Hopper kernels 1-3 already
read ``[b, s, h, d]`` through strides, so kernels 4-6 are kernels 1-3's
templates with the mask row read at the batch row, all three on the
``wgmma`` family in bfloat16 and float16 (the float16 library,
``flash_attention._lib``) at BERT's ``d`` 64: kernel 4 is
``flash_fwd_wgmma<64, true, true>`` and kernel 5
``flash_bwd_dq_wgmma<64, true, true, true>`` (delta summed inside it).
Kernels 4 and 5 skip key tiles (128 and 64 keys) that are wholly padding
for the batch row, with the rule kernel 6 uses: their results are
bit-identical to visiting them. Kernel 6 takes kernel
3's grid, one block per (128 keys, kv head) on the wgmma kernel at ``d
<= 64`` (3072 blocks at b64 s512 h12), and writes one dmask row per
query head into a ``[b * h, 1, sk]`` scratch that the wrapper allocates;
a second pass of the same source sums the h rows of each (batch row,
key) in head order into dmask ``[b, 1, sk]``: deterministic, no atomics.
A warpgroup's 64 keys that are wholly padding (additive row <= -1e3) for
a batch row that has a live key elsewhere (non-causal, or causal with a
live key before them; no window) are skipped: their dK, dV and dmask are
exactly 0, as the plain version computes them. Dropout uses the query
head ``b * h + i``, so its mask is bit for bit kernel 1's and the TPU
kernels'; a rank that holds part of the batch or of the heads passes
``coords`` (first batch row, first head, global heads) and hashes the
head ``(b0 + b) * hg + h0 + i``, the one the whole tensor's launch hashes.

The lse is ``[b * h, sq]`` fp32, as kernel 1's (the TPU kernel's ``[b,
sq, h, 128]`` lane broadcast is a Mosaic tiling rule: its ``[..., 0]``
transposed to ``[b, h, sq]`` is this).

What bounds them at BERT-base's shape (b64, s512, h12, d64, bf16,
non-causal, padded): counting only the (row, key) pairs the function
needs, each is bound by bytes (about 0.049, 0.064 with delta and 0.079
ms for kernels 4-6). All three compute with ``wgmma`` from a TMA ring
(see the source's note).

Wrapper rules as in ``flash_attention.py``: CPU tensors go to the plain
versions (:func:`hb_fwd_ref`, :func:`hb_bwd_dq_ref`,
:func:`hb_bwd_dq_delta_ref`, :func:`hb_bwd_dkv_ref`); CUDA tensors launch
the kernel or raise. ``hb_fwd.launches``, ``hb_bwd_dq.launches`` (kernel
5 through either entry) and ``hb_bwd_dkv.launches`` count launches.
"""
from __future__ import annotations

import torch

from . import flash_attention as _fa

__all__ = ["hb_flash", "hb_fwd", "hb_bwd_dq", "hb_bwd_dkv",
           "hb_bwd_dq_delta", "hb_fwd_ref", "hb_bwd_dq_ref",
           "hb_bwd_dkv_ref", "hb_bwd_dq_delta_ref"]


def _per_head(kmask, h):
    """``[b, 1, sk]`` batch rows -> kernel 1's ``[b * h, 1, sk]``."""
    if kmask is None:
        return None
    b, _, sk = kmask.shape
    return kmask[:, None].expand(b, h, 1, sk).reshape(b * h, 1, sk)


# -- plain versions -----------------------------------------------------------

def hb_fwd_ref(q, k, v, *, causal=False, scale=None, window=0, kmask=None,
               seed=None, dropout=0.0, coords=None):
    """Plain version of :func:`hb_fwd`: kernel 1's plain version with the
    batch rows' key mask repeated for each head."""
    return _fa.flash_fwd_ref(q, k, v, causal=causal, scale=scale,
                             window=window, kmask=_per_head(kmask,
                                                            q.shape[2]),
                             seed=seed, dropout=dropout, coords=coords)


def hb_bwd_dq_ref(q, k, v, do, lse, delta, *, causal=False, scale=None,
                  window=0, kmask=None, seed=None, dropout=0.0, coords=None):
    """Plain version of :func:`hb_bwd_dq`."""
    return _fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, causal=causal,
                                scale=scale, window=window,
                                kmask=_per_head(kmask, q.shape[2]),
                                seed=seed, dropout=dropout, coords=coords)


def hb_bwd_dq_delta_ref(q, k, v, do, out, lse, *, causal=False, scale=None,
                        window=0, kmask=None, seed=None, dropout=0.0,
                        coords=None):
    """Plain version of :func:`hb_bwd_dq_delta`: (dQ, delta)."""
    delta = _fa._delta(do, out)
    return hb_bwd_dq_ref(q, k, v, do, lse, delta, causal=causal,
                         scale=scale, window=window, kmask=kmask, seed=seed,
                         dropout=dropout, coords=coords), delta


def hb_bwd_dkv_ref(q, k, v, do, lse, delta, *, causal=False, scale=None,
                   window=0, kmask=None, seed=None, dropout=0.0, coords=None):
    """Plain version of :func:`hb_bwd_dkv`: (dK, dV) and, with ``kmask``,
    dmask ``[b, 1, sk]`` summed over heads and query rows."""
    res = _fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal=causal,
                                scale=scale, window=window,
                                kmask=_per_head(kmask, q.shape[2]),
                                seed=seed, dropout=dropout, coords=coords)
    if kmask is None:
        return res
    dk, dv, dm = res
    b, h = q.shape[0], q.shape[2]
    return dk, dv, dm.reshape(b, h, 1, -1).sum(1)


# -- kernels ------------------------------------------------------------------

def hb_fwd(q, k, v, *, causal=False, scale=None, window=0, kmask=None,
           seed=None, dropout=0.0, coords=None):
    """Head-batched attention forward: q ``[b, sq, h, d]``, k/v ``[b, sk,
    h_kv, d]`` as :func:`flash_attention.flash_fwd` takes them, ``kmask``
    ``[b, 1, sk]`` fp32 (one additive row per batch row) and ``dropout``
    with two ``seed`` words at the global ``coords`` (first batch row,
    first head, global heads; None: the whole batch and all heads).
    Returns (O, lse ``[b * h, sq]`` fp32)."""
    _fa._check(q, k, v, causal, window)
    drop = _fa._dropout_words(dropout, seed, coords, q.shape[2])
    if kmask is not None:
        _fa._check_kmask(kmask, q.shape[0], q, k)
    scale = _fa._scale(scale, q.shape[-1])
    if not q.is_cuda:
        return hb_fwd_ref(q, k, v, causal=causal, scale=scale, window=window,
                          kmask=kmask, seed=seed, dropout=dropout,
                          coords=coords)
    res = _fa._fwd(_fa._lib(q.dtype).pt_hb_fwd, "hb_fwd", q, k, v, kmask,
                   scale, causal, window, drop)
    hb_fwd.launches += 1
    return res


def hb_bwd_dq(q, k, v, do, lse, delta, *, causal=False, scale=None,
              window=0, kmask=None, seed=None, dropout=0.0, coords=None):
    """dQ of :func:`hb_fwd` from dO, lse and ``delta = rowsum(dO * O)``
    (``[b * h, sq]`` fp32 each)."""
    drop = _fa._check_bwd(q, k, v, do, lse, delta, causal, window, kmask,
                          q.shape[0], dropout, seed, coords)
    scale = _fa._scale(scale, q.shape[-1])
    if not q.is_cuda:
        return hb_bwd_dq_ref(q, k, v, do, lse, delta, causal=causal,
                             scale=scale, window=window, kmask=kmask,
                             seed=seed, dropout=dropout, coords=coords)
    dq = _fa._bwd_dq(_fa._lib(q.dtype).pt_hb_bwd_dq, "hb_bwd_dq", q, k, v,
                     do, lse, delta, kmask, scale, causal, window, drop)
    hb_bwd_dq.launches += 1
    return dq


def hb_bwd_dq_delta(q, k, v, do, out, lse, *, causal=False, scale=None,
                    window=0, kmask=None, seed=None, dropout=0.0,
                    coords=None):
    """Kernel 5 computing delta itself: (dQ ``[b, sq, h, d]``, delta ``=
    rowsum(dO * O)`` ``[b * h, sq]`` fp32) from dO and the forward's O
    (both q's shape and dtype) and lse, with the key row and dropout as
    :func:`hb_bwd_dq` takes them. One launch: each block sums delta for
    its query rows from the dO tile it holds, writes it out for
    :func:`hb_bwd_dkv`, and goes on to dQ. Takes bfloat16 or float16
    with ``d <= 128`` (on CUDA; anything else raises). Its launches count on
    ``hb_bwd_dq.launches``: it is kernel 5."""
    _fa._check(q, k, v, causal, window, extra=(("do", do), ("out", out)))
    _fa._check_stats(q, lse=lse)
    drop = _fa._dropout_words(dropout, seed, coords, q.shape[2])
    if kmask is not None:
        _fa._check_kmask(kmask, q.shape[0], q, k)
    scale = _fa._scale(scale, q.shape[-1])
    if not q.is_cuda:
        return hb_bwd_dq_delta_ref(q, k, v, do, out, lse, causal=causal,
                                   scale=scale, window=window, kmask=kmask,
                                   seed=seed, dropout=dropout, coords=coords)
    res = _fa._bwd_dq_delta(_fa._lib(q.dtype).pt_hb_bwd_dq_delta,
                            "hb_bwd_dq_delta", q, k, v, do, out, lse, scale,
                            causal, window, drop, kmask=(kmask,))
    hb_bwd_dq.launches += 1
    return res


def hb_bwd_dkv(q, k, v, do, lse, delta, *, causal=False, scale=None,
               window=0, kmask=None, seed=None, dropout=0.0, coords=None):
    """(dK, dV) of :func:`hb_fwd` (GQA summed over each group) and, with
    ``kmask``, dmask ``[b, 1, sk]`` fp32 summed over heads and rows."""
    b = q.shape[0]
    drop = _fa._check_bwd(q, k, v, do, lse, delta, causal, window, kmask, b,
                          dropout, seed, coords)
    scale = _fa._scale(scale, q.shape[-1])
    if not q.is_cuda:
        return hb_bwd_dkv_ref(q, k, v, do, lse, delta, causal=causal,
                              scale=scale, window=window, kmask=kmask,
                              seed=seed, dropout=dropout, coords=coords)
    res = _fa._bwd_dkv(_fa._lib(q.dtype).pt_hb_bwd_dkv, "hb_bwd_dkv", q, k,
                       v, do, lse, delta, kmask, b, scale, causal, window,
                       drop, head_sum=True)
    hb_bwd_dkv.launches += 1
    return res


hb_fwd.launches = 0
hb_bwd_dq.launches = 0
hb_bwd_dkv.launches = 0


# -- autograd -----------------------------------------------------------------

class _HbFlashFn(torch.autograd.Function):
    """Forward kernel 4; backward: kernel 5 computing delta itself, then
    kernel 6 (bfloat16 or float16 on CUDA with ``d <= 128``), else delta
    as torch ops, then kernels 5 and 6. kmask's gradient is kernel 6's
    dmask."""

    @staticmethod
    def forward(ctx, q, k, v, kmask, causal, scale, window, seed, dropout,
                coords):
        args = dict(causal=causal, scale=scale, window=window, kmask=kmask,
                    seed=seed, dropout=dropout, coords=coords)
        out, lse = hb_fwd(q, k, v, **args)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = args
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = _fa._upstream(do, q)
        if _fa._fusable(q):
            dq, delta = hb_bwd_dq_delta(q, k, v, do, out, lse, **ctx.args)
        else:
            delta = _fa._delta(do, out)
            dq = hb_bwd_dq(q, k, v, do, lse, delta, **ctx.args)
        dk, dv, *dm = hb_bwd_dkv(q, k, v, do, lse, delta, **ctx.args)
        return (dq, dk, dv, dm[0] if dm else None, None, None, None, None,
                None, None)


def hb_flash(q, k, v, seed=None, kmask=None, causal=False, scale=None,
             window=0, dropout=0.0, coords=None):
    """The head-batched flash entry (the reference's ``hb_flash``): q
    ``[b, sq, h, d]``, k/v ``[b, sk, h_kv, d]``, additive ``kmask`` ``[b,
    1, sk]`` or None (cast to contiguous fp32; it receives dmask as its
    gradient), ``seed`` two int words for ``dropout > 0``, hashed at the
    global ``coords`` (first batch row, first head, global heads) when q
    is a rank's part of the batch or heads. Returns ``[b, sq, h, d]``."""
    _fa._check(q, k, v, causal, window)
    _fa._dropout_words(dropout, seed, coords, q.shape[2])
    if kmask is not None:
        kmask = kmask.to(torch.float32).contiguous()
    return _HbFlashFn.apply(q, k, v, kmask, causal,
                            _fa._scale(scale, q.shape[-1]), window, seed,
                            float(dropout), coords)
