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
:class:`_FlashFn`'s backward. That backward needs ``delta = rowsum(dO *
O)`` in fp32 (JAX computes it outside Pallas): on CUDA in bfloat16 or
float16 without key row or dropout kernel 2 computes it itself
(:func:`flash_bwd_dq_delta`, which hands it on to kernel 3); otherwise
it is a torch expression (:func:`_delta`) given to :func:`flash_bwd_dq`.

The arithmetic is the reference's: fp32 scores (the forward scales q
before the product, the backward scales the product), bottom-right
causal masking with an optional sliding window, masked scores at the
finite ``NEG_INF = -1e30``, lse ``= m + log(max(l, 1e-30))``, exact
zeros for rows that see no key, and ``p = exp(s - lse)`` (0 where lse
``<= -0.5e30``) in the backward. lse and delta are plain ``[b * h, sq]``
fp32 tensors (the TPU's ``[bh, sq, 128]`` lane broadcast is a Mosaic
tiling rule), and the backward entries take them as arguments: ring
attention (``ops/ring_attention.py``) calls kernels 2 and 3 on each key
block with the global lse and delta of the combined output, and kernel
1 without a mask on the blocks before the diagonal.

What bounds the kernels: at the headline shape (b8, s1024, h12, d128,
bf16, causal) about 26 GFLOP forward and 90 GFLOP backward against
~100 MB of operands each, so they are bound by tensor-core operations.
For bf16 with ``d <= 128`` they run on the tensor cores: the forward
and dQ in every variant, dK/dV without key row or dropout and at ``d <=
64`` with them, as warp-specialised ``wgmma`` kernels fed by TMA through
a ring of shared tiles (the heaviest tiles first), the key-row and
dropout variants of dK/dV at ``64 < d <= 128`` with ``mma.sync``;
fp32 inputs and ``d > 128`` take fp32-FMA kernels, so fp32 results match
the CPU's plain versions to fp32 rounding. float16 runs every one of
these kernels and variants instantiated at ``__half`` (``csrc/
flash_attention_fp16.cu``, a library of its own: :func:`_lib`), as
bfloat16 runs them, with the same rule by head_dim. All read q/k/v
through their
(batch, seq, head) strides, so the ``[b, s, h, d]`` views of the fused
QKV projection go in without the three transposes JAX makes (TMA needs
16-byte aligned starts and strides, which the checks below require); a
tensor map that cannot be encoded raises. The source's note lists what
later work adds.

The TPU kernels' two variants are template flags of the same kernels:

- ``kmask``: an additive fp32 key row per query head, ``[b * h, 1,
  sk]`` (``_flash_call``'s form), added to the scaled scores after the
  causal mask; :func:`flash_bwd_dkv` then also returns its gradient
  ``dmask = sum over query rows of ds / scale``, per query head;
- ``dropout`` with two ``seed`` words: the reference's counter-hash mask
  (``_keep_mask``, bit for bit; :func:`_keep_mask_ref` is its plain
  version) over the global (query head ``b * h + i``, row, key). The
  row sum keeps the undropped probabilities; only P.V sees ``p * keep /
  (1 - rate)``, and the backward masks dO.V^T the same way. A launch
  over a rank's part of the batch or the heads (dp, mp) takes ``coords
  = (first batch row, first head, global heads)`` and hashes head ``(b0
  + b) * hg + h0 + i``: the global coordinates the reference's kernel
  sees under GSPMD, so every layout drops the elements one card drops.

The encoder path reaches the per-batch-row mask through
``ops/cuda/head_flash.py`` (kernels 4-6, which share these kernels'
code).

The tile mode (``tmask``) takes any additive fp32 mask that broadcasts to
``[b, h, sq, sk]``: a 4-D tensor whose batch, head and query dims are
either full or 1 and whose key dim is full and contiguous. The kernels
read it through its strides (0 over a broadcast dim) and add
``mask[b, h, r, c]`` to score ``(r, c)`` before the causal mask, as the
reference's composite adds ``logits + mask`` (``nn/functional/
attention.py:37-45``); no TPU kernel takes such a mask. It has no
window. A row whose every score is the reference's ``-1e30`` (lse ``<=
-0.5e30``) is fully masked: its softmax is uniform over the ``sk``
keys, as the reference's softmax of equal scores is, and its dS is 0
where the row does not see the key (the causal mask).
:func:`flash_bwd_dkv` returns the mask's gradient ``ds / scale`` per
element as ``[b * h, sq, sk]`` fp32 when ``tmask_grad`` is set; the
caller sums it over the broadcast dims. bfloat16 and float16 at ``d <=
128`` run the wgmma kernels; fp32 and ``d > 128`` the fp32-FMA kernels,
which visit every tile. On wgmma the kernels skip what is
exactly zero: :func:`tile_classes` (a kernel of its own) classes each
64 x 64 cell of the mask as DEAD (every value at or below ``-0.5e30``),
ZERO (every value 0) or MIXED and flags each 64-row cell row that holds
a fully masked row, once per attention call (:class:`_FlashFn` runs it
with the forward and hands the table to dQ and dK/dV; a kernel entry
called alone runs its own). The forward (128 rows x 64-key cells, one
block a streaming multiprocessor walking the row tiles) skips a DEAD
cell and a tile past its rows' causal band unless the cell row is
flagged; dQ and dK/dV skip a DEAD cell (its p is 0) unless its rows
hold a fully masked row, dK/dV the query tiles before the causal band
likewise, dQ every tile past it; a ZERO cell adds nothing, and a MIXED
cell's mask is staged in shared memory by the producer warp. dQ
computes delta itself (:func:`flash_bwd_dq_delta` with ``tmask``),
dK/dV runs the wgmma kernel (rings of 2 stages at ``d > 64``, where the
mask tiles fill shared memory). Its launches count on
``flash_fwd.tile_launches``,
``flash_bwd_dq.tile_launches`` (either dQ entry) and
``flash_bwd_dkv.tile_launches``, not on ``.launches``, and the class
pass on ``tile_classes.launches``.

Wrapper rules: CPU tensors go to the plain versions
(:func:`flash_fwd_ref`, :func:`flash_bwd_dq_ref`,
:func:`flash_bwd_dkv_ref`, :func:`flash_bwd_dq_delta_ref`); CUDA tensors
launch the kernel or raise — there is no fallback. ``flash_fwd.launches``,
``flash_bwd_dq.launches`` (kernel 2 through either entry) and
``flash_bwd_dkv.launches`` count kernel launches (plain ints; reset them
by assignment).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
           "flash_bwd_dq_delta", "tile_classes", "flash_fwd_ref",
           "flash_bwd_dq_ref", "flash_bwd_dkv_ref", "flash_bwd_dq_delta_ref",
           "tile_classes_ref"]

NEG_INF = -1e30
# the tile mode's cells and their classes (csrc's kCell, kTileMixed,
# kTileZero, kTileDead)
CELL = 64
TILE_MIXED, TILE_ZERO, TILE_DEAD = 0, 1, 2
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1,  # flash_attention.cu
               torch.float16: 2}
_M32 = 0xFFFFFFFF


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
        raise ValueError(f"q, k and v must be float32, bfloat16 or float16, "
                         f"got {q.dtype}")
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


def _check_kmask(kmask, rows, q, k):
    """Raise ``ValueError`` unless ``kmask`` is a contiguous fp32 ``[rows,
    1, sk]`` tensor on q's device."""
    sk = k.shape[1]
    if not isinstance(kmask, torch.Tensor) or kmask.dtype != torch.float32 \
            or tuple(kmask.shape) != (rows, 1, sk) \
            or not kmask.is_contiguous() or kmask.device != q.device:
        raise ValueError(f"kmask must be a contiguous float32 [{rows}, 1, "
                         f"{sk}] tensor on {q.device}")


def _mask_strides(tmask):
    """A 4-D mask's (batch, head, query-row) strides in elements, 0 over a
    broadcast dim (size 1)."""
    return tuple(0 if n == 1 else st
                 for n, st in zip(tmask.shape[:3], tmask.stride()[:3]))


def _check_tmask(tmask, q, k):
    """Raise ``ValueError`` unless ``tmask`` is a float32 4-D tensor on
    q's device that broadcasts to ``[b, h, sq, sk]`` with a full,
    contiguous key dim; returns its (batch, head, query-row) strides in
    elements, 0 over a broadcast dim."""
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    want = (b, h, sq, sk)
    if not isinstance(tmask, torch.Tensor) or tmask.dtype != torch.float32 \
            or tmask.dim() != 4 or tmask.device != q.device \
            or tmask.shape[3] != sk or tmask.stride(3) != 1 \
            or any(n not in (1, w) for n, w in zip(tmask.shape[:3], want)):
        raise ValueError(f"tmask must be a float32 tensor on {q.device} that "
                         f"broadcasts to [b, h, sq, sk] = {list(want)} with a "
                         f"full, contiguous key dim; got "
                         f"{getattr(tmask, 'dtype', type(tmask))} "
                         f"{tuple(getattr(tmask, 'shape', ()))}")
    return _mask_strides(tmask)


def _threshold(rate):
    """The keep threshold of the counter hash, as the reference computes
    it (float64 on the host)."""
    return min(int(rate * 4294967296.0), 4294967295)


def _coords(coords, heads):
    """``(global heads, first batch row, first head)`` of the dropout
    hash from ``coords = (first batch row, first head, global heads)``
    (None: the launch is the whole tensor, ``(heads, 0, 0)``); raises
    ``ValueError`` unless the launch's ``heads`` fit in the global
    ones."""
    if coords is None:
        return heads, 0, 0
    if len(coords) != 3 or not all(isinstance(c, int) for c in coords):
        raise ValueError(f"coords must be three ints (first batch row, "
                         f"first head, global heads), got {coords!r}")
    b0, h0, hg = coords
    if b0 < 0 or h0 < 0 or h0 + heads > hg:
        raise ValueError(f"coords {coords!r}: heads [{h0}, {h0 + heads}) "
                         f"do not lie in the {hg} global heads")
    return hg, b0, h0


def _dropout_words(dropout, seed, coords=None, heads=0):
    """``(seed0, seed1, threshold, global heads, first batch row, first
    head)`` as uint32 and the fp32 scale ``1 / (1 - dropout)`` of the
    counter-hash dropout, or None without it. The hash takes the query
    head ``(b0 + b) * hg + h0 + i`` of the launch's batch row ``b`` and
    head ``i`` (:func:`_coords`; ``heads`` is the launch's count)."""
    if not isinstance(dropout, (int, float)) or not 0.0 <= dropout < 1.0:
        raise ValueError(f"dropout must be a float in [0, 1), got "
                         f"{dropout!r}")
    if dropout == 0.0:
        return None
    if seed is None or len(seed) != 2:
        raise ValueError("dropout > 0 needs seed: two int words (the "
                         "reference's int32[2] seed operand)")
    s0, s1 = (int(w) & _M32 for w in seed)
    return ((s0, s1, _threshold(dropout), *_coords(coords, heads)),
            1.0 / (1.0 - dropout))


# -- plain versions -----------------------------------------------------------

def _mul32(a, c):
    """``a * c mod 2**32`` for int64 ``a`` in ``[0, 2**32)`` and a 32-bit
    constant ``c``, without leaving int64's range."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _keep_mask_ref(seed, heads, sq, sk, rate):
    """Plain version of the reference's ``_keep_mask``
    (``paddle_tpu/ops/pallas/flash_attention.py:54``): the bool keep mask
    ``heads.shape + (sq, sk)`` of the query heads ``heads`` (flattened
    ``b * h + i`` indices, an int tensor) over global rows and keys. A
    murmur3 fmix32 of ``row * 0x27D4EB2F + key * 0x165667B1 + seed0 *
    0x9E3779B9 + (head + 1) * 0x85EBCA6B + seed1`` in uint32 arithmetic
    (int64 here, reduced mod 2**32), kept where it is >= the threshold."""
    return _hash(seed, heads, sq, sk) >= _threshold(rate)


def _hash(seed, heads, sq, sk):
    """The counter hash of :func:`_keep_mask_ref`, int64 in ``[0,
    2**32)``."""
    base = (int(seed[0]) * 0x9E3779B9 + int(seed[1])) & _M32
    heads = torch.as_tensor(heads).to(torch.int64)
    salt = (_mul32(heads + 1, 0x85EBCA6B) + base) & _M32
    rows = _mul32(torch.arange(sq, device=heads.device), 0x27D4EB2F)
    cols = _mul32(torch.arange(sk, device=heads.device), 0x165667B1)
    x = (rows[:, None] + cols[None, :] + salt[..., None, None]) & _M32
    x ^= x >> 16
    x = _mul32(x, 0x85EBCA6B)
    x ^= x >> 13
    x = _mul32(x, 0xC2B2AE35)
    x ^= x >> 16
    return x


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


def _masked_scores(q, k, scale, causal, window, prescale, kmask=None,
                   tmask=None):
    """fp32 scores ``[b, h_kv, g, sq, sk]`` with masked entries at
    NEG_INF, plus the additive key rows ``kmask`` (``[b * h, 1, sk]``)
    when given, or the tile mode's ``tmask`` added before the causal mask.
    ``prescale`` multiplies q by the scale before the product (the
    forward), else the product is scaled (the backward)."""
    qg = _grouped(q, k.shape[2])
    kf = k.to(torch.float32)
    if prescale:
        s = torch.einsum("bqkgd,bckd->bkgqc", qg * scale, kf)
    else:
        s = scale * torch.einsum("bqkgd,bckd->bkgqc", qg, kf)
    if tmask is not None:
        b, sq, h, _ = q.shape
        s = s + tmask.to(torch.float32).expand(b, h, sq, -1).reshape(s.shape)
    vis = _visible(q.shape[1], k.shape[1], causal, window, q.device)
    if vis is not None:
        s = torch.where(vis, s, torch.full((), NEG_INF, device=q.device))
    if kmask is not None:
        s = s + kmask.to(torch.float32).reshape(*s.shape[:3], 1, -1)
    return s


def _drop_factor(drop, q, k):
    """``keep / (1 - rate)`` in fp32, ``[b, h_kv, g, sq, sk]``, or None;
    ``drop`` as :func:`_dropout_words` returns it."""
    if drop is None:
        return None
    (s0, s1, threshold, hg, b0, h0), dscale = drop
    b, sq, h, _ = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    heads = ((torch.arange(b, device=q.device)[:, None] + b0) * hg + h0
             + torch.arange(h, device=q.device)[None, :])
    heads = heads.reshape(b, h_kv, h // h_kv)
    keep = _hash((s0, s1), heads, sq, sk) >= threshold
    return torch.where(keep, torch.tensor(dscale, dtype=torch.float32,
                                          device=q.device), 0.0)


def _sees(q, k, causal):
    """``[sq]`` bool: whether each query row sees a key (the tile mode,
    which has no window)."""
    vis = _visible(q.shape[1], k.shape[1], causal, 0, q.device)
    if vis is None:
        return torch.ones(q.shape[1], dtype=torch.bool, device=q.device)
    return vis.any(-1)


def flash_fwd_ref(q, k, v, *, causal, scale=None, window=0, kmask=None,
                  seed=None, dropout=0.0, coords=None, tmask=None):
    """Plain version of :func:`flash_fwd`: a one-pass fp32 softmax
    attention with the kernel's masking, key rows or tile mask, and
    dropout (at the global ``coords``). Returns
    (O ``[b, sq, h, d]`` in q's dtype, lse ``[b * h, sq]`` fp32)."""
    b, sq, h, d = q.shape
    s = _masked_scores(q, k, _scale(scale, d), causal, window, True, kmask,
                       tmask)
    lse = torch.logsumexp(s, dim=-1)  # [b, h_kv, g, sq]
    # p by the max-subtracted softmax, as the kernels' running max and sum
    # give it; exp(s - lse) would carry lse's rounding, up to 2**-11 of p
    # in a row whose keys are all padded at -1e4
    p = torch.softmax(s, dim=-1)
    factor = _drop_factor(_dropout_words(dropout, seed, coords, h), q, k)
    if factor is not None:  # the row sum (lse) keeps the undropped p
        p = p * factor
    out = torch.einsum("bkgqc,bckd->bqkgd", p, v.to(torch.float32))
    # rows with no visible key: lse stays ~NEG_INF and O is exactly 0; in
    # the tile mode a fully masked row (its scores all -1e30) keeps the
    # uniform average that softmax gives it
    valid = (lse > 0.5 * NEG_INF).permute(0, 3, 1, 2)[..., None]
    if tmask is not None:
        valid = _sees(q, k, causal)[None, :, None, None, None]
    out = torch.where(valid, out, torch.zeros((), device=q.device))
    return out.reshape(b, sq, h, d).to(q.dtype), lse.reshape(b * h, sq)


def _probs_and_ds(q, k, v, do, lse, delta, scale, causal, window, kmask,
                  drop, tmask=None):
    """Recomputed p (dropped, the dV operand) and ds ``[b, h_kv, g, sq,
    sk]`` fp32; dO.V^T is masked and scaled before ds. In the tile mode a
    fully masked row (lse ``<= -0.5e30``) takes ``1 / sk`` on every key
    when it sees one, and ds is 0 where the row does not see the key."""
    b, sq, h, d = q.shape
    h_kv = k.shape[2]
    sk = k.shape[1]
    s = _masked_scores(q, k, scale, causal, window, False, kmask, tmask)
    lse = lse.reshape(b, h_kv, h // h_kv, sq, 1)
    zero = torch.zeros((), device=q.device)
    p = torch.where(lse > 0.5 * NEG_INF, torch.exp(s - lse), zero)
    if tmask is not None:
        full = torch.where(_sees(q, k, causal)[:, None], 1.0 / sk, zero)
        p = torch.where(lse > 0.5 * NEG_INF, p, full)
    dp = torch.einsum("bqkgd,bckd->bkgqc", _grouped(do, h_kv),
                      v.to(torch.float32))
    factor = _drop_factor(drop, q, k)
    pd = p
    if factor is not None:
        dp = dp * factor
        pd = p * factor
    ds = p * (dp - delta.reshape(b, h_kv, h // h_kv, sq, 1)) * scale
    if tmask is not None:
        vis = _visible(sq, sk, causal, 0, q.device)
        if vis is not None:
            ds = torch.where(vis, ds, zero)
    return pd, ds


def flash_bwd_dq_ref(q, k, v, do, lse, delta, *, causal, scale=None,
                     window=0, kmask=None, seed=None, dropout=0.0,
                     coords=None, tmask=None):
    """Plain version of :func:`flash_bwd_dq`: dQ ``[b, sq, h, d]`` in q's
    dtype from the recomputed probabilities."""
    b, sq, h, d = q.shape
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, _scale(scale, d), causal,
                          window, kmask,
                          _dropout_words(dropout, seed, coords, h), tmask)
    dq = torch.einsum("bkgqc,bckd->bqkgd", ds, k.to(torch.float32))
    return dq.reshape(b, sq, h, d).to(q.dtype)


def flash_bwd_dkv_ref(q, k, v, do, lse, delta, *, causal, scale=None,
                      window=0, kmask=None, seed=None, dropout=0.0,
                      coords=None, tmask=None, tmask_grad=False):
    """Plain version of :func:`flash_bwd_dkv`: (dK, dV) ``[b, sk, h_kv,
    d]`` in k's dtype, summed over each kv head's query-head group, and
    with ``kmask`` also dmask ``[b * h, 1, sk]`` fp32 (the sum of ds /
    scale over each head's query rows), with ``tmask_grad`` dmask ``[b *
    h, sq, sk]`` fp32 (ds / scale)."""
    b, sq, h, d = q.shape
    scale = _scale(scale, d)
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, scale, causal, window,
                          kmask, _dropout_words(dropout, seed, coords, h),
                          tmask)
    h_kv = k.shape[2]
    dv = torch.einsum("bkgqc,bqkgd->bckd", p, _grouped(do, h_kv))
    dk = torch.einsum("bkgqc,bqkgd->bckd", ds, _grouped(q, h_kv))
    if tmask is not None and tmask_grad:
        return dk.to(k.dtype), dv.to(v.dtype), \
            (ds / scale).reshape(b * h, sq, -1)
    if kmask is None:
        return dk.to(k.dtype), dv.to(v.dtype)
    dmask = (ds / scale).sum(3).reshape(b * h, 1, -1)
    return dk.to(k.dtype), dv.to(v.dtype), dmask


def tile_classes_ref(tmask, sq, sk, causal=False, full_rows=False):
    """Plain version of :func:`tile_classes`: uint8 ``[mb, mh, ceil(sq /
    64), ceil(sk / 64)]``, the class of each 64 x 64 cell of the mask
    (``mb``, ``mh``: 1 over a broadcast batch or head dim, whose one
    slice is classed): TILE_DEAD where every value is at or below
    ``-0.5e30``, TILE_ZERO where every value is 0, else TILE_MIXED; a
    cell past ``sq`` or ``sk`` counts by its in-range part. With
    ``full_rows`` also the full-row flags, uint8 ``[mb, mh, ceil(sq /
    64)]``: 1 where some row of the 64 that sees a key (bottom-right
    causal under ``causal``) has no value above ``-0.5e30`` among the
    keys it sees (a fully masked row)."""
    kb, kh, _ = _mask_strides(tmask)
    m = tmask[:None if kb else 1, :None if kh else 1].to(torch.float32)
    m = m.expand(-1, -1, sq, sk)
    pad = (0, -sk % CELL, 0, -sq % CELL)

    def every(x):  # per cell; padding counts as true
        x = torch.nn.functional.pad(x.to(torch.uint8), pad, value=1)
        mb, mh, rows, cols = x.shape
        return x.reshape(mb, mh, rows // CELL, CELL, cols // CELL,
                         CELL).amin((3, 5)).bool()

    dead, zero = every(m <= 0.5 * NEG_INF), every(m == 0)
    classes = torch.where(dead, TILE_DEAD, torch.where(
        zero, TILE_ZERO, TILE_MIXED)).to(torch.uint8)
    if not full_rows:
        return classes
    live = m > 0.5 * NEG_INF
    vis = _visible(sq, sk, causal, 0, m.device)
    if vis is not None:
        live &= vis
    sees = torch.ones(sq, dtype=torch.bool, device=m.device) \
        if vis is None else vis.any(-1)
    full = ~live.any(-1) & sees  # [mb, mh, sq]
    full = torch.nn.functional.pad(full, (0, -sq % CELL))
    flags = full.reshape(*full.shape[:2], -1, CELL).any(-1)
    return classes, flags.to(torch.uint8)


# -- kernels ------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# after the data pointers: geom, scale, strides, drop, dscale, dtype, stream
_TAIL = [_P, _F, _P, _P, _F, _I, _P]
_TENSOR_MAP_ERROR = 1000  # flash_attention.cu's kTensorMapError


def _lib(dtype=None):
    """The kernels' library for q's ``dtype``: float16 runs the float16
    build of the same source (``csrc/flash_attention_fp16.cu``), every
    other dtype ``csrc/flash_attention.cu``."""
    return _load("flash_attention_fp16" if dtype == torch.float16
                 else "flash_attention")


@functools.cache
def _load(name):
    lib = _build.library(name)
    for prefix in ("pt_flash", "pt_hb"):
        for entry, n_ptr in (("fwd", 6), ("bwd_dq", 8), ("bwd_dkv", 10)):
            # pt_hb_bwd_dkv also takes the per-head dmask scratch
            n_ptr += prefix == "pt_hb" and entry == "bwd_dkv"
            fn = getattr(lib, f"{prefix}_{entry}")
            fn.argtypes = [_P] * n_ptr + _TAIL
            fn.restype = _I
    lib.pt_flash_bwd_dq_delta.argtypes = [_P] * 8 + _TAIL
    lib.pt_flash_bwd_dq_delta.restype = _I
    # the head-batched fused dQ also takes the key row
    lib.pt_hb_bwd_dq_delta.argtypes = [_P] * 9 + _TAIL
    lib.pt_hb_bwd_dq_delta.restype = _I
    # the tile mode: the mask, the class table (and the forward's
    # full-row flags) and the strides, and dK/dV's dmask
    for entry, n_ptr in (("fwd", 9), ("bwd_dq", 10), ("bwd_dq_delta", 11),
                         ("bwd_dkv", 12)):
        fn = getattr(lib, f"pt_flash_tile_{entry}")
        fn.argtypes = [_P] * n_ptr + _TAIL
        fn.restype = _I
    lib.pt_flash_tile_classes.argtypes = [_P, _P] + [_I] * 5 + [_P] * 3
    lib.pt_flash_tile_classes.restype = _I
    return lib


def _launch(entry, name, tensors, q, k, causal, window, scale, strided,
            drop):
    """Call one C entry: data pointers (None for an absent key row; an
    int is a host address, the tile mask's strides), then the geometry
    and the (batch, seq, head) strides of the ``strided`` tensors, as
    host arrays the entry reads before it returns, and the dropout
    words."""
    b, sq, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    geom = (ctypes.c_int * 8)(b, h, h_kv, sq, sk, d, int(causal), window)
    strides = (ctypes.c_longlong * (3 * len(strided)))(
        *(s for t in strided for s in t.stride()[:3]))
    words, dscale = (None, 1.0) if drop is None else drop
    if words is not None:
        words = (ctypes.c_uint * 6)(*words)
    err = entry(*(t if t is None or isinstance(t, int) else t.data_ptr()
                  for t in tensors),
                ctypes.addressof(geom), scale, ctypes.addressof(strides),
                None if words is None else ctypes.addressof(words), dscale,
                _DTYPE_CODE[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    if err >= _TENSOR_MAP_ERROR:
        raise RuntimeError(f"{name}: a TMA tensor map could not be encoded "
                           f"(CUresult {err - _TENSOR_MAP_ERROR})")
    if err:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {err})")


def _fwd(entry, name, q, k, v, kmask, scale, causal, window, drop):
    """Launch a forward entry; returns (O, lse ``[b * h, sq]``).
    ``kmask``: the key rows (or None), or the tile entries' ``(mask,
    strides address)``."""
    b, sq, h, _ = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    mask = kmask if isinstance(kmask, tuple) else (kmask,)
    _launch(entry, name, (q, k, v, out, lse, *mask), q, k, causal, window,
            scale, (q, k, v, out), drop)
    return out, lse


def _bwd_dq(entry, name, q, k, v, do, lse, delta, kmask, scale, causal,
            window, drop):
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    mask = kmask if isinstance(kmask, tuple) else (kmask,)
    _launch(entry, name, (q, k, v, do, lse, delta, dq, *mask), q, k, causal,
            window, scale, (q, k, v, do, dq), drop)
    return dq


def _bwd_dq_delta(entry, name, q, k, v, do, out, lse, scale, causal, window,
                  drop, kmask=()):
    """Launch a dQ entry that also computes delta (bfloat16 or float16
    with ``d <= 128``; anything else raises); returns (dQ, delta
    ``[b * h, sq]``). ``kmask``: the mask operands of an entry that takes
    them (``(key rows or None,)``; the tile mode's mask, class table and
    strides address)."""
    b, sq, h, d = q.shape
    if not _fusable(q):
        raise ValueError(f"{name} takes float16 or bfloat16 with head_dim "
                         f"<= 128, got {q.dtype} and {d}")
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    delta = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    _launch(entry, name, (q, k, v, do, out, lse, delta, dq, *kmask), q, k,
            causal, window, scale, (q, k, v, do, out, dq), drop)
    return dq, delta


def _bwd_dkv(entry, name, q, k, v, do, lse, delta, kmask, dm_rows, scale,
             causal, window, drop, head_sum=False):
    """Launch a dK/dV entry; returns (dK, dV) and, with ``kmask``, the
    ``[dm_rows, 1, sk]`` fp32 dmask. ``head_sum``: the head-batched entry,
    which writes per-head dmask rows into a ``[b * h, 1, sk]`` scratch and
    sums them over heads into dmask."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    dm = scratch = None
    if kmask is not None:
        dm = torch.empty((dm_rows, 1, k.shape[1]), dtype=torch.float32,
                         device=q.device)
        if head_sum:
            scratch = torch.empty((q.shape[0] * q.shape[2], 1, k.shape[1]),
                                  dtype=torch.float32, device=q.device)
    ptrs = (q, k, v, do, lse, delta, dk, dv, kmask, dm)
    _launch(entry, name, ptrs + ((scratch,) if head_sum else ()), q, k,
            causal, window, scale, (q, k, v, do, dk, dv), drop)
    return (dk, dv) if dm is None else (dk, dv, dm)


def _tile_args(q, k, kmask, tmask, window, blocks=0):
    """The tile mode's checks (a call takes a key row or a tile mask, not
    both, and the tile mode no window): the tile mask's (batch, head,
    query-row) strides and the class table's (batch, head) strides (0
    over a broadcast dim), then the forward's block count (``blocks``; 0:
    one a streaming multiprocessor), as the host array the tile entries
    read, or None without one."""
    if tmask is None:
        return None
    if kmask is not None or window:
        raise ValueError("tmask takes neither kmask nor a window")
    kb, kh, kq = _check_tmask(tmask, q, k)
    cells = -(-q.shape[1] // CELL) * -(-k.shape[1] // CELL)
    heads = q.shape[2] if kh else 1
    return (ctypes.c_longlong * 6)(kb, kh, kq, kb and heads * cells,
                                   kh and cells, blocks)


def tile_classes(tmask, sq, sk, causal=False, full_rows=False):
    """The tile mode's class table: uint8 ``[mb, mh, ceil(sq / 64),
    ceil(sk / 64)]``, the class of each 64 x 64 cell of the fp32 mask
    ``tmask`` (4-D, broadcasting to ``[b, h, sq, sk]`` with a full,
    contiguous key dim; ``mb``, ``mh`` 1 over a broadcast dim), and with
    ``full_rows`` also its full-row flags (uint8 ``[mb, mh, ceil(sq /
    64)]``, bottom-right causal under ``causal``), as
    :func:`tile_classes_ref` gives them. One launch reads the mask once
    and writes both (``pt_flash_tile_classes``); the tile mode's wgmma
    kernels read the table to skip dead cells, the forward also the
    flags. Counts on ``tile_classes.launches``."""
    if not isinstance(tmask, torch.Tensor) or tmask.dtype != torch.float32 \
            or tmask.dim() != 4 or tmask.shape[3] != sk \
            or tmask.stride(3) != 1 or tmask.shape[2] not in (1, sq):
        raise ValueError(f"tmask must be a float32 [mb, mh, 1 or {sq}, "
                         f"{sk}] tensor with a contiguous key dim")
    if not tmask.is_cuda:
        return tile_classes_ref(tmask, sq, sk, causal, full_rows)
    kb, kh, kq = _mask_strides(tmask)
    mb, mh = (tmask.shape[0] if kb else 1), (tmask.shape[1] if kh else 1)
    rows = -(-sq // CELL)
    out = torch.empty((mb, mh, rows, -(-sk // CELL)), dtype=torch.uint8,
                      device=tmask.device)
    flags = torch.empty((mb, mh, rows), dtype=torch.uint8,
                        device=tmask.device)
    strides = (ctypes.c_longlong * 3)(kb, kh, kq)
    err = _lib().pt_flash_tile_classes(
        tmask.data_ptr(), ctypes.addressof(strides), mb, mh, sq, sk,
        int(causal), out.data_ptr(), flags.data_ptr(),
        torch.cuda.current_stream(tmask.device).cuda_stream)
    if err:
        raise RuntimeError(f"tile_classes kernel launch failed (cudaError "
                           f"{err})")
    tile_classes.launches += 1
    return (out, flags) if full_rows else out


def _tile_table(q, tmask, table, causal):
    """The (class table, full-row flags) pair that the tile mode's wgmma
    kernels read: ``table`` if the caller computed it, else a new one
    (one class pass); None for the fp32-FMA kernels, which visit every
    tile. The tile mode runs the wgmma kernels where :func:`_fusable`
    holds."""
    if not _fusable(q):
        return None
    return tile_classes(tmask, q.shape[1], tmask.shape[3], causal=causal,
                        full_rows=True) if table is None else table


def _classes(q, tmask, table, causal):
    """The class table of :func:`_tile_table`'s pair (the backward reads
    no flags), or None."""
    table = _tile_table(q, tmask, table, causal)
    return None if table is None else table[0]


def flash_fwd(q, k, v, *, causal, scale=None, window=0, kmask=None,
              seed=None, dropout=0.0, coords=None, tmask=None):
    """Attention forward. q ``[b, sq, h, d]``, k/v ``[b, sk, h_kv, d]``
    (float32, bfloat16 or float16; last dim contiguous, ``h % h_kv == 0``,
    ``d % 8 == 0``, ``d <= 256``); optional ``kmask`` ``[b * h, 1, sk]``
    fp32, or ``tmask`` (the tile mode: fp32, broadcasting to ``[b, h, sq,
    sk]``), and ``dropout`` with two ``seed`` words, hashed at ``coords``
    (first batch row, first head, global heads; None: this tensor is the
    whole batch and all heads). Returns (O ``[b, sq, h, d]`` in q's
    dtype, lse ``[b * h, sq]`` fp32). In the tile mode on wgmma the call
    runs the class pass too."""
    return _flash_fwd(q, k, v, None, causal=causal, scale=scale,
                      window=window, kmask=kmask, seed=seed, dropout=dropout,
                      coords=coords, tmask=tmask)


def _flash_fwd(q, k, v, table, *, causal, scale=None, window=0, kmask=None,
               seed=None, dropout=0.0, coords=None, tmask=None, blocks=0):
    """:func:`flash_fwd` given the tile mode's (class table, full-row
    flags) pair (``table``, or None: computed here when the kernel reads
    one); ``blocks``: the tile forward's grid (0: one block a streaming
    multiprocessor)."""
    _check(q, k, v, causal, window)
    kms = _tile_args(q, k, kmask, tmask, window, blocks)
    drop = _dropout_words(dropout, seed, coords, q.shape[2])
    if kmask is not None:
        _check_kmask(kmask, q.shape[0] * q.shape[2], q, k)
    scale = _scale(scale, q.shape[-1])
    if not q.is_cuda:
        return flash_fwd_ref(q, k, v, causal=causal, scale=scale,
                             window=window, kmask=kmask, seed=seed,
                             dropout=dropout, coords=coords, tmask=tmask)
    if tmask is not None:
        res = _fwd(_lib(q.dtype).pt_flash_tile_fwd, "flash_fwd (tile mode)",
                   q, k, v, (tmask, *(_tile_table(q, tmask, table, causal)
                                      or (None, None)),
                             ctypes.addressof(kms)),
                   scale, causal, window, drop)
        flash_fwd.tile_launches += 1
        return res
    res = _fwd(_lib(q.dtype).pt_flash_fwd, "flash_fwd", q, k, v, kmask,
               scale, causal, window, drop)
    flash_fwd.launches += 1
    return res


def _check_stats(q, **stats):
    b, sq, h, _ = q.shape
    for name, t in stats.items():
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 \
                or tuple(t.shape) != (b * h, sq) or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"[b * h, sq] = [{b * h}, {sq}] tensor on "
                             f"{q.device}")


def _check_bwd(q, k, v, do, lse, delta, causal, window, kmask, rows,
               dropout, seed, coords):
    """The backward entries' checks; returns the dropout words."""
    _check(q, k, v, causal, window, extra=(("do", do),))
    _check_stats(q, lse=lse, delta=delta)
    if kmask is not None:
        _check_kmask(kmask, rows, q, k)
    return _dropout_words(dropout, seed, coords, q.shape[2])


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal, scale=None, window=0,
                 kmask=None, seed=None, dropout=0.0, coords=None, tmask=None):
    """dQ ``[b, sq, h, d]`` (q's dtype) from dO (q's shape and dtype), the
    forward's lse and ``delta = rowsum(dO * O)``, both ``[b * h, sq]``
    fp32; ``kmask`` or ``tmask``, ``seed``, ``dropout`` and ``coords`` as
    the forward had them."""
    drop = _check_bwd(q, k, v, do, lse, delta, causal, window, kmask,
                      q.shape[0] * q.shape[2], dropout, seed, coords)
    kms = _tile_args(q, k, kmask, tmask, window)
    scale = _scale(scale, q.shape[-1])
    if not q.is_cuda:
        return flash_bwd_dq_ref(q, k, v, do, lse, delta, causal=causal,
                                scale=scale, window=window, kmask=kmask,
                                seed=seed, dropout=dropout, coords=coords,
                                tmask=tmask)
    if tmask is not None:
        dq = _bwd_dq(_lib(q.dtype).pt_flash_tile_bwd_dq,
                     "flash_bwd_dq (tile mode)", q, k, v, do, lse, delta,
                     (tmask, _classes(q, tmask, None, causal),
                      ctypes.addressof(kms)), scale, causal, window, drop)
        flash_bwd_dq.tile_launches += 1
        return dq
    dq = _bwd_dq(_lib(q.dtype).pt_flash_bwd_dq, "flash_bwd_dq", q, k, v, do,
                 lse, delta, kmask, scale, causal, window, drop)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal, scale=None,
                  window=0, kmask=None, seed=None, dropout=0.0, coords=None,
                  tmask=None, tmask_grad=False):
    """(dK, dV) ``[b, sk, h_kv, d]`` (k's dtype), each summed over the
    query heads that share its kv head, and with ``kmask`` also dmask
    ``[b * h, 1, sk]`` fp32 per query head, with ``tmask`` and
    ``tmask_grad`` dmask ``[b * h, sq, sk]`` fp32 per element; arguments
    as :func:`flash_bwd_dq`. In the tile mode on wgmma the call runs the
    class pass too."""
    return _dkv(q, k, v, do, lse, delta, None, causal=causal, scale=scale,
                window=window, kmask=kmask, seed=seed, dropout=dropout,
                coords=coords, tmask=tmask, tmask_grad=tmask_grad)


def _dkv(q, k, v, do, lse, delta, table, *, causal, scale=None, window=0,
         kmask=None, seed=None, dropout=0.0, coords=None, tmask=None,
         tmask_grad=False):
    """:func:`flash_bwd_dkv` given the tile mode's table (``table``, as
    :func:`_flash_fwd` takes it, or None: computed here when the kernel
    reads one)."""
    rows = q.shape[0] * q.shape[2]
    drop = _check_bwd(q, k, v, do, lse, delta, causal, window, kmask, rows,
                      dropout, seed, coords)
    kms = _tile_args(q, k, kmask, tmask, window)
    scale = _scale(scale, q.shape[-1])
    if not q.is_cuda:
        return flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal=causal,
                                 scale=scale, window=window, kmask=kmask,
                                 seed=seed, dropout=dropout, coords=coords,
                                 tmask=tmask, tmask_grad=tmask_grad)
    if tmask is not None:
        b, sq, h, _ = q.shape
        dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
        dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
        dm = (torch.zeros((b * h, sq, k.shape[1]), dtype=torch.float32,
                          device=q.device) if tmask_grad else None)
        _launch(_lib(q.dtype).pt_flash_tile_bwd_dkv,
                "flash_bwd_dkv (tile mode)",
                (q, k, v, do, lse, delta, dk, dv, tmask, dm,
                 _classes(q, tmask, table, causal), ctypes.addressof(kms)), q,
                k, causal, window, scale, (q, k, v, do, dk, dv), drop)
        flash_bwd_dkv.tile_launches += 1
        return (dk, dv) if dm is None else (dk, dv, dm)
    res = _bwd_dkv(_lib(q.dtype).pt_flash_bwd_dkv, "flash_bwd_dkv", q, k, v,
                   do, lse, delta, kmask, rows, scale, causal, window, drop)
    flash_bwd_dkv.launches += 1
    return res


def _delta(do, out):
    """``rowsum(dO * O)`` in fp32 as ``[b * h, sq]``."""
    b, sq, h, _ = out.shape
    delta = (do.to(torch.float32) * out.to(torch.float32)).sum(-1)
    return delta.permute(0, 2, 1).reshape(b * h, sq).contiguous()


def flash_bwd_dq_delta_ref(q, k, v, do, out, lse, *, causal, scale=None,
                           window=0, seed=None, dropout=0.0, coords=None,
                           tmask=None):
    """Plain version of :func:`flash_bwd_dq_delta`: (dQ, delta)."""
    delta = _delta(do, out)
    return flash_bwd_dq_ref(q, k, v, do, lse, delta, causal=causal,
                            scale=scale, window=window, seed=seed,
                            dropout=dropout, coords=coords,
                            tmask=tmask), delta


def flash_bwd_dq_delta(q, k, v, do, out, lse, *, causal, scale=None,
                       window=0, seed=None, dropout=0.0, coords=None,
                       tmask=None):
    """Kernel 2 computing delta itself: (dQ ``[b, sq, h, d]``, delta ``=
    rowsum(dO * O)`` ``[b * h, sq]`` fp32) from dO and the forward's O
    (both q's shape and dtype) and lse. One launch: each block sums delta
    for its query rows from the dO tile it holds, writes it out for
    :func:`flash_bwd_dkv`, and goes on to dQ. Takes bfloat16 or float16
    with ``d <= 128``, and no key row (on CUDA; anything else
    raises); dropout (``seed``, ``dropout``, ``coords`` as the forward
    had them) only with the tile mode's ``tmask``, whose call runs the
    class pass too. Its launches count on ``flash_bwd_dq.launches``
    (``.tile_launches`` with ``tmask``): it is kernel 2."""
    return _dq_delta(q, k, v, do, out, lse, None, causal=causal, scale=scale,
                     window=window, seed=seed, dropout=dropout,
                     coords=coords, tmask=tmask)


def _dq_delta(q, k, v, do, out, lse, table, *, causal, scale=None,
              window=0, seed=None, dropout=0.0, coords=None, tmask=None,
              kmask=None):
    """:func:`flash_bwd_dq_delta` given the tile mode's table (``table``,
    as :func:`_flash_fwd` takes it, or None: computed here); ``kmask``
    must be None."""
    if kmask is not None:
        raise ValueError("flash_bwd_dq_delta takes no kmask")
    _check(q, k, v, causal, window, extra=(("do", do), ("out", out)))
    _check_stats(q, lse=lse)
    kms = _tile_args(q, k, None, tmask, window)
    drop = _dropout_words(dropout, seed, coords, q.shape[2])
    scale = _scale(scale, q.shape[-1])
    if not q.is_cuda:
        return flash_bwd_dq_delta_ref(q, k, v, do, out, lse, causal=causal,
                                      scale=scale, window=window, seed=seed,
                                      dropout=dropout, coords=coords,
                                      tmask=tmask)
    if tmask is None:
        if drop is not None:
            raise ValueError("flash_bwd_dq_delta takes dropout only in the "
                             "tile mode (tmask)")
        res = _bwd_dq_delta(_lib(q.dtype).pt_flash_bwd_dq_delta,
                            "flash_bwd_dq_delta", q, k, v, do, out, lse,
                            scale, causal, window, None)
        flash_bwd_dq.launches += 1
        return res
    res = _bwd_dq_delta(_lib(q.dtype).pt_flash_tile_bwd_dq_delta,
                        "flash_bwd_dq_delta (tile mode)", q, k, v, do, out,
                        lse, scale, causal, window, drop,
                        (tmask, _classes(q, tmask, table, causal),
                         ctypes.addressof(kms)))
    flash_bwd_dq.tile_launches += 1
    return res


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0
flash_fwd.tile_launches = 0
flash_bwd_dq.tile_launches = 0
flash_bwd_dkv.tile_launches = 0
tile_classes.launches = 0


# -- autograd -----------------------------------------------------------------


def _upstream(do, q):
    """The upstream gradient in q's dtype and a layout the kernels read."""
    do = do.to(q.dtype)
    if not _vector_aligned(do):  # an upstream gradient with odd strides
        do = do.contiguous()
    return do


def _fusable(q):
    """Whether a dQ kernel can compute delta itself for q: CUDA, bfloat16
    or float16 with ``d <= 128`` (the wgmma kernels)."""
    return q.is_cuda and q.dtype in (torch.bfloat16, torch.float16) \
        and q.shape[-1] <= 128


def _fused_delta(q, args):
    """Whether the backward takes :func:`flash_bwd_dq_delta` (CUDA,
    bfloat16 or float16 with ``d <= 128``, no key row; no dropout outside
    the tile mode; the tile mode on its wgmma kernels)."""
    return _fusable(q) and args["kmask"] is None \
        and (args.get("tmask") is not None or not args["dropout"])


def _sum_to(grad, shape):
    """``grad`` summed over the dims that ``shape`` broadcasts."""
    dims = tuple(i for i, n in enumerate(shape) if n == 1 and grad.shape[i]
                 != 1)
    return grad.sum(dims, keepdim=True) if dims else grad


class _FlashFn(torch.autograd.Function):
    """Forward kernel 1; backward: kernel 2 computing delta itself, then
    kernel 3 (bfloat16 or float16 on CUDA without key row, and without
    dropout outside the tile mode), else delta as torch ops, then kernels
    2 and 3. The tile mode on wgmma runs its class pass once, in the forward,
    whose table the forward and both backward kernels read (a backward
    given a context without it runs the pass itself). kmask's gradient
    is kernel 3's dmask; tmask's is its per-element dmask summed over the
    mask's broadcast dims."""

    @staticmethod
    def forward(ctx, q, k, v, kmask, tmask, causal, scale, window, seed,
                dropout, coords):
        args = dict(causal=causal, scale=scale, window=window, kmask=kmask,
                    seed=seed, dropout=dropout, coords=coords, tmask=tmask)
        table = None if tmask is None else _tile_table(q, tmask, None,
                                                       causal)
        out, lse = _flash_fwd(q, k, v, table, **args)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = args
        ctx.table = table
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = _upstream(do, q)
        args = ctx.args
        tmask = args.get("tmask")
        table = getattr(ctx, "table", None)
        if _fused_delta(q, args):
            if tmask is not None:  # once for both kernels
                table = _tile_table(q, tmask, table, args["causal"])
            dq, delta = _dq_delta(q, k, v, do, out, lse, table, **args)
        else:
            delta = _delta(do, out)
            dq = flash_bwd_dq(q, k, v, do, lse, delta, **args)
        tgrad = tmask is not None and ctx.needs_input_grad[4]
        dk, dv, *dm = _dkv(q, k, v, do, lse, delta, table, **args,
                           tmask_grad=tgrad)
        dkm = dm[0] if dm and tmask is None else None
        dtm = None
        if tgrad:
            b, sq, h, _ = q.shape
            dtm = _sum_to(dm[0].reshape(b, h, sq, -1), tmask.shape)
        return (dq, dk, dv, dkm, dtm, None, None, None, None, None, None)


def flash_attention(q, k, v, *, causal, scale=None, window=0, kmask=None,
                    dropout=0.0, seed=None, coords=None, tmask=None):
    """Differentiable flash attention on the JAX public layout: q
    ``[b, sq, h, d]``, k/v ``[b, sk, h_kv, d]`` -> ``[b, sq, h, d]``.
    ``scale`` defaults to ``1/sqrt(d)``; ``window > 0`` (with ``causal``)
    bounds each row's lookback to ``window`` keys; ``kmask`` (``[b * h,
    1, sk]``, cast to contiguous fp32) adds a key row per query head and
    receives its gradient; ``dropout > 0`` drops attention probabilities
    by the counter hash seeded with the two ``seed`` words, at the global
    ``coords`` (first batch row, first head, global heads) when this
    tensor is a rank's part of the batch or heads; ``tmask`` (the tile
    mode: fp32, broadcasting to ``[b, h, sq, sk]`` with a full contiguous
    key dim) adds a mask to every score and receives its gradient."""
    _check(q, k, v, causal, window)
    _tile_args(q, k, kmask, tmask, window)
    _dropout_words(dropout, seed, coords, q.shape[2])
    if kmask is not None:
        kmask = kmask.to(torch.float32).contiguous()
    return _FlashFn.apply(q, k, v, kmask, tmask, causal,
                          _scale(scale, q.shape[-1]), window, seed,
                          float(dropout), coords)
