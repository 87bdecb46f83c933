"""The port's flash-attention plain versions held against the Pallas
kernels of the JAX package, run in interpret mode on the CPU as
``tests/test_pallas_flash.py`` runs them.

Kernel by kernel, on the same numpy inputs (fp32, d 16):

- ``flash_fwd_ref`` against ``_flash_fwd``: O and ``lse[..., 0]`` within
  2e-5 (fp32; the streaming and the one-pass softmax sum in different
  orders);
- ``flash_bwd_dq_ref`` and ``flash_bwd_dkv_ref`` against
  ``_flash_bwd_impl`` fed the same O, lse and dO: each gradient divided
  by its max abs within 1e-4;
- the autograd ``flash_attention`` against ``jax.grad`` of the Pallas
  path, end to end.

The Pallas side runs with 16-row blocks, so its dead-tile skip and its
partly masked tiles are exercised; the port's versions have no tiles.
Cases: causal and not, window 0 and 24, GQA h4/h_kv2, sq 32 against
sk 64 (bottom-right offset).

The variants on the same terms (fp32, same tolerances): the additive
key rows ``kmask`` (``[b * h, 1, sk]``, a different row per query head)
with their gradient dmask, and dropout 0.1 with the same seed words on
both sides (the counter hash is bit-exact, so the masks agree), against
``_flash_fwd``/``_flash_bwd_impl`` and ``jax.grad`` of ``_flash_call``.
"""
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as fa
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.cuda import flash_attention as tfa

CASES = [
    # (causal, window, h, h_kv, sq, sk)
    (False, 0, 4, 4, 64, 64),
    (True, 0, 4, 4, 64, 64),
    (True, 24, 4, 4, 64, 64),
    (True, 0, 4, 2, 64, 64),
    (True, 24, 4, 2, 64, 64),
    (True, 0, 4, 4, 32, 64),
    (True, 24, 4, 2, 32, 64),
    (False, 0, 4, 2, 32, 64),
]
IDS = [f"causal{int(c)}-w{w}-h{h}kv{hk}-sq{sq}sk{sk}"
       for c, w, h, hk, sq, sk in CASES]
B, D, BLOCK = 2, 16, 16


@pytest.fixture(autouse=True)
def _highest_precision():
    # scoped: the tests that run after this file keep their own setting
    with jax.default_matmul_precision("highest"):
        yield


def _inputs(seed, h, h_kv, sq, sk):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, sq, h, D).astype(np.float32)
    k = rng.randn(B, sk, h_kv, D).astype(np.float32)
    v = rng.randn(B, sk, h_kv, D).astype(np.float32)
    do = rng.randn(B, sq, h, D).astype(np.float32)
    return q, k, v, do


def _bh(x):
    """[b, s, h, d] numpy -> the Pallas kernels' [b * h, s, d]."""
    b, s, h, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


def _bshd(x, h):
    """[b * h, s, d] -> [b, s, h, d] numpy."""
    x = np.asarray(x)
    bh, s, d = x.shape
    return x.reshape(bh // h, h, s, d).transpose(0, 2, 1, 3)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close_normalized(got, want, atol=1e-4, name=""):
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, atol=atol,
                               rtol=0, err_msg=name)


def _jax_fwd(q, k, v, causal, window):
    scale = 1.0 / math.sqrt(D)
    out, lse = fa._flash_fwd(_bh(q), _bh(k), _bh(v), causal, scale, True,
                             BLOCK, BLOCK, window)
    return out, lse


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fwd_plain_matches_pallas(case):
    causal, window, h, h_kv, sq, sk = case
    q, k, v, _ = _inputs(0, h, h_kv, sq, sk)
    jout, jlse = _jax_fwd(q, k, v, causal, window)
    out, lse = tfa.flash_fwd_ref(_t(q), _t(k), _t(v), causal=causal,
                                 window=window)
    assert out.shape == q.shape and lse.shape == (B * h, sq)
    np.testing.assert_allclose(out.numpy(), _bshd(jout, h), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bwd_plain_matches_pallas(case):
    causal, window, h, h_kv, sq, sk = case
    q, k, v, do = _inputs(1, h, h_kv, sq, sk)
    jout, jlse = _jax_fwd(q, k, v, causal, window)
    scale = 1.0 / math.sqrt(D)
    jdq, jdk, jdv, _ = fa._flash_bwd_impl(
        _bh(q), _bh(k), _bh(v), jout, jlse, _bh(do), causal, scale, True,
        BLOCK, BLOCK, window, None, 0.0)
    out = _t(_bshd(jout, h))
    lse = _t(np.asarray(jlse)[..., 0])
    tq, tk, tv, tdo = (_t(x) for x in (q, k, v, do))
    delta = (tdo * out).sum(-1).permute(0, 2, 1).reshape(B * h, sq) \
        .contiguous()
    dq = tfa.flash_bwd_dq_ref(tq, tk, tv, tdo, lse, delta, causal=causal,
                              window=window)
    dk, dv = tfa.flash_bwd_dkv_ref(tq, tk, tv, tdo, lse, delta,
                                   causal=causal, window=window)
    _close_normalized(dq.numpy(), _bshd(jdq, h), name="dq")
    _close_normalized(dk.numpy(), _bshd(jdk, h_kv), name="dk")
    _close_normalized(dv.numpy(), _bshd(jdv, h_kv), name="dv")
    # the public entries take the CPU route to the same plain versions
    torch.testing.assert_close(
        tfa.flash_bwd_dq(tq, tk, tv, tdo, lse, delta, causal=causal,
                         window=window), dq, rtol=0, atol=0)


# end to end on every other case: non-causal, window, GQA with window,
# sq < sk with GQA and window
@pytest.mark.parametrize("case", CASES[::2], ids=IDS[::2])
def test_autograd_matches_jax_grad(case):
    """Forward output and all three gradients of the autograd Function
    against ``jax.grad`` through the Pallas kernels (the registered
    ``flash_attention_kernel`` without a window, ``_flash_bhsd`` with
    one)."""
    causal, window, h, h_kv, sq, sk = case
    q, k, v, w = _inputs(2, h, h_kv, sq, sk)
    scale = 1.0 / math.sqrt(D)

    def jax_attn(q_, k_, v_):
        if window:
            out = fa._flash_bhsd(*(a.transpose(0, 2, 1, 3).reshape(
                -1, a.shape[1], D) for a in (q_, k_, v_)), True, scale,
                True, BLOCK, BLOCK, window)
            return out.reshape(B, h, sq, D).transpose(0, 2, 1, 3)
        return fa.flash_attention_kernel(q_, k_, v_, causal=causal,
                                         interpret=True)

    jout = jax_attn(q, k, v)
    jgrads = jax.grad(lambda *a: (jax_attn(*a) * w).sum(),
                      argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=2e-5, rtol=0)
    (out * _t(w)).sum().backward()
    for name, got, want in zip("qkv", (tq, tk, tv), jgrads):
        _close_normalized(got.grad.numpy(), np.asarray(want), name=name)


def test_upstream_gradient_with_broadcast_strides():
    """``out.sum().backward()`` hands the backward an expanded (all
    strides 0) gradient; the Function copies it before the kernels'
    layout checks."""
    q, k, v, _ = _inputs(3, 4, 2, 32, 32)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    tfa.flash_attention(tq, tk, tv, causal=True).sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in (tq, tk, tv))


def test_rows_without_keys_output_zero():
    """sq > sk, causal: the first sq - sk rows see no key; O is exactly 0,
    lse is NEG_INF, and their gradients vanish."""
    q, k, v, do = _inputs(4, 2, 2, 24, 16)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=True)
    assert (out[:, :8] == 0).all() and (out[:, 8:] != 0).any()
    _, lse = tfa.flash_fwd_ref(tq.detach(), tk.detach(), tv.detach(),
                               causal=True)
    assert (lse.reshape(B, 2, 24)[..., :8] <= 0.5 * tfa.NEG_INF).all()
    (out * _t(do)).sum().backward()
    assert (tq.grad[:, :8] == 0).all()


@pytest.mark.parametrize("fault", [
    "head_dim", "big_head_dim", "groups", "strided_last", "window_no_causal",
    "dtype", "mixed_dtype", "shape"])
def test_wrapper_rejects(fault):
    q, k, v, _ = (_t(x) for x in _inputs(5, 4, 2, 16, 16))
    kw = dict(causal=True)
    if fault == "head_dim":
        q, k, v = q[..., :12], k[..., :12], v[..., :12]
    elif fault == "big_head_dim":
        q, k, v = (t.repeat(1, 1, 1, 17) for t in (q, k, v))
    elif fault == "groups":
        q = q[:, :, :3]
    elif fault == "strided_last":
        q = torch.zeros(B, 16, 4, 32)[..., ::2]
    elif fault == "window_no_causal":
        kw = dict(causal=False, window=4)
    elif fault == "dtype":
        q, k, v = (t.double() for t in (q, k, v))
    elif fault == "mixed_dtype":
        k = k.to(torch.bfloat16)
    else:
        v = v[:, :8]
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k, v, **kw)


def test_mask_and_dropout_name_the_encoder_slice():
    """The key mask and dropout came with the encoder slice and run; what
    it left out, a row-varying mask, now runs the tile mode (the same
    function as ``flash_attention(tmask=...)``), and a mask that does not
    broadcast to ``[b, h, sq, sk]`` raises."""
    q, k, v, _ = (_t(x) for x in _inputs(6, 4, 4, 16, 16))
    zero_rows = tfa.flash_attention(q, k, v, causal=False,
                                    kmask=torch.zeros(B * 4, 1, 16))
    torch.testing.assert_close(zero_rows, tfa.flash_attention(
        q, k, v, causal=False), rtol=0, atol=0)
    dropped = tfa.flash_attention(q, k, v, causal=False, dropout=0.1,
                                  seed=(1, 2))
    assert torch.isfinite(dropped).all()
    with pytest.raises(ValueError, match="seed"):
        tfa.flash_attention(q, k, v, causal=False, dropout=0.1)
    rows = torch.ones(B, 1, 16, 16)
    torch.testing.assert_close(
        TF.scaled_dot_product_attention(q, k, v, attn_mask=rows),
        tfa.flash_attention(q, k, v, causal=False, tmask=rows), rtol=0,
        atol=0)
    with pytest.raises(ValueError, match="broadcast"):
        TF.scaled_dot_product_attention(q, k, v,
                                        attn_mask=torch.ones(B, 2, 16, 16))
    # dropout outside training is no dropout (the reference's p = 0)
    torch.testing.assert_close(
        TF.scaled_dot_product_attention(q, k, v, dropout_p=0.1,
                                        training=False),
        tfa.flash_attention(q, k, v, causal=False), rtol=0, atol=0)


VARIANTS = [
    # (causal, window, h, h_kv, sq, sk, kmask, dropout)
    (False, 0, 4, 4, 64, 64, True, 0.0),
    (False, 0, 4, 4, 64, 64, True, 0.1),
    (True, 24, 4, 2, 64, 64, False, 0.1),
    (True, 0, 4, 2, 32, 64, True, 0.1),
]
VARIANT_IDS = [f"causal{int(c)}-w{w}-h{h}kv{hk}-sq{sq}sk{sk}-km{int(m)}"
               f"-p{p}" for c, w, h, hk, sq, sk, m, p in VARIANTS]
SEED = (-5, 2 ** 31 - 7)


def _kmask_rows(h, sk, use):
    """Additive key rows ``[b * h, 1, sk]``, different per query head:
    small random values and a padded tail of -1e4 that grows with the
    head."""
    if not use:
        return None
    rng = np.random.RandomState(9)
    km = rng.randn(B * h, 1, sk).astype(np.float32)
    for i in range(B * h):
        km[i, 0, sk - 4 * (i % 4) - 4:] = -1e4
    return km


def _jax_variant_fwd(q, k, v, km, causal, window, p):
    return fa._flash_fwd(_bh(q), _bh(k), _bh(v), causal, 1.0 / math.sqrt(D),
                         True, BLOCK, BLOCK, window,
                         seed=jnp.asarray(SEED, jnp.int32) if p else None,
                         dropout=p,
                         kmask=None if km is None else jnp.asarray(km))


@pytest.mark.parametrize("case", VARIANTS, ids=VARIANT_IDS)
def test_variant_fwd_plain_matches_pallas(case):
    causal, window, h, h_kv, sq, sk, use_km, p = case
    q, k, v, _ = _inputs(10, h, h_kv, sq, sk)
    km = _kmask_rows(h, sk, use_km)
    jout, jlse = _jax_variant_fwd(q, k, v, km, causal, window, p)
    out, lse = tfa.flash_fwd_ref(
        _t(q), _t(k), _t(v), causal=causal, window=window,
        kmask=None if km is None else _t(km), seed=SEED if p else None,
        dropout=p)
    np.testing.assert_allclose(out.numpy(), _bshd(jout, h), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("case", VARIANTS, ids=VARIANT_IDS)
def test_variant_bwd_plain_matches_pallas(case):
    causal, window, h, h_kv, sq, sk, use_km, p = case
    q, k, v, do = _inputs(11, h, h_kv, sq, sk)
    km = _kmask_rows(h, sk, use_km)
    jout, jlse = _jax_variant_fwd(q, k, v, km, causal, window, p)
    jdq, jdk, jdv, jdm = fa._flash_bwd_impl(
        _bh(q), _bh(k), _bh(v), jout, jlse, _bh(do), causal,
        1.0 / math.sqrt(D), True, BLOCK, BLOCK, window,
        jnp.asarray(SEED, jnp.int32) if p else None, p,
        kmask=None if km is None else jnp.asarray(km))
    out = _t(_bshd(jout, h))
    lse = _t(np.asarray(jlse)[..., 0])
    tq, tk, tv, tdo = (_t(x) for x in (q, k, v, do))
    delta = (tdo * out).sum(-1).permute(0, 2, 1).reshape(B * h, sq) \
        .contiguous()
    kw = dict(causal=causal, window=window,
              kmask=None if km is None else _t(km),
              seed=SEED if p else None, dropout=p)
    dq = tfa.flash_bwd_dq_ref(tq, tk, tv, tdo, lse, delta, **kw)
    dk, dv, *dm = tfa.flash_bwd_dkv_ref(tq, tk, tv, tdo, lse, delta, **kw)
    _close_normalized(dq.numpy(), _bshd(jdq, h), name="dq")
    _close_normalized(dk.numpy(), _bshd(jdk, h_kv), name="dk")
    _close_normalized(dv.numpy(), _bshd(jdv, h_kv), name="dv")
    if use_km:
        assert dm[0].shape == (B * h, 1, sk)
        _close_normalized(dm[0].numpy(), np.asarray(jdm), name="dmask")
    else:
        assert not dm and jdm is None
    torch.testing.assert_close(
        tfa.flash_bwd_dkv(tq, tk, tv, tdo, lse, delta, **kw)[0], dk,
        rtol=0, atol=0)


def test_variant_autograd_matches_jax_grad():
    """Kernel 1-3's autograd Function with a per-head key mask and
    dropout against ``jax.grad`` of ``_flash_call``: O and the gradients
    of q, k, v and kmask."""
    causal, window, h, h_kv, sq, sk, _, p = VARIANTS[3]
    q, k, v, w = _inputs(12, h, h_kv, sq, sk)
    km = _kmask_rows(h, sk, True)
    scale = 1.0 / math.sqrt(D)
    seed = jnp.asarray(SEED, jnp.int32)

    def jax_attn(q_, k_, v_, km_):
        out = fa._flash_call(_bh(q_), _bh(k_), _bh(v_), seed, km_, causal,
                             scale, True, BLOCK, BLOCK, window, p)
        return out.reshape(B, h, sq, D).transpose(0, 2, 1, 3)

    jout = jax_attn(q, k, v, km)
    jgrads = jax.grad(lambda *a: (jax_attn(*a) * w).sum(),
                      argnums=(0, 1, 2, 3))(q, k, v, km)
    tq, tk, tv, tkm = (_t(x).requires_grad_() for x in (q, k, v, km))
    out = tfa.flash_attention(tq, tk, tv, causal=causal, window=window,
                              kmask=tkm, dropout=p, seed=SEED)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=2e-5, rtol=0)
    (out * _t(w)).sum().backward()
    for name, got, want in zip(("q", "k", "v", "kmask"), (tq, tk, tv, tkm),
                               jgrads):
        _close_normalized(got.grad.numpy(), np.asarray(want), name=name)


def test_functional_entries_route_through_the_function():
    """``scaled_dot_product_attention`` and ``sliding_window_attention``
    give the Function's results (and count no CUDA launch on the CPU)."""
    q, k, v, _ = (_t(x) for x in _inputs(7, 4, 2, 32, 32))
    n = tfa.flash_fwd.launches
    got = TF.scaled_dot_product_attention(q, k, v, is_causal=True)
    torch.testing.assert_close(got, tfa.flash_attention(q, k, v,
                                                        causal=True))
    got = TF.sliding_window_attention(q, k, v, 8)
    torch.testing.assert_close(got, tfa.flash_attention(q, k, v,
                                                        causal=True,
                                                        window=8))
    assert tfa.flash_fwd.launches == n
    with pytest.raises(ValueError):
        TF.sliding_window_attention(q, k, v, 0)


# kernel 2 computing delta itself (the Llama path's backward on the card):
# its plain version (dQ, delta) against _flash_bwd_impl's dQ and the
# reference's delta (flash_attention.py:484-486, the same expression on
# the same O and dO), on CASES plus ragged lengths that no 16-row block
# divides (Pallas at 8-row blocks): dQ as test_bwd_plain_matches_pallas
# holds it, delta within 1e-5 (fp32 sums of 16 fp32 products, summed in
# another order)
FUSED_CASES = [c + (BLOCK,) for c in CASES] + [
    # (causal, window, h, h_kv, sq, sk, block)
    (True, 0, 4, 2, 40, 40, 8),
    (True, 12, 4, 4, 24, 56, 8),
]
FUSED_IDS = [f"causal{int(c)}-w{w}-h{h}kv{hk}-sq{sq}sk{sk}"
             for c, w, h, hk, sq, sk, _ in FUSED_CASES]


@pytest.mark.parametrize("case", FUSED_CASES, ids=FUSED_IDS)
def test_fused_dq_delta_plain_matches_pallas(case):
    causal, window, h, h_kv, sq, sk, block = case
    q, k, v, do = _inputs(13, h, h_kv, sq, sk)
    scale = 1.0 / math.sqrt(D)
    jout, jlse = fa._flash_fwd(_bh(q), _bh(k), _bh(v), causal, scale, True,
                               block, block, window)
    jdq, _, _, _ = fa._flash_bwd_impl(
        _bh(q), _bh(k), _bh(v), jout, jlse, _bh(do), causal, scale, True,
        block, block, window, None, 0.0)
    jdelta = jnp.sum(_bh(do).astype(jout.dtype).astype(jnp.float32)
                     * jout.astype(jnp.float32), axis=-1)
    tq, tk, tv, tdo = (_t(x) for x in (q, k, v, do))
    out = _t(_bshd(jout, h))
    lse = _t(np.asarray(jlse)[..., 0])
    dq, delta = tfa.flash_bwd_dq_delta(tq, tk, tv, tdo, out, lse,
                                       causal=causal, window=window)
    assert dq.shape == q.shape and delta.shape == (B * h, sq)
    _close_normalized(dq.numpy(), _bshd(jdq, h), name="dq")
    np.testing.assert_allclose(delta.numpy(), np.asarray(jdelta), atol=1e-5,
                               rtol=0)
    # the plain form is kernel 2's plain version beside _delta
    want = tfa.flash_bwd_dq_delta_ref(tq, tk, tv, tdo, out, lse,
                                      causal=causal, window=window)
    torch.testing.assert_close(dq, want[0], rtol=0, atol=0)
    torch.testing.assert_close(delta, tfa._delta(tdo, out), rtol=0, atol=0)


def test_backward_routes_delta_by_device_and_variant():
    """On the CPU the Function's backward keeps delta as torch ops and
    kernel 2 as given (its results equal the fused entry's plain form);
    on CUDA it fuses delta into kernel 2 for bfloat16 with d <= 128 and
    no key row or dropout."""
    args = dict(kmask=None, dropout=0.0)
    assert not tfa._fused_delta(torch.zeros(1, 8, 2, 128,
                                            dtype=torch.bfloat16), args)

    def on_card(dtype, d):  # what the routing reads of a CUDA tensor
        return types.SimpleNamespace(is_cuda=True, dtype=dtype,
                                     shape=(1, 8, 2, d))

    assert tfa._fused_delta(on_card(torch.bfloat16, 128), args)
    assert tfa._fused_delta(on_card(torch.bfloat16, 72), args)
    assert not tfa._fused_delta(on_card(torch.bfloat16, 128),
                                dict(args, dropout=0.1))
    assert not tfa._fused_delta(on_card(torch.bfloat16, 128),
                                dict(args, kmask=torch.zeros(2, 1, 8)))
    assert not tfa._fused_delta(on_card(torch.float32, 128), args)
    assert not tfa._fused_delta(on_card(torch.bfloat16, 256), args)


# -- the wgmma backward kernels' tilings --------------------------------------
# A plain model of csrc/flash_attention.cu's schedules for kernels 2 and 3
# (bf16, d <= 128): key_tiles / query_tiles (the tiles of the band one
# block visits), grouped_block (block t: group t / (16 x tiles), inside it
# head t % 16's tile (t / 16) % tiles, so groups of 16 heads run one after
# another and inside a group every head's first tile starts, then every
# head's second, ...; blocks past the last head exit) and the block orders
# of flash_bwd_dq_wgmma (a block per 128 query rows of a query head, the
# last rows first, 64-key tiles from the last to the first) and
# flash_bwd_dkv_wgmma (a block per 128 keys of a kv head, the first keys
# first, 64-row query tiles of each query head of its group). Every
# visible (row, key) pair of every query head must be visited exactly
# once, and inside each group the blocks must run heaviest first.

GROUP_SLICES = 16  # csrc/flash_attention.cu's kGroupSlices


def _grouped_blocks(slices, tiles):
    """(slice, tile, group) of grouped_block's live blocks in start
    order."""
    for z in range(-(-slices // GROUP_SLICES)):
        for y in range(tiles):
            for x in range(GROUP_SLICES):
                if z * GROUP_SLICES + x < slices:
                    yield z * GROUP_SLICES + x, y, z


def _key_tiles(sq, sk, causal, window, r0, bq, bk):
    kt0, kt1 = 0, -(-sk // bk)
    if not causal:
        return kt0, kt1
    offset = sk - sq
    cmax = min(sk - 1, min(r0 + bq, sq) - 1 + offset)
    kt1 = 0 if cmax < 0 else cmax // bk + 1
    if window > 0:
        cmin = r0 + offset - window + 1
        if cmin > 0:
            kt0 = cmin // bk
    return kt0, kt1


def _query_tiles(sq, sk, causal, window, c0, bq, bk):
    qt0, qt1 = 0, -(-sq // bq)
    if not causal:
        return qt0, qt1
    offset = sk - sq
    qt0 = max(0, c0 - offset) // bq
    if window > 0:
        rmax = min(sq - 1, min(c0 + bk, sk) - 1 - offset + window - 1)
        qt1 = 0 if rmax < 0 else rmax // bq + 1
    return qt0, qt1


def _dq_schedule(b, h, sq, sk, causal, window, bq=128, bk=64):
    """[(query head, r0, key tiles in visiting order, head group)] in
    launch order."""
    nqt = -(-sq // bq)
    out = []
    for bh, qi, grp in _grouped_blocks(b * h, nqt):
        r0 = (nqt - 1 - qi) * bq
        kt0, kt1 = _key_tiles(sq, sk, causal, window, r0, bq, bk)
        out.append((bh, r0, list(range(kt1 - 1, kt0 - 1, -1)), grp))
    return out


def _dkv_schedule(b, h, h_kv, sq, sk, causal, window, bk=128, bq=64):
    """[(kv head, c0, [(query head, query tile)...], head group)] in
    launch order."""
    group = h // h_kv
    out = []
    for bhk, kt, grp in _grouped_blocks(b * h_kv, -(-sk // bk)):
        c0 = kt * bk
        qt0, qt1 = _query_tiles(sq, sk, causal, window, c0, bq, bk)
        bi, hk = divmod(bhk, h_kv)
        items = [(bi * h + hk * group + gi, qt) for gi in range(group)
                 for qt in range(qt0, qt1)]
        out.append((bhk, c0, items, grp))
    return out


def _heaviest_first(work):
    """Whether the work of the blocks ([(head group, work)] in launch
    order) never increases inside a head group."""
    return all(w0 >= w1 for (g0, w0), (g1, w1) in zip(work, work[1:])
               if g0 == g1)


def _visible_np(sq, sk, causal, window):
    rows = np.arange(sq)[:, None] + (sk - sq)
    cols = np.arange(sk)[None, :]
    if not causal:
        return np.ones((sq, sk), bool)
    vis = cols <= rows
    if window > 0:
        vis &= cols > rows - window
    return vis


TILING_CASES = [c[:6] for c in FUSED_CASES] + [
    # (causal, window, h, h_kv, sq, sk) at the kernels' own tile sizes:
    # the Llama shape's band, a window, GQA, sq < sk, ragged 1000, rows
    # that see no key (sq > sk), a window wider than a tile and one row
    (True, 0, 2, 2, 1024, 1024),
    (False, 0, 2, 2, 1024, 1024),
    (True, 256, 2, 2, 1024, 1024),
    (True, 0, 12, 4, 1024, 1024),
    (True, 0, 2, 2, 512, 1024),
    (True, 0, 4, 2, 1000, 1000),
    (True, 100, 4, 2, 1000, 1000),
    (True, 0, 2, 2, 300, 100),
    (True, 200, 2, 1, 130, 700),
    (True, 0, 2, 1, 1, 5),
]
TILING_IDS = [f"causal{int(c)}-w{w}-h{h}kv{hk}-sq{sq}sk{sk}"
              for c, w, h, hk, sq, sk in TILING_CASES]


@pytest.mark.parametrize("case", TILING_CASES, ids=TILING_IDS)
def test_wgmma_backward_tilings_cover_the_band_once(case):
    causal, window, h, h_kv, sq, sk = case
    b = 3  # with h 12, 36 heads: three groups, the last of 4
    vis = _visible_np(sq, sk, causal, window)
    # kernel 2: every (query head, 128-row tile) once; its key tiles cover
    # each visible pair of its rows exactly once
    dq = _dq_schedule(b, h, sq, sk, causal, window)
    assert sorted((bh, r0) for bh, r0, _, _ in dq) == sorted(
        (bh, r0) for bh in range(b * h) for r0 in range(0, sq, 128))
    seen = np.zeros((b * h, sq, sk), np.int8)
    for bh, r0, tiles, _ in dq:
        assert len(set(tiles)) == len(tiles)
        for kt in tiles:
            seen[bh, r0:r0 + 128, kt * 64:kt * 64 + 64] += 1
    assert (seen[:, vis] == 1).all()
    # heaviest first: the key tiles a block visits never increase along
    # the launch order inside a head group (a ragged last tile of a few
    # rows may see fewer)
    assert _heaviest_first([(grp, len(tiles)) for _, r0, tiles, grp in dq
                            if r0 + 128 <= sq])
    # kernel 3: every (kv head, 128-key tile) once; its items cover each
    # visible pair of its keys, for every query head of the group, once
    dkv = _dkv_schedule(b, h, h_kv, sq, sk, causal, window)
    assert sorted((bhk, c0) for bhk, c0, _, _ in dkv) == sorted(
        (bhk, c0) for bhk in range(b * h_kv) for c0 in range(0, sk, 128))
    seen[:] = 0
    for bhk, c0, items, _ in dkv:
        bi, hk = divmod(bhk, h_kv)
        group = h // h_kv
        assert {bh for bh, _ in items} <= set(
            range(bi * h + hk * group, bi * h + (hk + 1) * group))
        for bh, qt in items:
            seen[bh, qt * 64:qt * 64 + 64, c0:c0 + 128] += 1
    assert (seen[:, vis] == 1).all()
    # with a window the band's key tiles carry about equal work, and
    # those no row sees (sq < sk) exit at once: the order matters without
    assert window or _heaviest_first([(grp, len(items))
                                      for _, c0, items, grp in dkv
                                      if c0 + 128 <= sk])


# -- the tile mode --------------------------------------------------------------

TILE_CASES = [
    # (mask shape over [b, h, sq, sk] by numpy's rule, causal, h, h_kv,
    #  sq, sk[, structured mask]); the structured masks span whole 64 x 64
    #  cells, which the wgmma backward skips (DEAD) or stages (MIXED)
    ((32, 32), False, 4, 4, 32, 32),
    ((B, 1, 32, 32), False, 4, 2, 32, 32),
    ((B, 4, 32, 64), False, 4, 4, 32, 64),
    ((B, 4, 32, 64), True, 4, 2, 32, 64),
    ((1, 32, 1), False, 4, 4, 32, 48),
    ((B, 1, 1, 48), True, 4, 4, 48, 48),
    ((48,), False, 4, 1, 16, 48),
    ((128, 128), False, 4, 4, 128, 128, "causal"),
    ((1, 4, 128, 192), False, 4, 2, 128, 192, "blocks"),
    ((1, 4, 130, 200), True, 4, 4, 130, 200, "blocks"),
    ((B, 1, 128, 160), False, 4, 2, 128, 160, "causal_pad"),
]
TILE_IDS = [f"{'x'.join(map(str, m))}-causal{int(c)}-h{h}kv{hk}-sq{sq}sk{sk}"
            + "".join(f"-{k}" for k in kind)
            for m, c, h, hk, sq, sk, *kind in TILE_CASES]


def _tile_mask_np(seed, shape):
    """N(0, 1) with ~30 % at the reference's -1e30 and, where the mask
    has query rows, every key of row 3 too: a fully masked row."""
    rng = np.random.RandomState(seed)
    m = rng.randn(*shape).astype(np.float32)
    m = np.where(rng.rand(*shape) < 0.3, -1e30, m).astype(np.float32)
    if len(shape) >= 2 and shape[-2] > 3:
        m[..., 3, :] = -1e30
    return m


def _structured_np(kind, shape, seed=45):
    """Masks made of whole 64 x 64 cells, ``shape`` ending in (sq, sk):
    "causal" the decoder's causal triangle (-1e30 above the diagonal, 0
    elsewhere); "causal_pad" that triangle with a seeded key padding per
    batch row (each row keeps key 0); "blocks" N(0, 1) with whole dead
    cells (every third by cell index), a -1e4 cell (MIXED: never dead), a
    zero cell, and query row 70 fully masked inside otherwise live
    cells."""
    rng = np.random.RandomState(seed)
    sq, sk = shape[-2:]
    tri = np.triu(np.full((sq, sk), -1e30, np.float32), 1)
    if kind == "causal":
        return np.broadcast_to(tri, shape).copy()
    if kind == "causal_pad":
        lens = rng.randint(1, sk + 1, shape[0])
        pad = (np.arange(sk)[None] >= lens[:, None])[:, None, None]
        return np.where(pad, np.float32(-1e30), tri).astype(np.float32)
    m = rng.randn(*shape).astype(np.float32)
    for rt in range(-(-sq // 64)):
        for ct in range(-(-sk // 64)):
            if (rt + ct) % 3 == 0:
                m[..., 64 * rt:64 * rt + 64, 64 * ct:64 * ct + 64] = -1e30
    m[..., 64:128, 64:128] = -1e4
    m[..., :64, 128:192] = 0.0
    m[..., 70, :] = -1e30
    return m


@pytest.mark.parametrize("case", TILE_CASES, ids=TILE_IDS)
def test_tile_mode_plain_matches_the_reference_composite(case):
    """The tile mode's plain versions (through ``flash_attention(tmask=)``
    and ``F.scaled_dot_product_attention``) against the reference's
    composite ``_sdpa_reference`` under ``jax.vjp``: O, dQ, dK, dV and the
    mask's gradient within 1e-5 of each's largest magnitude, a fully
    masked row included (uniform over the keys, as the reference's
    softmax of equal -1e30 scores)."""
    from paddle_tpu.nn.functional.attention import _sdpa_reference

    shape, causal, h, h_kv, sq, sk, *kind = case
    q, k, v, do = _inputs(41, h, h_kv, sq, sk)
    mask = _structured_np(kind[0], shape) if kind \
        else _tile_mask_np(42, shape)
    out, vjp = jax.vjp(lambda q, k, v, m: _sdpa_reference(
        q, k, v, m, causal=causal), q, k, v, mask)
    grads = vjp(do)
    ts = [_t(a).requires_grad_() for a in (q, k, v, mask)]
    got = TF.scaled_dot_product_attention(*ts[:3], attn_mask=ts[3],
                                          is_causal=causal)
    got.backward(_t(do))
    for name, g, w in (("O", got, out), *zip(("dq", "dk", "dv", "dmask"),
                                             (t.grad for t in ts), grads)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1.0),
                                   err_msg=name)


def test_tile_mode_kernel_entries_take_the_mask_through_strides():
    """The kernel entries' plain versions on a broadcast ``[1, 1, sq,
    sk]`` tile equal those on its materialised ``[b, h, sq, sk]`` copy,
    and dK/dV's per-element dmask summed over batch and heads is the
    autograd gradient of the broadcast mask; a mask that does not
    broadcast, a window or a key row beside it raise."""
    h = h_kv = 4
    q, k, v, do = (_t(a) for a in _inputs(43, h, h_kv, 32, 32))
    small = _t(_tile_mask_np(44, (1, 1, 32, 32)))
    big = small.expand(B, h, 32, 32).contiguous()
    o1, lse1 = tfa.flash_fwd(q, k, v, causal=False, tmask=small)
    o2, lse2 = tfa.flash_fwd(q, k, v, causal=False, tmask=big)
    torch.testing.assert_close(o1, o2, rtol=0, atol=0)
    delta = tfa._delta(do, o1)
    dk, dv, dm = tfa.flash_bwd_dkv(q, k, v, do, lse1, delta, causal=False,
                                   tmask=small, tmask_grad=True)
    assert dm.shape == (B * h, 32, 32)
    leaf = small.clone().requires_grad_()
    tfa.flash_attention(q, k, v, causal=False, tmask=leaf).backward(do)
    torch.testing.assert_close(dm.reshape(B, h, 32, 32).sum((0, 1),
                                                            keepdim=True),
                               leaf.grad, rtol=1e-5, atol=1e-6)
    for bad in (dict(tmask=small[..., :16]),
                dict(tmask=torch.zeros(B, 3, 32, 32)),
                dict(tmask=small, window=4, causal=True),
                dict(tmask=small, kmask=torch.zeros(B * h, 1, 32))):
        kw = {"causal": False, **bad}
        with pytest.raises(ValueError):
            tfa.flash_fwd(q, k, v, **kw)


# -- the tile mode's class table and the wgmma backward's skip rule -----------

def _classes_np(mask, sq, sk):
    """The class of each 64 x 64 cell of ``mask`` (4-D, broadcasting to
    ``[mb, mh, sq, sk]``) by a direct loop: DEAD where every in-range
    value is at or below -0.5e30, ZERO where every one is 0, else MIXED."""
    m = np.broadcast_to(mask, mask.shape[:2] + (sq, sk))
    out = np.zeros(mask.shape[:2] + (-(-sq // 64), -(-sk // 64)), np.uint8)
    for rt in range(out.shape[2]):
        for ct in range(out.shape[3]):
            cell = m[:, :, 64 * rt:64 * rt + 64, 64 * ct:64 * ct + 64]
            dead = (cell <= -0.5e30).all((2, 3))
            zero = (cell == 0).all((2, 3))
            out[:, :, rt, ct] = np.where(dead, tfa.TILE_DEAD, np.where(
                zero, tfa.TILE_ZERO, tfa.TILE_MIXED))
    return out


CLASS_CASES = [
    # (mask shape, sq, sk, kind)
    ((1, 1, 256, 256), 256, 256, "causal"),
    ((1, 1, 130, 70), 130, 70, "causal"),
    ((B, 1, 200, 130), 200, 130, "causal_pad"),
    ((1, 4, 130, 200), 130, 200, "blocks"),
    ((B, 4, 1, 100), 70, 100, "random"),
    ((1, 1, 100, 70), 100, 70, "random"),
    ((B, 1, 64, 128), 64, 128, "zeros"),
    ((1, 2, 128, 128), 128, 128, "minus1e4"),
]


def _class_mask(kind, shape):
    if kind in ("causal", "causal_pad", "blocks"):
        return _structured_np(kind, shape)
    if kind == "random":
        return _tile_mask_np(46, shape)
    m = np.zeros(shape, np.float32)
    if kind == "minus1e4":
        m[..., :64, 64:] = -1e4
        m[..., 64:, :64] = -1e30
    return m


@pytest.mark.parametrize("case", CLASS_CASES,
                         ids=[f"{c[3]}-{'x'.join(map(str, c[0]))}"
                              for c in CLASS_CASES])
def test_tile_classes_plain_matches_numpy(case):
    """``tile_classes_ref`` (and the wrapper on the CPU) against a direct
    numpy classification: broadcast batch, head and query dims, ragged
    sq and sk (a cell past them counts by its in-range part), -1e4 cells
    MIXED and never DEAD, an all-zero mask ZERO; an expanded view of a
    broadcast dim classes its one slice."""
    shape, sq, sk, kind = case
    m = _class_mask(kind, shape)
    want = _classes_np(m, sq, sk)
    got = tfa.tile_classes(_t(m), sq, sk)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if shape[0] == 1:
        wide = _t(m).expand(B, *shape[1:])
        np.testing.assert_array_equal(
            tfa.tile_classes_ref(wide, sq, sk).numpy(), want)
    if kind == "zeros":
        assert (want == tfa.TILE_ZERO).all()
    if kind == "minus1e4":
        assert (want[..., 0, 1] == tfa.TILE_MIXED).all()
        assert (want[..., 1, 0] == tfa.TILE_DEAD).all()


def test_tile_classes_of_a_bool_mask_through_sdpa():
    """A bool (keep) mask reaches the tile mode as the reference's clamp
    (0 kept, -1e30 dropped): its hidden cells are DEAD, its kept ones
    ZERO, and the diagonal's MIXED."""
    from paddle_tpu_torch.nn.functional import attention as tattn

    keep = torch.from_numpy(np.tril(np.ones((130, 130), bool)))
    q = torch.zeros(1, 130, 2, D)
    _, tile = tattn._mask_operand(keep, q.shape, q.shape)
    got = tfa.tile_classes(tile, 130, 130)[0, 0]
    want = np.full((3, 3), tfa.TILE_MIXED, np.uint8)
    want[np.triu_indices(3, 1)] = tfa.TILE_DEAD
    want[np.tril_indices(3, -1)] = tfa.TILE_ZERO
    np.testing.assert_array_equal(got.numpy(), want)


def _full_rows(lse, b, h, sq, sk, causal):
    """[b, h, sq]: the rows the kernels treat as fully masked (lse at or
    below -0.5e30 and the row sees a key)."""
    sees = tfa._sees(torch.zeros(1, sq, 1, 1), torch.zeros(1, sk, 1, 1),
                     causal)
    return (lse.reshape(b, h, sq) <= 0.5 * tfa.NEG_INF) & sees


def _dq_visits(cls, full, sq, sk, causal):
    """[b, h, sq, sk]: the pairs flash_bwd_dq_wgmma visits in the tile
    mode. A block of 128 rows takes the key tiles of its causal band
    (_key_tiles); each 64-row half (a warpgroup, one cell row) visits a
    tile whose cell is not DEAD, or every tile if it holds a fully masked
    row."""
    b, h = full.shape[:2]
    vis = torch.zeros(b, h, sq, sk, dtype=torch.bool)
    for r0 in range(0, sq, 128):
        kt0, kt1 = _key_tiles(sq, sk, causal, 0, r0, 128, 64)
        for rs in range(r0, min(r0 + 128, sq), 64):
            fw = full[:, :, rs:rs + 64].any(-1)
            for kt in range(kt0, kt1):
                go = (cls[:, :, rs // 64, kt] != tfa.TILE_DEAD) | fw
                vis[:, :, rs:rs + 64, 64 * kt:64 * kt + 64] |= \
                    go[..., None, None]
    return vis


def _dkv_visits(cls, full, sq, sk, causal):
    """[b, h, sq, sk]: the pairs flash_bwd_dkv_wgmma visits in the tile
    mode. A block of 128 keys takes every 64-row query tile of each head;
    each 64-key half (a warpgroup, one cell column) visits a tile that
    holds a fully masked row, else one whose cell is not DEAD and that
    lies in the causal band of its keys (a row of it sees one)."""
    b, h = full.shape[:2]
    vis = torch.zeros(b, h, sq, sk, dtype=torch.bool)
    for cs in range(0, sk, 64):
        band = max(0, cs - (sk - sq)) // 64 if causal else 0
        for qt in range(-(-sq // 64)):
            ft = full[:, :, 64 * qt:64 * qt + 64].any(-1)
            go = ft | ((cls[:, :, qt, cs // 64] != tfa.TILE_DEAD)
                       & (qt >= band))
            vis[:, :, 64 * qt:64 * qt + 64, cs:cs + 64] |= go[..., None, None]
    return vis


SKIP_CASES = [
    # (mask shape, kind, causal, h, h_kv, sq, sk, dropout)
    ((1, 1, 192, 192), "causal", False, 4, 2, 192, 192, 0.1),
    ((1, 4, 200, 260), "blocks", True, 4, 4, 200, 260, 0.0),
    ((1, 4, 260, 200), "blocks", True, 4, 2, 260, 200, 0.1),
    ((B, 1, 130, 190), "causal_pad", False, 4, 4, 130, 190, 0.0),
    ((B, 4, 130, 130), "random", True, 4, 4, 130, 130, 0.1),
]


@pytest.mark.parametrize("case", SKIP_CASES,
                         ids=[f"{c[1]}-causal{int(c[2])}-sq{c[5]}sk{c[6]}"
                              f"-p{c[7]}" for c in SKIP_CASES])
def test_tile_skip_rule_is_exact(case):
    """A plain model of the wgmma backward's skip rule in the tile mode:
    dQ, dK, dV and the per-element dmask summed only over the 64 x 64
    cells the kernels visit (_dq_visits, _dkv_visits, from the class
    table and the rows' lse) equal the plain versions, which visit every
    pair, within 1e-6 of each's largest magnitude: a skipped cell's
    contribution is exactly 0, also with fully masked rows (the "blocks"
    masks' row 70, "random"'s row 3) and with the causal flag beside the
    mask, and the rule does skip."""
    shape, kind, causal, h, h_kv, sq, sk, p = case
    q, k, v, do = (_t(a) for a in _inputs(47, h, h_kv, sq, sk))
    mask = _t(_class_mask(kind, shape))
    kw = dict(causal=causal, tmask=mask, seed=SEED if p else None,
              dropout=p)
    out, lse = tfa.flash_fwd_ref(q, k, v, **kw)
    delta = tfa._delta(do, out)
    scale = 1.0 / math.sqrt(D)
    pd, ds = tfa._probs_and_ds(q, k, v, do, lse, delta, scale, causal, 0,
                               None, tfa._dropout_words(p, kw["seed"],
                                                        None, h), mask)
    cls = tfa.tile_classes_ref(mask, sq, sk).expand(B, h, -1, -1)
    full = _full_rows(lse, B, h, sq, sk, causal)
    assert full.any() == (kind in ("blocks", "random"))
    grouped = (B, h_kv, h // h_kv, sq, sk)
    vq = _dq_visits(cls, full, sq, sk, causal).reshape(grouped)
    vkv = _dkv_visits(cls, full, sq, sk, causal).reshape(grouped)
    assert not vq.all() and not vkv.all()
    zero = torch.zeros(())
    dq = torch.einsum("bkgqc,bckd->bqkgd", torch.where(vq, ds, zero),
                      k).reshape(B, sq, h, D)
    dk = torch.einsum("bkgqc,bqkgd->bckd", torch.where(vkv, ds, zero),
                      tfa._grouped(q, h_kv))
    dv = torch.einsum("bkgqc,bqkgd->bckd", torch.where(vkv, pd, zero),
                      tfa._grouped(do, h_kv))
    dm = torch.where(vkv, ds, zero).reshape(B * h, sq, sk) / scale
    want_dq = tfa.flash_bwd_dq_ref(q, k, v, do, lse, delta, **kw)
    want_dk, want_dv, want_dm = tfa.flash_bwd_dkv_ref(
        q, k, v, do, lse, delta, tmask_grad=True, **kw)
    for name, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk),
                            ("dv", dv, want_dv), ("dmask", dm, want_dm)):
        _close_normalized(got.numpy(), want.numpy(), atol=1e-6, name=name)


def _flags_np(mask, sq, sk, causal):
    """The full-row flag of each 64-row cell row of ``mask`` (4-D,
    broadcasting to ``[mb, mh, sq, sk]``) by a direct loop: set where
    some row that sees a key (bottom-right causal under ``causal``) has
    no value above -0.5e30 among the keys it sees."""
    m = np.broadcast_to(mask, mask.shape[:2] + (sq, sk))
    out = np.zeros(mask.shape[:2] + (-(-sq // 64),), np.uint8)
    for r in range(sq):
        last = r + sk - sq if causal else sk - 1
        if last < 0:
            continue
        live = (m[:, :, r, :last + 1] > -0.5e30).any(-1)
        out[:, :, r // 64] |= ~live
    return out


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", SKIP_CASES,
                         ids=[f"{c[1]}-sq{c[5]}sk{c[6]}" for c in SKIP_CASES])
def test_tile_full_row_flags_match_numpy(case, causal):
    """``tile_classes_ref``'s full-row flags (and the wrapper's on the
    CPU) against a direct numpy loop on the skip rule's masks, with the
    causal flag both ways (sq != sk: the bottom-right diagonal, rows that
    see no key never flagged); the class table beside them is the one
    ``tile_classes_ref`` gives alone."""
    shape, kind, _, _, _, sq, sk, _ = case
    m = _class_mask(kind, shape)
    classes, flags = tfa.tile_classes(_t(m), sq, sk, causal=causal,
                                      full_rows=True)
    assert flags.dtype == torch.uint8
    np.testing.assert_array_equal(flags.numpy(), _flags_np(m, sq, sk,
                                                           causal))
    np.testing.assert_array_equal(classes.numpy(),
                                  tfa.tile_classes_ref(_t(m), sq, sk).numpy())
    if kind in ("blocks", "random"):  # row 70 or row 3 is fully masked
        assert flags.any()


def _fwd_visits(cls, flags, sq, sk, causal):
    """[b, h, sq, sk]: the pairs flash_fwd_tile_wgmma visits. Each 64-row
    cell row (a warpgroup of a 128-row item) visits every key tile if the
    class pass flags it, else the tiles whose cell is not DEAD up to the
    causal band of its rows."""
    b, h = cls.shape[:2]
    vis = torch.zeros(b, h, sq, sk, dtype=torch.bool)
    for rs in range(0, sq, 64):
        last = min(rs + 64, sq) - 1 + (sk - sq) if causal else sk - 1
        for kt in range(-(-sk // 64)):
            go = flags[:, :, rs // 64].bool() | (
                (cls[:, :, rs // 64, kt] != tfa.TILE_DEAD) & (64 * kt <= last))
            vis[:, :, rs:rs + 64, 64 * kt:64 * kt + 64] |= go[..., None, None]
    return vis


@pytest.mark.parametrize("case", SKIP_CASES,
                         ids=[f"{c[1]}-causal{int(c[2])}-sq{c[5]}sk{c[6]}"
                              f"-p{c[7]}" for c in SKIP_CASES])
def test_tile_fwd_skip_rule_is_exact(case):
    """A plain model of the tile forward's skip rule: O and lse computed
    over only the cells the forward visits (_fwd_visits, from the class
    table and the full-row flags) equal ``flash_fwd_ref``, which visits
    every pair, within 1e-6 of each's largest magnitude (lse over the
    rows that see a live key; the others' equal), with dropout and with
    fully masked rows (the "blocks" masks' row 70, "random"'s row 3:
    their cell rows are visited whole), and the rule does skip."""
    shape, kind, causal, h, h_kv, sq, sk, p = case
    q, k, v, _ = (_t(a) for a in _inputs(50, h, h_kv, sq, sk))
    mask = _t(_class_mask(kind, shape))
    kw = dict(causal=causal, tmask=mask, seed=SEED if p else None,
              dropout=p)
    want_out, want_lse = tfa.flash_fwd_ref(q, k, v, **kw)
    cls, flags = tfa.tile_classes_ref(mask, sq, sk, causal, full_rows=True)
    vis = _fwd_visits(cls.expand(B, h, -1, -1), flags.expand(B, h, -1),
                      sq, sk, causal)
    assert not vis.all()
    assert bool(flags.any()) == (kind in ("blocks", "random"))
    grouped = (B, h_kv, h // h_kv, sq, sk)
    s = tfa._masked_scores(q, k, 1.0 / math.sqrt(D), causal, 0, True,
                           tmask=mask)
    s = torch.where(vis.reshape(grouped), s, torch.tensor(-math.inf))
    lse = torch.logsumexp(s, -1)
    pr = torch.softmax(s, -1)
    factor = tfa._drop_factor(tfa._dropout_words(p, kw["seed"], None, h),
                              q, k)
    if factor is not None:
        pr = pr * factor
    out = torch.einsum("bkgqc,bckd->bqkgd", pr, v)
    sees = tfa._sees(q, k, causal)[None, :, None, None, None]
    out = torch.where(sees, out, torch.zeros(())).reshape(B, sq, h, D)
    _close_normalized(out.numpy(), want_out.numpy(), atol=1e-6, name="O")
    lse = lse.reshape(B * h, sq)
    live = want_lse > 0.5 * tfa.NEG_INF
    assert torch.equal(live, lse > 0.5 * tfa.NEG_INF)
    _close_normalized(lse[live].numpy(), want_lse[live].numpy(), atol=1e-6,
                      name="lse")


def test_tile_attention_runs_one_class_pass(monkeypatch):
    """The tile mode's table is computed once per attention call: one
    forward plus backward through ``flash_attention(tmask=)`` on the
    wgmma path (``_fusable`` made true, so that the CPU runs the
    wiring with the plain versions) calls ``tile_classes`` once, in the
    forward, which hands its table to dQ and dK/dV; a forward under
    ``torch.no_grad`` calls it once; the gradients are those of the
    plain path."""
    h, h_kv, sq, sk = 4, 2, 130, 150
    q, k, v, do = (_t(a) for a in _inputs(51, h, h_kv, sq, sk))
    mask = _t(_structured_np("blocks", (1, h, sq, sk)))
    kw = dict(causal=True, seed=SEED, dropout=0.1)

    def grads():
        leaves = [t.clone().requires_grad_() for t in (q, k, v, mask)]
        tfa.flash_attention(*leaves[:3], tmask=leaves[3], **kw).backward(do)
        return [t.grad for t in leaves]

    want = grads()
    calls = []
    classes = tfa.tile_classes

    def counted(*a, **kwargs):
        calls.append(kwargs)
        return classes(*a, **kwargs)

    monkeypatch.setattr(tfa, "tile_classes", counted)
    monkeypatch.setattr(tfa, "_fusable", lambda t: True)
    got = grads()
    assert calls == [dict(causal=True, full_rows=True)]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    with torch.no_grad():
        tfa.flash_attention(q, k, v, tmask=mask, **kw)
    assert len(calls) == 2


def test_fused_tile_dq_plain_is_delta_then_dq():
    """The plain counterpart of the tile mode's fused dQ entry
    (``flash_bwd_dq_delta_ref`` given ``tmask``, dropout and ``coords``)
    is ``_delta`` followed by ``flash_bwd_dq_ref``, bit for bit, and the
    wrapper takes it on the CPU."""
    h, h_kv, sq, sk = 4, 2, 130, 150
    q, k, v, do = (_t(a) for a in _inputs(48, h, h_kv, sq, sk))
    mask = _t(_structured_np("blocks", (1, h, sq, sk)))
    kw = dict(causal=True, tmask=mask, seed=SEED, dropout=0.1,
              coords=(2, 4, 12))
    out, lse = tfa.flash_fwd_ref(q, k, v, **kw)
    dq, delta = tfa.flash_bwd_dq_delta_ref(q, k, v, do, out, lse, **kw)
    want_delta = tfa._delta(do, out)
    torch.testing.assert_close(delta, want_delta, rtol=0, atol=0)
    torch.testing.assert_close(
        dq, tfa.flash_bwd_dq_ref(q, k, v, do, lse, want_delta, **kw),
        rtol=0, atol=0)
    got = tfa.flash_bwd_dq_delta(q, k, v, do, out, lse, **kw)
    for a, b_ in zip(got, (dq, delta)):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)


def test_tile_backward_routes_to_the_fused_dq():
    """On CUDA the Function's tile backward fuses delta into dQ for
    bfloat16 and float16 with d <= 128, dropout or not (one class pass
    for both kernels); fp32 and d > 128 keep delta as torch ops, and so
    does the CPU."""
    mask = torch.zeros(1, 1, 8, 8)
    args = dict(kmask=None, dropout=0.1, tmask=mask)

    def on_card(dtype, d):
        return types.SimpleNamespace(is_cuda=True, dtype=dtype,
                                     shape=(1, 8, 2, d))

    assert tfa._fused_delta(on_card(torch.bfloat16, 64), args)
    assert tfa._fused_delta(on_card(torch.bfloat16, 128),
                            dict(args, dropout=0.0))
    assert not tfa._fused_delta(on_card(torch.float32, 64), args)
    assert tfa._fused_delta(on_card(torch.float16, 128), args)
    assert tfa._fused_delta(on_card(torch.float16, 64), args)
    assert not tfa._fused_delta(on_card(torch.bfloat16, 256), args)
    assert not tfa._fused_delta(torch.zeros(1, 8, 2, 64,
                                            dtype=torch.bfloat16), args)


def test_function_backward_takes_a_plain_calls_args():
    """The Function's backward run on saved tensors with the arguments of
    a call without a tile mask or coordinates (as a caller that times the
    backward alone builds them) gives the autograd gradients."""
    q, k, v, do = (_t(a) for a in _inputs(49, 4, 2, 32, 64))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    tfa.flash_attention(*leaves, causal=True).backward(do)
    out, lse = tfa.flash_fwd_ref(q, k, v, causal=True)
    ctx = types.SimpleNamespace(
        saved_tensors=(q, k, v, out, lse),
        args=dict(causal=True, scale=1.0 / math.sqrt(D), window=0,
                  kmask=None, seed=None, dropout=0.0))
    grads = tfa._FlashFn.backward(ctx, do)
    for got, leaf in zip(grads, leaves):
        torch.testing.assert_close(got, leaf.grad, rtol=0, atol=0)
