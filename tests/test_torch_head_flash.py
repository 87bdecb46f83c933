"""The port's head-batched flash plain versions (kernels 4-6) held
against the Pallas kernels of ``paddle_tpu/ops/pallas/head_flash.py``,
run in interpret mode on the CPU as ``tests/test_head_flash.py`` runs
them.

On the same numpy inputs and seed words (fp32, b2, h4, d32; the Pallas
side with 16-row blocks, so several tiles per row and key):

- ``_keep_mask_ref`` against the reference's ``_keep_mask``, tile by
  tile: **exactly** equal;
- ``hb_fwd_ref`` against ``_hb_fwd``: O within 2e-5 and lse (the
  reference's ``[b, sq, h, 128]`` lane broadcast, ``[..., 0]``) within
  2e-5 (fp32; the streaming and the one-pass softmax sum in different
  orders);
- ``hb_bwd_dq_ref`` and ``hb_bwd_dkv_ref`` against ``_hb_bwd_impl`` fed
  the same O, lse and dO: dQ, dK, dV and dmask each divided by its max
  abs within 1e-4;
- the autograd ``hb_flash`` against ``jax.grad`` of the reference's
  ``hb_flash``, the key mask's gradient included;
- kernel 5's entry that computes delta itself (``hb_bwd_dq_delta``, its
  plain form on the CPU) against ``_hb_bwd_impl``'s dQ and the
  reference's delta;
- a plain model of the CUDA forward's and dQ's skip of wholly padded key
  tiles (128 and 64 keys), held against the rule it implements by brute
  force, and the skip's premise: the skipped tiles' keys set to -inf
  leave the plain outputs bit-identical.

Cases: non-causal with a BERT-style additive key mask, with and without
dropout 0.1; causal with a window and dropout; GQA h4/h_kv2 with mask
and dropout; sq 32 against sk 64; no variant. The routing of
``F.scaled_dot_product_attention`` is checked here too.
"""
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import head_flash as jhf
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from paddle_tpu_torch.ops.cuda import head_flash as thf

B, D, BLOCK = 2, 32, 16
SEED = (123456789, -987654321)  # int32 words, one negative
CASES = [
    # (causal, window, h, h_kv, sq, sk, kmask, dropout)
    (False, 0, 4, 4, 64, 64, True, 0.0),
    (False, 0, 4, 4, 64, 64, True, 0.1),
    (True, 24, 4, 4, 64, 64, False, 0.1),
    (True, 0, 4, 2, 64, 64, True, 0.1),
    (False, 0, 4, 2, 32, 64, True, 0.0),
    (False, 0, 4, 4, 64, 64, False, 0.0),
]
IDS = [f"causal{int(c)}-w{w}-h{h}kv{hk}-sq{sq}sk{sk}-km{int(m)}-p{p}"
       for c, w, h, hk, sq, sk, m, p in CASES]


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


def _kmask(sk, use):
    """BertModel's additive padding bias ``(mask - 1) * 1e4`` as ``[b, 1,
    sk]``: batch row 0 keeps 40 keys (or sk * 5 / 8), row 1 all."""
    if not use:
        return None
    keep = np.ones((B, sk), np.float32)
    keep[0, sk * 5 // 8:] = 0.0
    return ((keep - 1.0) * 1e4)[:, None, :]


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _seed(dropout):
    return jnp.asarray(SEED, jnp.int32) if dropout else None


def _close_normalized(got, want, atol=1e-4, name=""):
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, atol=atol,
                               rtol=0, err_msg=name)


def _jax_fwd(q, k, v, km, causal, window, dropout):
    return jhf._hb_fwd(q, k, v, causal, 1.0 / math.sqrt(D), True, BLOCK,
                       BLOCK, window, seed=_seed(dropout), dropout=dropout,
                       kmask=None if km is None else jnp.asarray(km))


def _lse_bh(jlse):
    """The reference's ``[b, sq, h, 128]`` lse as the port's ``[b * h,
    sq]``."""
    x = np.asarray(jlse)[..., 0]
    return x.transpose(0, 2, 1).reshape(-1, x.shape[1])


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("tile", [(0, 0, 0), (5, 1, 3), (7, 3, 2)])
def test_keep_mask_bit_exact(tile, rate):
    """``_keep_mask_ref`` equals the reference's ``_keep_mask`` element
    for element on (head, query tile, key tile) coordinates."""
    head, qi, ki = tile
    want = np.asarray(jfa._keep_mask(jnp.asarray(SEED, jnp.int32),
                                     jnp.int32(head), qi, ki, BLOCK, BLOCK,
                                     rate))
    full = tfa._keep_mask_ref(SEED, torch.tensor([head]), 64, 64, rate)[0]
    got = full[qi * BLOCK:(qi + 1) * BLOCK, ki * BLOCK:(ki + 1) * BLOCK]
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.3 < want.mean() < 0.95  # the keep share is near 1 - rate


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fwd_plain_matches_pallas(case):
    causal, window, h, h_kv, sq, sk, use_km, p = case
    q, k, v, _ = _inputs(0, h, h_kv, sq, sk)
    km = _kmask(sk, use_km)
    jout, jlse = _jax_fwd(q, k, v, km, causal, window, p)
    out, lse = thf.hb_fwd_ref(_t(q), _t(k), _t(v), causal=causal,
                              window=window, kmask=_t(km),
                              seed=SEED if p else None, dropout=p)
    assert out.shape == q.shape and lse.shape == (B * h, sq)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), _lse_bh(jlse), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bwd_plain_matches_pallas(case):
    causal, window, h, h_kv, sq, sk, use_km, p = case
    q, k, v, do = _inputs(1, h, h_kv, sq, sk)
    km = _kmask(sk, use_km)
    jout, jlse = _jax_fwd(q, k, v, km, causal, window, p)
    jdq, jdk, jdv, jdm = jhf._hb_bwd_impl(
        q, k, v, jout, jlse, do, causal, 1.0 / math.sqrt(D), True, BLOCK,
        BLOCK, window, _seed(p), p,
        kmask=None if km is None else jnp.asarray(km))
    out, tdo = _t(np.asarray(jout)), _t(do)
    lse = _t(_lse_bh(jlse))
    delta = (tdo * out).sum(-1).permute(0, 2, 1).reshape(B * h, sq) \
        .contiguous()
    kw = dict(causal=causal, window=window, kmask=_t(km),
              seed=SEED if p else None, dropout=p)
    args = (_t(q), _t(k), _t(v), tdo, lse, delta)
    dq = thf.hb_bwd_dq_ref(*args, **kw)
    dk, dv, *dm = thf.hb_bwd_dkv_ref(*args, **kw)
    _close_normalized(dq.numpy(), np.asarray(jdq), name="dq")
    _close_normalized(dk.numpy(), np.asarray(jdk), name="dk")
    _close_normalized(dv.numpy(), np.asarray(jdv), name="dv")
    if use_km:
        assert dm[0].shape == (B, 1, sk)
        _close_normalized(dm[0].numpy(), np.asarray(jdm), name="dmask")
    else:
        assert not dm and jdm is None
    # the public entries take the CPU route to the same plain versions
    torch.testing.assert_close(thf.hb_bwd_dq(*args, **kw), dq, rtol=0,
                               atol=0)


@pytest.mark.parametrize("case", CASES[1::2], ids=IDS[1::2])
def test_autograd_matches_jax_grad(case):
    """Output and the gradients of q, k, v and the key mask through the
    autograd ``hb_flash`` against ``jax.grad`` of the reference's
    ``hb_flash`` (interpret mode)."""
    causal, window, h, h_kv, sq, sk, use_km, p = case
    q, k, v, w = _inputs(2, h, h_kv, sq, sk)
    km = _kmask(sk, True)
    scale = 1.0 / math.sqrt(D)

    def jax_attn(q_, k_, v_, km_):
        return jhf.hb_flash(q_, k_, v_, _seed(p), km_, causal, scale, True,
                            BLOCK, BLOCK, window, p)

    jout = jax_attn(q, k, v, km)
    jgrads = jax.grad(lambda *a: (jax_attn(*a) * w).sum(),
                      argnums=(0, 1, 2, 3))(q, k, v, km)
    tq, tk, tv, tkm = (_t(x).requires_grad_() for x in (q, k, v, km))
    out = thf.hb_flash(tq, tk, tv, seed=SEED if p else None, kmask=tkm,
                       causal=causal, window=window, dropout=p)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=2e-5, rtol=0)
    (out * _t(w)).sum().backward()
    for name, got, want in zip(("q", "k", "v", "kmask"), (tq, tk, tv, tkm),
                               jgrads):
        _close_normalized(got.grad.numpy(), np.asarray(want), name=name)


@pytest.mark.parametrize("causal,p", [(False, 0.0), (False, 0.1),
                                      (True, 0.1)],
                         ids=["noncausal", "noncausal-p0.1", "causal-p0.1"])
def test_wholly_padded_key_tile_gives_exact_zeros(causal, p):
    """The premise of the CUDA dK/dV kernels' skip of wholly padded key
    tiles: on a batch whose row 0 holds 40 live keys of 128 (keys 64-127,
    a whole 64-key tile, are padding at -1e4), both JAX's ``_hb_bwd_impl``
    (interpret mode) and the port's ``hb_bwd_dkv_ref`` give exactly 0 in
    dK, dV and dmask at those keys, since exp(-1e4 + s - lse) is 0 in
    fp32 in every row that sees a live key. The port's dmask is its
    per-head dmask (``flash_bwd_dkv_ref`` with the mask spread per head)
    summed over heads."""
    h, s = 4, 128
    q, k, v, do = _inputs(6, h, h, s, s)
    keep = np.ones((B, s), np.float32)
    keep[0, 40:] = 0.0
    km = ((keep - 1.0) * 1e4)[:, None, :]
    jout, jlse = _jax_fwd(q, k, v, km, causal, 0, p)
    _, jdk, jdv, jdm = jhf._hb_bwd_impl(
        q, k, v, jout, jlse, do, causal, 1.0 / math.sqrt(D), True, BLOCK,
        BLOCK, 0, _seed(p), p, kmask=jnp.asarray(km))
    out, tdo = _t(np.asarray(jout)), _t(do)
    lse = _t(_lse_bh(jlse))
    delta = (tdo * out).sum(-1).permute(0, 2, 1).reshape(B * h, s) \
        .contiguous()
    kw = dict(causal=causal, seed=SEED if p else None, dropout=p)
    args = (_t(q), _t(k), _t(v), tdo, lse, delta)
    dk, dv, dm = thf.hb_bwd_dkv_ref(*args, kmask=_t(km), **kw)
    for name, got in (("jax dk", jdk), ("jax dv", jdv), ("port dk", dk),
                      ("port dv", dv)):
        assert (np.asarray(got)[0, 64:] == 0).all(), name
        assert (np.asarray(got)[1, 64:] != 0).any(), name
    assert (np.asarray(jdm)[0, 0, 64:] == 0).all()
    assert (dm[0, 0, 64:] == 0).all() and (dm[0, 0, :40] != 0).all()
    _, _, dm_heads = tfa.flash_bwd_dkv_ref(
        *args, kmask=thf._per_head(_t(km), h), **kw)
    torch.testing.assert_close(dm, dm_heads.reshape(B, h, 1, s).sum(1),
                               rtol=0, atol=0)


def test_dropout_masks_agree_across_kernel_families():
    """Kernel 4's dropout (head ``b * h + i``) is kernel 1's, bit for
    bit: with the same seed both plain versions give the same output,
    and the keep share and the 1/(1-p) scale show in a ones-valued V."""
    q, k, v, _ = (_t(x) for x in _inputs(3, 4, 4, 64, 64))
    out4, _ = thf.hb_fwd_ref(q, k, v, seed=SEED, dropout=0.25)
    out1, _ = tfa.flash_fwd_ref(q, k, v, causal=False, seed=SEED,
                                dropout=0.25)
    torch.testing.assert_close(out4, out1, rtol=0, atol=0)
    keep = tfa._keep_mask_ref(SEED, torch.arange(B * 4), 64, 64, 0.25)
    assert abs(keep.float().mean().item() - 0.75) < 0.01
    # uniform scores: every p is 1/64, so O = (1/64) * kept / (1 - p)
    ones = torch.ones(B, 64, 4, D)
    out, _ = thf.hb_fwd_ref(torch.zeros(B, 64, 4, D), ones, ones,
                            seed=SEED, dropout=0.25)
    want = keep.float().sum(-1) / 64 / 0.75  # [b * h, sq]
    torch.testing.assert_close(out[..., 0].permute(0, 2, 1).reshape(B * 4,
                                                                    64),
                               want, rtol=1e-6, atol=1e-6)


def test_sdpa_routes_masks_and_dropout_to_the_head_batched_entry():
    """A ``[b, 1, 1, sk]`` mask (bool keep or additive float) or dropout
    while training goes to ``hb_flash`` (kernels 4-6); a bool mask's
    fully padded batch row outputs exactly 0, an additive one the
    unmasked attention; a row-varying mask goes to the tile mode of
    kernels 1-3 instead."""
    q, k, v, _ = (_t(x) for x in _inputs(4, 4, 4, 32, 32))
    keep = torch.ones(B, 1, 1, 32, dtype=torch.bool)
    keep[0, ..., 20:] = False
    keep[1] = False  # every key of batch row 1 padded
    got = TF.scaled_dot_product_attention(q, k, v, attn_mask=keep)
    kadd = torch.where(keep.reshape(B, 1, 32), 0.0, tfa.NEG_INF)
    torch.testing.assert_close(got, thf.hb_flash(q, k, v, kmask=kadd),
                               rtol=0, atol=0)
    assert (got[1] == 0).all() and (got[0] != 0).any()
    bias = (keep.float() - 1.0) * 1e4
    got = TF.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    torch.testing.assert_close(got, thf.hb_flash(q, k, v,
                                                 kmask=bias.reshape(B, 1,
                                                                    32)))
    # an additive -1e4 on every key of batch row 1 shifts all its scores
    # alike: the softmax, and so O, is the unmasked one, up to the fp32
    # rounding of scores near -1e4 (ulp 2**-10 ~ 1e-3)
    plain = tfa.flash_attention(q, k, v, causal=False)
    torch.testing.assert_close(got[1], plain[1], rtol=0, atol=2e-3)
    huge = torch.full((B, 1, 1, 32), -3e38)
    torch.testing.assert_close(
        TF.scaled_dot_product_attention(q, k, v, attn_mask=huge),
        thf.hb_flash(q, k, v, kmask=torch.full((B, 1, 32), tfa.NEG_INF)),
        rtol=0, atol=0)
    rows = torch.ones(B, 1, 32, 32)
    n = (thf.hb_fwd.launches, tfa.flash_fwd.tile_launches)
    torch.testing.assert_close(
        TF.scaled_dot_product_attention(q, k, v, attn_mask=rows),
        tfa.flash_attention(q, k, v, causal=False, tmask=rows), rtol=0,
        atol=0)
    assert (thf.hb_fwd.launches, tfa.flash_fwd.tile_launches) == n  # CPU
    with pytest.raises(NotImplementedError, match="dtype"):
        TF.scaled_dot_product_attention(
            q, k, v, attn_mask=torch.ones(B, 1, 1, 32, dtype=torch.int32))
    n = (thf.hb_fwd.launches, tfa.flash_fwd.launches)
    TF.scaled_dot_product_attention(q, k, v, dropout_p=0.1)
    assert (thf.hb_fwd.launches, tfa.flash_fwd.launches) == n  # CPU


@pytest.mark.parametrize("fault", ["kmask_shape", "kmask_dtype",
                                   "no_seed", "rate"])
def test_wrapper_rejects(fault):
    q, k, v, _ = (_t(x) for x in _inputs(5, 4, 4, 16, 16))
    kw = {}
    if fault == "kmask_shape":
        kw = dict(kmask=torch.zeros(B * 4, 1, 16))
    elif fault == "kmask_dtype":
        kw = dict(kmask=torch.zeros(B, 1, 16, dtype=torch.float64))
    elif fault == "no_seed":
        kw = dict(dropout=0.1)
    else:
        kw = dict(dropout=1.0, seed=SEED)
    with pytest.raises(ValueError):
        thf.hb_fwd(q, k, v, **kw)


# -- kernel 5 computing delta itself ------------------------------------------
# hb_bwd_dq_delta's plain form (the CPU route of the entry that the CUDA
# backward takes in bf16) against _hb_bwd_impl's dQ (Pallas, interpret
# mode) and the reference's delta (head_flash.py:352, the same expression
# on the same O and dO), with and without the key row and dropout: dQ as
# test_bwd_plain_matches_pallas holds it (1e-4 of its max abs), delta
# within 1e-5 (fp32 sums of 32 fp32 products, summed in another order).
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fused_dq_delta_plain_matches_pallas(case):
    causal, window, h, h_kv, sq, sk, use_km, p = case
    q, k, v, do = _inputs(7, h, h_kv, sq, sk)
    km = _kmask(sk, use_km)
    jout, jlse = _jax_fwd(q, k, v, km, causal, window, p)
    jdq, _, _, _ = jhf._hb_bwd_impl(
        q, k, v, jout, jlse, do, causal, 1.0 / math.sqrt(D), True, BLOCK,
        BLOCK, window, _seed(p), p,
        kmask=None if km is None else jnp.asarray(km))
    jdelta = jnp.sum(jnp.asarray(do, jout.dtype).astype(jnp.float32)
                     * jout.astype(jnp.float32), axis=-1)  # [b, sq, h]
    out, tdo, lse = _t(np.asarray(jout)), _t(do), _t(_lse_bh(jlse))
    kw = dict(causal=causal, window=window, kmask=_t(km),
              seed=SEED if p else None, dropout=p)
    tq, tk, tv = _t(q), _t(k), _t(v)
    dq, delta = thf.hb_bwd_dq_delta(tq, tk, tv, tdo, out, lse, **kw)
    assert dq.shape == q.shape and delta.shape == (B * h, sq)
    _close_normalized(dq.numpy(), np.asarray(jdq), name="dq")
    np.testing.assert_allclose(
        delta.numpy(), np.asarray(jdelta).transpose(0, 2, 1).reshape(-1, sq),
        atol=1e-5, rtol=0)
    # the plain form is kernel 5's plain version beside _delta
    want = thf.hb_bwd_dq_ref(tq, tk, tv, tdo, lse, tfa._delta(tdo, out),
                             **kw)
    torch.testing.assert_close(dq, want, rtol=0, atol=0)
    torch.testing.assert_close(delta, tfa._delta(tdo, out), rtol=0, atol=0)


def test_backward_fuses_delta_by_device_and_dtype(monkeypatch):
    """``_HbFlashFn.backward`` takes kernel 5's fused entry on CUDA in
    bfloat16 and float16 with ``d <= 128`` (key row and dropout
    included); on the CPU it computes delta as torch ops, once per
    backward."""
    def on_card(dtype, d):  # what the routing reads of a CUDA tensor
        return types.SimpleNamespace(is_cuda=True, dtype=dtype,
                                     shape=(1, 8, 2, d))

    assert tfa._fusable(on_card(torch.bfloat16, 64))
    assert tfa._fusable(on_card(torch.bfloat16, 128))
    assert tfa._fusable(on_card(torch.float16, 64))
    assert not tfa._fusable(on_card(torch.bfloat16, 136))
    assert not tfa._fusable(on_card(torch.float32, 64))
    assert not tfa._fusable(torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16))
    calls = []
    real = tfa._delta
    monkeypatch.setattr(tfa, "_delta",
                        lambda *a: calls.append(1) or real(*a))
    q, k, v = (_t(x).requires_grad_() for x in _inputs(8, 4, 4, 32, 32)[:3])
    km = _t(_kmask(32, True))
    thf.hb_flash(q, k, v, seed=SEED, kmask=km, dropout=0.1).sum().backward()
    assert len(calls) == 1 and q.grad is not None


# -- the wgmma forward's and dQ's skip of wholly padded key tiles -------------
# A plain model of csrc/flash_attention.cu's key_tile_producer and
# padded_tiles: the key tiles a block of the forward (128 keys a tile) or
# of dQ (64) visits, in order (first to last without causal masking, else
# last to first), given one key row. The first tile of the band is always
# visited (its load is issued before the scan); a later one is skipped
# when it is wholly padding (<= -1e3) and either the row has a live key
# (non-causal) or a tile before it does (causal); never with a window;
# tiles past 63 never. Its bits are held against the rule they implement
# (every row that sees a skipped tile also sees a live key) by brute force.

PAD_LEVEL = -1e3  # csrc/flash_attention.cu's kPadLevel


def _skip_bits(km_row, bk, causal, window):
    """padded_tiles: {tile index} that may be skipped."""
    if window > 0:
        return set()
    live = km_row > PAD_LEVEL
    nt = -(-len(km_row) // bk)
    tile_live = [bool(live[t * bk:(t + 1) * bk].any()) for t in range(nt)]
    if not any(live):
        return set()
    first = next((t for t in range(min(nt, 64)) if tile_live[t]), None)
    return {t for t in range(min(nt, 64)) if not tile_live[t]
            and (not causal or (first is not None and t > first))}


def _visited_tiles(km_row, sq, r0, bq, bk, causal, window):
    """key_tile_producer's announced tiles for the block at query row r0."""
    sk = len(km_row)
    kt0, kt1 = 0, -(-sk // bk)
    if causal:
        cmax = min(sk - 1, min(r0 + bq, sq) - 1 + sk - sq)
        kt1 = 0 if cmax < 0 else cmax // bk + 1
        if window > 0 and r0 + sk - sq - window + 1 > 0:
            kt0 = (r0 + sk - sq - window + 1) // bk
    order = list(range(kt1 - 1, kt0 - 1, -1)) if causal \
        else list(range(kt0, kt1))
    skip = _skip_bits(km_row, bk, causal, window)
    return [kt for n, kt in enumerate(order) if n == 0 or kt not in skip]


def _row(sk, live):
    row = np.full(sk, -9984.0, np.float32)  # BERT's -1e4 padding in bf16
    row[list(live)] = 0.0
    return row


SKIP_ROWS = {
    # name: (sk, live keys)
    "right_pad_300": (512, range(300)),
    "right_pad_128": (512, range(128)),
    "one_live_key": (512, [0]),
    "one_live_key_late": (512, [400]),
    "all_padding": (512, []),
    "no_padding": (512, range(512)),
    "ragged_331": (331, range(100)),
}


@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0), (True, 64)],
                         ids=["noncausal", "causal", "window64"])
@pytest.mark.parametrize("bk", [128, 64], ids=["fwd128", "dq64"])
@pytest.mark.parametrize("name", list(SKIP_ROWS))
def test_skip_bits_model(name, bk, causal, window):
    sk, live_keys = SKIP_ROWS[name]
    row = _row(sk, live_keys)
    live = row > PAD_LEVEL
    skip = _skip_bits(row, bk, causal, window)
    vis = (np.arange(sk)[None] <= np.arange(sk)[:, None]) if causal \
        else np.ones((sk, sk), bool)
    if window:
        vis &= np.arange(sk)[None] > np.arange(sk)[:, None] - window
    for t in range(-(-sk // bk)):
        tile = slice(t * bk, (t + 1) * bk)
        sees = vis[:, tile].any(1)  # the rows that see tile t
        safe = not live[tile].any() and (vis[sees] & live).any(1).all()
        assert t not in skip or safe, f"tile {t} skipped but needed"
        if not causal and not window and safe and sees.any():
            assert t in skip, f"tile {t} could be skipped"
    if window:
        assert not skip
    if name == "all_padding":  # rows see no live key: nothing is skipped
        assert not skip
    if name == "right_pad_300" and not causal and not window:
        assert skip == ({3} if bk == 128 else {5, 6, 7})
    # every block visits each live tile of its band, and the first tile of
    # its band even when it is padding
    for r0 in range(0, sk, 128):
        tiles = _visited_tiles(row, sk, r0, 128, bk, causal, window)
        assert len(set(tiles)) == len(tiles)
        band = set(_visited_tiles(np.zeros(sk, np.float32), sk, r0, 128, bk,
                                  causal, window))
        assert set(tiles) <= band
        assert {t for t in band if live[t * bk:(t + 1) * bk].any()} \
            <= set(tiles)


@pytest.mark.parametrize("p", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("causal", [False, True], ids=["noncausal",
                                                       "causal"])
@pytest.mark.parametrize("bk", [128, 64], ids=["fwd128", "dq64"])
def test_skipped_tiles_contribute_nothing(bk, causal, p):
    """The skip's premise: setting every key of the tiles the model skips
    to -inf (so they contribute exactly nothing) leaves O, lse and dQ of
    the plain versions bit-identical, on batch rows of 0, 1, 100 and all
    320 live keys (BERT's -9984 padding)."""
    lengths, h, s = [0, 1, 100, 320], 2, 320
    rng = np.random.RandomState(9)
    q, k, v, do = (torch.from_numpy(rng.randn(len(lengths), s, h, D).astype(
        np.float32)) for _ in range(4))
    km = np.stack([_row(s, range(n)) for n in lengths])[:, None, :]
    cut = km.copy()
    for bi in range(len(lengths)):
        for t in _skip_bits(km[bi, 0], bk, causal, 0):
            cut[bi, 0, t * bk:(t + 1) * bk] = -np.inf
    assert (cut != km).any()
    kw = dict(causal=causal, seed=SEED if p else None, dropout=p)
    out, lse = thf.hb_fwd_ref(q, k, v, kmask=_t(km), **kw)
    out_c, lse_c = thf.hb_fwd_ref(q, k, v, kmask=_t(cut), **kw)
    assert torch.equal(out, out_c) and torch.equal(lse, lse_c)
    dq, delta = thf.hb_bwd_dq_delta(q, k, v, do, out, lse, kmask=_t(km),
                                    **kw)
    dq_c, delta_c = thf.hb_bwd_dq_delta(q, k, v, do, out, lse,
                                        kmask=_t(cut), **kw)
    assert torch.equal(dq, dq_c) and torch.equal(delta, delta_c)


# -- float16 ------------------------------------------------------------------
# The Pallas kernels follow their input dtype, as the plain versions do:
# at float16 (O, dQ, dK, dV in float16; lse, delta and dmask fp32) both
# compute in fp32 and round each output once, so the two stay within 2
# float16 ulps of the larger magnitude (one rounding each, plus fp32
# summation order); dmask as at fp32, lse (about 4.4 here) within 1e-4:
# one of several runs of the first case read 4.4e-5 on a few rows, the
# others 5e-7, with the same inputs.

def _fp16_ulps(got, want):
    """max |got - want| in float16 ulps of the larger of the two tensors'
    largest magnitudes."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    top = max(np.abs(got).max(), np.abs(want).max())
    return np.abs(got - want).max() / float(np.spacing(np.float16(top)))


@pytest.mark.parametrize("case", CASES[:4], ids=IDS[:4])
def test_fp16_plain_matches_pallas(case):
    causal, window, h, h_kv, sq, sk, use_km, p = case
    q, k, v, do = (x.astype(np.float16)
                   for x in _inputs(2, h, h_kv, sq, sk))
    km = _kmask(sk, use_km)
    jout, jlse = _jax_fwd(q, k, v, km, causal, window, p)
    assert jout.dtype == jnp.float16
    kw = dict(causal=causal, window=window, kmask=_t(km),
              seed=SEED if p else None, dropout=p)
    out, lse = thf.hb_fwd(_t(q), _t(k), _t(v), **kw)
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    assert _fp16_ulps(out.numpy(), jout) <= 2
    np.testing.assert_allclose(lse.numpy(), _lse_bh(jlse), atol=1e-4,
                               rtol=0)
    jdq, jdk, jdv, jdm = jhf._hb_bwd_impl(
        q, k, v, jout, jlse, do, causal, 1.0 / math.sqrt(D), True, BLOCK,
        BLOCK, window, _seed(p), p,
        kmask=None if km is None else jnp.asarray(km))
    args = (_t(q), _t(k), _t(v), _t(do), _t(np.asarray(jout)),
            _t(_lse_bh(jlse)))
    dq, delta = thf.hb_bwd_dq_delta(*args, **kw)
    dk, dv, *dm = thf.hb_bwd_dkv(*args[:4], args[5], delta, **kw)
    for name, got, want in (("dq", dq, jdq), ("dk", dk, jdk),
                            ("dv", dv, jdv)):
        assert got.dtype == torch.float16, name
        assert np.asarray(want).dtype == np.float16, name
        assert _fp16_ulps(got.numpy(), want) <= 2, name
    if use_km:
        _close_normalized(dm[0].numpy(), np.asarray(jdm), name="dmask")
