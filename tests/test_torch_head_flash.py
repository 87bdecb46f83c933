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
  ``hb_flash``, the key mask's gradient included.

Cases: non-causal with a BERT-style additive key mask, with and without
dropout 0.1; causal with a window and dropout; GQA h4/h_kv2 with mask
and dropout; sq 32 against sk 64; no variant. The routing of
``F.scaled_dot_product_attention`` is checked here too.
"""
import math

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
    unmasked attention; a row-varying mask raises."""
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
    with pytest.raises(NotImplementedError, match="row-varying"):
        TF.scaled_dot_product_attention(q, k, v,
                                        attn_mask=torch.ones(B, 1, 32, 32))
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
