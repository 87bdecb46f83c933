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
    it left out, a row-varying mask, raises and names it."""
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
    with pytest.raises(NotImplementedError, match="encoder slice"):
        TF.scaled_dot_product_attention(q, k, v,
                                        attn_mask=torch.ones(B, 1, 16, 16))
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
