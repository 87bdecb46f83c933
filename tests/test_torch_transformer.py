"""The port's Transformer layers held against the JAX package on the CPU.

- **MultiHeadAttention under every mask form**: none, bool, float,
  ``[sq, sk]``, ``[b, 1, sq, sk]``, ``[b, h, sq, sk]`` and ``[b, 1, 1,
  sk]``, with cross attention (``kdim``/``vdim``): output and every
  gradient within 1e-5 (fp32). The row-varying forms run the tile mode
  of kernels 1-3 (its plain versions here), ``[b, 1, 1, sk]`` kernels
  4-6; a spy on the entries checks the route.
- **Decoding with caches**: ``gen_cache`` / ``Cache`` step by step and
  the cross attention's ``StaticCache``, through a decoder stack, equal
  the reference's steps and the full causal forward.
- **Transformer**: a 2 + 2-layer model (d 32, 4 heads, dropout 0) with a
  key-padding source mask, the causal target mask of
  ``generate_square_subsequent_mask`` and a memory mask, post- and
  pre-norm: output and every gradient within 1e-5.
- **Dropout** by its hash: the tile mode drops the elements that kernels
  4-6 drop at the same coordinates, and attention dropout keeps the
  expected mass.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as pnn
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.framework.device import using_device
from paddle_tpu_torch.nn.functional import attention as tattn
from paddle_tpu_torch.nn.layer.layers import load_jax_weights
from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from paddle_tpu_torch.ops.cuda import head_flash as thf

TOL = 1e-5
B, S, T, D, H = 2, 7, 5, 32, 4


@pytest.fixture(autouse=True)
def _on_cpu():
    with using_device("cpu"):
        yield


def _carry(ref, port):
    load_jax_weights(port, {n: np.asarray(t.numpy())
                            for n, t in ref.state_dict().items()})
    return port


def _close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want.numpy() if hasattr(want, "numpy") else want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(np.abs(want).max(), 1.0),
                               err_msg=what)


_R = np.random.RandomState(23)


def _f32(*shape):
    return _R.standard_normal(shape).astype(np.float32)


def _masks():
    keep = _R.rand(B, H, S, T) > 0.3
    keep[..., 0] = True  # every row keeps a key
    floats = np.where(keep, _R.standard_normal(keep.shape) * 0.5,
                      -1e9).astype(np.float32)
    return {
        "none": None,
        "bool_b_h": keep,
        "float_b_h": floats,
        "float_sq_sk": floats[0, 0],
        "bool_b_1": keep[:, :1],
        "float_b_1": floats[:, :1],
        "key_padding_bool": keep[:, :1, :1],
        "key_padding_float": floats[:, :1, :1],
    }


MASKS = _masks()
Q, KV = _f32(B, S, D), _f32(B, T, 24)


@pytest.mark.parametrize("form", list(MASKS))
def test_mha_every_mask_form(form, monkeypatch):
    mask = MASKS[form]
    ref = pnn.MultiHeadAttention(D, H, kdim=24, vdim=24)
    port = _carry(ref, tnn.MultiHeadAttention(D, H, kdim=24, vdim=24))
    routes = []
    for name, fn in (("flash", tattn.flash_kernel), ("hb", tattn.hb_flash)):
        monkeypatch.setattr(tattn, f"{name}_kernel" if name == "flash"
                            else "hb_flash",
                            lambda *a, _n=name, _f=fn, **k: (
                                routes.append((_n, k.get("tmask") is not
                                               None)), _f(*a, **k))[1])
    rq = pt.to_tensor(Q, stop_gradient=False)
    rkv = pt.to_tensor(KV, stop_gradient=False)
    rm = None if mask is None else pt.to_tensor(mask)
    r_out = ref(rq, rkv, rkv, rm)
    tq = torch.tensor(Q, requires_grad=True)
    tkv = torch.tensor(KV, requires_grad=True)
    tm = None if mask is None else torch.from_numpy(mask)
    t_out = port(tq, tkv, tkv, tm)
    _close(t_out, r_out, "output")
    cot = _f32(*t_out.shape)
    (r_out * pt.to_tensor(cot)).sum().backward()
    (t_out * torch.from_numpy(cot)).sum().backward()
    _close(tq.grad, rq.grad, "dq")
    _close(tkv.grad, rkv.grad, "dkv")
    for n, p in port.named_parameters():
        _close(p.grad, dict(ref.named_parameters())[n].grad, n)
    want = {"none": ("flash", False)}.get(
        form, ("hb", False) if form.startswith("key_padding")
        else ("flash", True))
    assert routes == [want]


def test_mha_float_mask_receives_its_gradient():
    """A float mask that requires grad gets the reference's gradient of
    ``logits + mask``, summed over its broadcast dims."""
    mask = MASKS["float_b_1"]
    q, k, v = _f32(B, S, H, 8), _f32(B, T, H, 8), _f32(B, T, H, 8)

    def ref_fn(q, k, v, m):
        from paddle_tpu.nn.functional.attention import _sdpa_reference
        return _sdpa_reference(q, k, v, m)

    import jax
    out, vjp = jax.vjp(ref_fn, q, k, v, mask)
    cot = _f32(*out.shape)
    grads = vjp(cot)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v, mask)]
    t_out = TF.scaled_dot_product_attention(*ts[:3], attn_mask=ts[3])
    _close(t_out, np.asarray(out))
    t_out.backward(torch.from_numpy(cot))
    for t, g, name in zip(ts, grads, "qkvm"):
        _close(t.grad, np.asarray(g), name)


def test_cached_decode_equals_the_reference_and_the_full_forward():
    """A 2-layer decoder stack decodes 4 steps with ``gen_cache``: each
    step's output equals the reference's step and the matching row of the
    full forward under the causal mask."""
    layer = dict(d_model=D, nhead=H, dim_feedforward=48, dropout=0.0)
    ref = pnn.TransformerDecoder(pnn.TransformerDecoderLayer(**layer), 2)
    port = _carry(ref, tnn.TransformerDecoder(
        tnn.TransformerDecoderLayer(**layer), 2))
    ref.eval()
    port.eval()
    mem, tgt = _f32(B, S, D), _f32(B, 4, D)
    causal = np.triu(np.full((4, 4), -np.inf, np.float32), 1)
    full = port(torch.from_numpy(tgt), torch.from_numpy(mem),
                torch.from_numpy(causal))
    _close(full, ref(pt.to_tensor(tgt), pt.to_tensor(mem),
                     pt.to_tensor(causal)), "full forward")
    r_cache = ref.gen_cache(pt.to_tensor(mem))
    t_cache = port.gen_cache(torch.from_numpy(mem))
    assert isinstance(t_cache[0][1], tnn.MultiHeadAttention.StaticCache)
    for i in range(4):
        r_out, r_cache = ref(pt.to_tensor(tgt[:, i:i + 1]),
                             pt.to_tensor(mem), None, None, r_cache)
        t_out, t_cache = port(torch.from_numpy(tgt[:, i:i + 1]),
                              torch.from_numpy(mem), None, None, t_cache)
        _close(t_out, r_out, f"step {i}")
        _close(t_out[:, 0], full[:, i].detach().numpy(), f"row {i}")
        assert t_cache[0][0].k.shape == (B, i + 1, H, D // H)


def test_mha_incremental_cache_matches_the_reference():
    ref = pnn.MultiHeadAttention(D, H)
    port = _carry(ref, tnn.MultiHeadAttention(D, H))
    x = _f32(B, 3, D)
    rc = ref.gen_cache(pt.to_tensor(x))
    tc = port.gen_cache(torch.from_numpy(x))
    assert tc.k.shape == (B, 0, H, D // H)
    for i in range(3):
        r_out, rc = ref(pt.to_tensor(x[:, i:i + 1]), cache=rc)
        t_out, tc = port(torch.from_numpy(x[:, i:i + 1]), cache=tc)
        _close(t_out, r_out, f"step {i}")
    _close(tc.k, rc.k, "cache k")
    sc_r = ref.gen_cache(pt.to_tensor(x), type=ref.StaticCache)
    sc_t = port.gen_cache(torch.from_numpy(x), type=port.StaticCache)
    q = _f32(B, 2, D)
    _close(port(torch.from_numpy(q), cache=sc_t),
           ref(pt.to_tensor(q), cache=sc_r), "static cache")


@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post_norm", "pre_norm"])
def test_transformer_forward_and_backward(normalize_before):
    kw = dict(d_model=D, nhead=H, num_encoder_layers=2, num_decoder_layers=2,
              dim_feedforward=64, dropout=0.0,
              normalize_before=normalize_before)
    ref = pnn.Transformer(**kw)
    port = _carry(ref, tnn.Transformer(**kw))
    src, tgt = _f32(B, S, D), _f32(B, T, D)
    keep = np.ones((B, 1, 1, S), bool)
    keep[1, ..., 5:] = False
    tgt_mask = port.generate_square_subsequent_mask(T)
    _close(tgt_mask, ref.generate_square_subsequent_mask(T), "causal mask")
    mem_mask = np.where(keep, 0.0, -1e9).astype(np.float32)
    r_in = [pt.to_tensor(a, stop_gradient=False) for a in (src, tgt)]
    t_in = [torch.tensor(a, requires_grad=True) for a in (src, tgt)]
    r_out = ref(*r_in, pt.to_tensor(keep),
                ref.generate_square_subsequent_mask(T),
                pt.to_tensor(mem_mask))
    t_out = port(*t_in, torch.from_numpy(keep), tgt_mask,
                 torch.from_numpy(mem_mask))
    _close(t_out, r_out, "output")
    cot = _f32(B, T, D)
    (r_out * pt.to_tensor(cot)).sum().backward()
    (t_out * torch.from_numpy(cot)).sum().backward()
    for r, t, name in zip(r_in, t_in, ("src", "tgt")):
        _close(t.grad, r.grad, name)
    rp = dict(ref.named_parameters())
    for n, p in port.named_parameters():
        _close(p.grad, rp[n].grad, n)


def test_tile_mode_dropout_is_the_key_padding_hash():
    """The same mask as a ``[b, 1, 1, sk]`` key row (kernels 4-6) and as
    a ``[b, 1, sq, sk]`` tile (kernels 1-3's tile mode) with the same
    seed words drop the same elements: equal outputs."""
    q, k, v = (torch.from_numpy(_f32(B, 16, H, 16)) for _ in range(3))
    row = torch.from_numpy(np.where(_R.rand(B, 1, 1, 16) > 0.3, 0.0,
                                    -1e4).astype(np.float32))
    seed = (123, -456)
    a = thf.hb_flash(q, k, v, seed=seed, kmask=row.reshape(B, 1, 16),
                     dropout=0.3)
    b = tfa.flash_attention(q, k, v, causal=False, seed=seed, dropout=0.3,
                            tmask=row.expand(B, 1, 16, 16).contiguous())
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_attention_dropout_keeps_the_expected_mass():
    """With V all ones each output element is ``sum_c p_c keep_c / (1 -
    rate)``: its mean over many rows is 1 within six standard errors, and
    each equals that sum over the plain version's hash."""
    torch.manual_seed(0)
    b, s, h, d, rate = 4, 64, 4, 8, 0.25
    q, k = torch.randn(b, s, h, d), torch.randn(b, s, h, d)
    v = torch.ones(b, s, h, d)
    causal = torch.from_numpy(np.triu(np.full((s, s), -np.inf,
                                              np.float32), 1))
    out = TF.scaled_dot_product_attention(q, k, v, attn_mask=causal,
                                          dropout_p=rate)[..., 0]
    kept = out.flatten()
    n = kept.numel()
    assert abs(kept.mean().item() - 1.0) < 6 * kept.std().item() / n ** 0.5
    layer = tnn.MultiHeadAttention(32, 4, dropout=0.5)
    layer.train()
    x = torch.randn(2, 6, 32)
    assert not torch.equal(layer(x), layer(x))
    layer.eval()
    torch.testing.assert_close(layer(x), layer(x))
