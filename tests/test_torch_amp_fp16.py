"""The port's encoder and Transformer paths under ``amp`` float16 (and
BERT under O1 bfloat16) held against the JAX package on the CPU.

The models and batches are those of ``tests/test_torch_bert.py``,
``tests/test_torch_ernie.py`` and ``tests/test_torch_transformer.py``
(tiny widths, dropout 0, numpy inputs from a seed), with the port's
kernels through their plain versions. Tolerances:

- ``BertForMaskedLM`` under ``auto_cast`` O1 float16: the loss within
  2e-3, every gradient within 1e-2 after dividing by its max abs. The
  reference's linears cast under the op ``linear`` (``F.linear``) and
  its tied decoder under ``matmul``; a port that multiplied without
  casting raised under O1 (C.16).
- The same under O1 bfloat16: the loss within 2.5e-2, every gradient
  within 1e-1 of its max abs and within 4e-2 of its norm. The port and
  the reference round bfloat16 in different places inside attention
  (the qkv projection's outputs agree exactly, the attention layer's
  differ by 3.6e-3 of their max abs, about one bfloat16 ulp), and the
  backward carries that. Readings (BERT-tiny, seed 1): loss 1.95e-2 apart, the
  worst gradient 9.1e-2 of its max abs and 3.5e-2 of its norm (seeds 2-4:
  2.8e-2 to 3.7e-2 of max abs). 2e-3 and 1e-2 cannot hold: the
  reference's own bfloat16 gradients lie 1.2e-2 to 3.1e-2 of their max
  abs from its fp32 ones on seeds 1-4. ``--xla_allow_excess_precision=
  false`` changes none of the reference's numbers. That the cast rules
  are the reference's is held exactly, by the dtypes each layer gives
  (``test_bert_o1_casts_as_the_reference``, both dtypes).
- ``amp.decorate`` O2 float16 (every parameter float16, LayerNorm in
  float16): the loss within 2e-3 + 2.5e-4 of its size (half a float16
  ulp of the fp32 loss, whose logits come out of float16 products),
  every gradient within 1e-2.
- 4 O1 float16 AdamW steps through ``GradScaler`` (a scale of 2**15
  overflows float16 gradients at first): the scale after each step
  equal, the losses within 2e-3 + 2.5e-4 of their size.
- ERNIE's heads under O1 float16 (``proj``, ``transform`` and
  ``classifier`` are BERT's ``_Linear``): the joint loss within 2e-3,
  every gradient within 1e-2.
- ``nn.Transformer`` under O1 float16: the output within 2e-3 of its
  max abs, every gradient within 1e-2 of its max abs; the key
  projections' biases, whose gradient is zero in exact arithmetic (a
  bias on every key shifts a row's scores alike), by their size: below
  1e-2 of their weight's largest gradient on both sides.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as pnn
import paddle_tpu_torch.nn as tnn
from paddle_tpu.models import BertConfig as JaxBertConfig
from paddle_tpu.models import BertForMaskedLM as JaxBertMLM
from paddle_tpu.models import ErnieConfig as JaxErnieConfig
from paddle_tpu.models import ErnieForPretraining as JaxErnie
from paddle_tpu_torch import amp
from paddle_tpu_torch.framework.device import using_device
from paddle_tpu_torch.models import (
    BertConfig, BertForMaskedLM, ErnieConfig, ErnieForPretraining,
    load_jax_weights,
)
from paddle_tpu_torch.nn.layer.layers import load_jax_weights as load_layer
from paddle_tpu_torch.optimizer import AdamW

B, S, V = 2, 16, 128
NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
HALF_ULP = 2.0 ** -12  # half a float16 ulp, relative


def _arrays(model):
    return {n: np.asarray(p._data) for n, p in model.named_parameters()}


def _bert_pair(seed, **kw):
    cfg = dict(NO_DROP, **kw)
    pt.seed(seed)
    jm = JaxBertMLM(JaxBertConfig.tiny(**cfg))
    tm = BertForMaskedLM(BertConfig.tiny(**cfg), device="cpu")
    load_jax_weights(tm, _arrays(jm))
    return jm, tm


def _ernie_pair(seed):
    pt.seed(seed)
    jm = JaxErnie(JaxErnieConfig.tiny(**NO_DROP))
    tm = ErnieForPretraining(ErnieConfig.tiny(**NO_DROP), device="cpu")
    load_jax_weights(tm, _arrays(jm))
    return jm, tm


def _batch(seed, types=2, lm=False):
    """ids, token types, a padded mask (row 1 keeps 11 of 16), MLM labels
    (-100 where not predicted) and, with ``lm``, the LM labels."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, V, (B, S)).astype(np.int32)
    tt = rng.randint(0, types, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 11:] = 0
    labels = np.where((rng.rand(B, S) < 0.3) & (mask > 0), ids,
                      -100).astype(np.int32)
    labels[0, 0] = ids[0, 0]  # at least one predicted token
    out = (ids, tt, mask, labels)
    if lm:
        out += (np.where(mask > 0, ids, -100).astype(np.int32),)
    return out


def _jax(jm, arrays):
    return jm(*(pt.to_tensor(a) for a in arrays))


def _port(tm, arrays):
    return tm(*(torch.from_numpy(a) for a in arrays))


def _grads_close(tm, jm, atol, norm_tol=None):
    """Every gradient within ``atol`` of its max abs and, with
    ``norm_tol``, its difference within ``norm_tol`` of its norm."""
    jg = {n: p.grad for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        if jg[n] is None:  # the pooler: not on the loss's path
            assert p.grad is None, n
            continue
        want = np.asarray(jg[n].numpy()).astype(np.float32)
        got = p.grad.float().numpy()
        scale = np.abs(want).max() + 1e-12
        np.testing.assert_allclose(got / scale, want / scale, atol=atol,
                                   rtol=0, err_msg=n)
        if norm_tol is not None:
            gap = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert gap <= norm_tol, (n, gap)


@pytest.mark.parametrize("dtype, loss_tol, grad_tol, norm_tol",
                         [("float16", 2e-3, 1e-2, None),
                          ("bfloat16", 2.5e-2, 1e-1, 4e-2)])
def test_bert_o1_matches_reference(dtype, loss_tol, grad_tol, norm_tol):
    jm, tm = _bert_pair(1)
    batch = _batch(1)
    with pt.amp.auto_cast(level="O1", dtype=dtype):
        jl = _jax(jm, batch)
    jl.backward()
    with amp.auto_cast(level="O1", dtype=dtype):
        tl = _port(tm, batch)
    tl.backward()
    assert tl.dtype == torch.float32
    assert abs(tl.item() - float(jl.numpy())) <= loss_tol
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    _grads_close(tm, jm, grad_tol, norm_tol)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_bert_o1_casts_as_the_reference(dtype):
    """Under O1 the attention projection (``ColumnParallelLinear``) runs
    in the low dtype with its bias inside the product, the output
    projection (``RowParallelLinear``) adds its fp32 bias after it, and
    the tied decoder is a low-precision ``matmul``: the dtypes the
    reference's layers give."""
    _, tm = _bert_pair(0)
    x = torch.randn(B, S, 64)
    layer = tm.bert.encoder[0]
    low = getattr(torch, dtype)
    with amp.auto_cast(level="O1", dtype=dtype):
        assert layer.attention.qkv(x).dtype == low
        assert layer.attention.out(x).dtype == torch.float32
        assert layer.inter(x).dtype == low
        assert layer.output(torch.randn(B, S, 128)).dtype == torch.float32
        logits = _port(tm, _batch(0)[:3])
    assert logits.dtype == torch.float32


def test_bert_o2_fp16_matches_reference():
    jm, tm = _bert_pair(1, dtype="float16")
    jm = pt.amp.decorate(jm, level="O2", dtype="float16")
    tm = amp.decorate(tm, level="O2", dtype="float16")
    assert all(p.dtype == torch.float16 for p in tm.parameters())
    batch = _batch(1)
    jl = _jax(jm, batch)
    jl.backward()
    tl = _port(tm, batch)
    tl.backward()
    want = float(jl.numpy())
    assert abs(tl.item() - want) <= 2e-3 + HALF_ULP * abs(want)
    _grads_close(tm, jm, 1e-2)


def test_bert_o1_fp16_grad_scaler_steps():
    jm, tm = _bert_pair(5)
    jopt = pt.optimizer.AdamW(learning_rate=1e-3,
                              parameters=jm.parameters())
    topt = AdamW(learning_rate=1e-3, parameters=tm.parameters())
    kw = dict(init_loss_scaling=2.0 ** 15, incr_every_n_steps=2)
    js, ts = pt.amp.GradScaler(**kw), amp.GradScaler(**kw)
    scales = ([], [])
    for i in range(4):
        batch = _batch(20 + i)
        with pt.amp.auto_cast(level="O1", dtype="float16"):
            jl = _jax(jm, batch)
        js.minimize(jopt, js.scale(jl))
        jopt.clear_grad()
        with amp.auto_cast(level="O1", dtype="float16"):
            tl = _port(tm, batch)
        ts.minimize(topt, ts.scale(tl))
        topt.clear_grad()
        want = float(jl.numpy())
        assert np.isfinite(tl.item())
        assert abs(tl.item() - want) <= 2e-3 + HALF_ULP * abs(want), i
        scales[0].append(js.get_loss_scaling())
        scales[1].append(ts.get_loss_scaling())
    assert scales[0] == scales[1]
    # a skipped step halved the scale, and two good ones doubled it
    assert min(scales[1]) < 2.0 ** 15 and scales[1][-1] > min(scales[1])


def test_ernie_o1_fp16_matches_reference():
    jm, tm = _ernie_pair(1)
    batch = _batch(1, types=4, lm=True)
    with pt.amp.auto_cast(level="O1", dtype="float16"):
        jl = _jax(jm, batch)
    jl.backward()
    with amp.auto_cast(level="O1", dtype="float16"):
        tl = _port(tm, batch)
    tl.backward()
    assert abs(tl.item() - float(jl.numpy())) <= 2e-3
    _grads_close(tm, jm, 1e-2)


def test_transformer_o1_fp16_matches_reference():
    d, h, t = 32, 4, 5
    rng = np.random.RandomState(5)
    kw = dict(d_model=d, nhead=h, num_encoder_layers=2,
              num_decoder_layers=2, dim_feedforward=64, dropout=0.0)
    pt.seed(0)
    with using_device("cpu"):
        ref = pnn.Transformer(**kw)
        port = tnn.Transformer(**kw)
        load_layer(port, {n: np.asarray(p.numpy())
                          for n, p in ref.state_dict().items()})
        src = rng.standard_normal((B, S, d)).astype(np.float32)
        tgt = rng.standard_normal((B, t, d)).astype(np.float32)
        keep = np.ones((B, 1, 1, S), bool)
        keep[1, ..., 5:] = False
        mem_mask = np.where(keep, 0.0, -1e9).astype(np.float32)
        r_in = [pt.to_tensor(a, stop_gradient=False) for a in (src, tgt)]
        t_in = [torch.tensor(a, requires_grad=True) for a in (src, tgt)]
        with pt.amp.auto_cast(level="O1", dtype="float16"):
            r_out = ref(*r_in, pt.to_tensor(keep),
                        ref.generate_square_subsequent_mask(t),
                        pt.to_tensor(mem_mask))
        with amp.auto_cast(level="O1", dtype="float16"):
            t_out = port(*t_in, torch.from_numpy(keep),
                         port.generate_square_subsequent_mask(t),
                         torch.from_numpy(mem_mask))
        want = np.asarray(r_out.numpy()).astype(np.float32)
        assert t_out.dtype == torch.float32
        np.testing.assert_allclose(t_out.detach().numpy(), want, rtol=0,
                                   atol=2e-3 * np.abs(want).max())
        cot = rng.standard_normal((B, t, d)).astype(np.float32)
        (r_out * pt.to_tensor(cot)).sum().backward()
        (t_out * torch.from_numpy(cot)).sum().backward()
    pairs = [(tq.grad.numpy(), np.asarray(rq.grad.numpy()), name)
             for rq, tq, name in zip(r_in, t_in, ("src", "tgt"))]
    rp = dict(ref.named_parameters())
    for n, p in port.named_parameters():
        got = p.grad.numpy()
        want = np.asarray(rp[n].grad.numpy()).astype(np.float32)
        if n.endswith("k_proj.bias"):
            top = np.abs(np.asarray(
                rp[n[:-len("bias")] + "weight"].grad.numpy())).max()
            assert np.abs(got).max() < 1e-2 * top, n
            assert np.abs(want).max() < 1e-2 * top, n
            continue
        pairs.append((got, want, n))
    for got, want, name in pairs:
        scale = np.abs(want).max() + 1e-12
        np.testing.assert_allclose(got / scale, want / scale, atol=1e-2,
                                   rtol=0, err_msg=name)
