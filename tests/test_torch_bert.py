"""The port's encoder training path held against the JAX package on the
CPU.

``BertConfig.tiny`` (2 layers, hidden 64, 4 heads of 32) with weights
loaded through ``load_jax_weights``; token ids, token types, a padded
``attention_mask`` (batch row 1 keeps 11 of 16 tokens) and MLM labels
(-100 where not predicted) are numpy arrays from a seed, fed to both
packages. Dropout is 0 on both sides where they are compared (the
reference draws its masks from ``jax.random``); attention runs through
the port's head-batched plain versions here (the mask routes there) and
the reference's composite. Tolerances:

- fp32: logits within 1e-4, the loss within 1e-5, every gradient within
  1e-4 after dividing by its max abs (the frameworks sum in different
  orders);
- 5 AdamW ``TrainStep`` s: losses within 1e-4 at every step, params
  within 2e-3 (Adam's first steps move a weight by about lr * sign(g);
  a near-zero gradient whose sign the orders flip moves it ~2 lr apart);
- ``amp.decorate`` O2 in bf16 (LayerNorm in bf16 on both sides, the mask
  bias -9984): losses within 5e-2 over 4 steps (bf16 rounds at other
  places in the two frameworks: XLA may keep excess precision between
  bf16 ops), every parameter bf16 with an fp32 master;
- eval-mode ``BertForSequenceClassification`` (dropout 0.1 configured,
  off in eval): logits within 1e-4;
- dropout statistics: keep share within 1 % of 1 - p, kept values
  scaled by exactly 1/(1 - p).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.jit.train_step import TrainStep as JaxTrainStep
from paddle_tpu.models import BertConfig as JaxBertConfig
from paddle_tpu.models import BertForMaskedLM as JaxBertMLM
from paddle_tpu.models import BertForSequenceClassification as JaxBertCls
from paddle_tpu_torch import amp
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (
    BertConfig, BertForMaskedLM, BertForSequenceClassification,
    load_jax_weights,
)
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import AdamW

B, S, V = 2, 16, 128
NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def jax_arrays(model):
    return {n: np.asarray(p._data) for n, p in model.named_parameters()}


def _pair(seed=0, **kw):
    """(jax MLM model, port MLM model on the CPU with the same weights)."""
    cfg = dict(NO_DROP, **kw)
    pt.seed(seed)
    jm = JaxBertMLM(JaxBertConfig.tiny(**cfg))
    tm = BertForMaskedLM(BertConfig.tiny(**cfg), device="cpu")
    load_jax_weights(tm, jax_arrays(jm))
    return jm, tm


def _batch(seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, V, (B, S)).astype(np.int32)
    types = rng.randint(0, 2, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 11:] = 0
    labels = np.where((rng.rand(B, S) < 0.3) & (mask > 0), ids,
                      -100).astype(np.int32)
    labels[0, 0] = ids[0, 0]  # at least one predicted token
    return ids, types, mask, labels


def _close_normalized(got, want, atol, name):
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, atol=atol,
                               rtol=0, err_msg=name)


def _jax_call(jm, *arrays):
    return jm(*(pt.to_tensor(a) for a in arrays))


def _torch_call(tm, *arrays):
    return tm(*(torch.from_numpy(a) for a in arrays))


def test_names_shapes_and_flops_are_the_references():
    jm, tm = _pair()
    want = {n: tuple(p.shape) for n, p in jm.named_parameters()}
    assert {n: tuple(p.shape) for n, p in tm.named_parameters()} == want
    n_params = sum(int(np.prod(s)) for s in want.values())
    cfg = tm.config
    assert tm.flops_per_token(S) == 6 * n_params \
        + cfg.num_hidden_layers * 12 * S * cfg.hidden_size


def test_forward_and_grads_match_reference():
    jm, tm = _pair(seed=1)
    ids, types, mask, labels = _batch(1)
    jlogits = _jax_call(jm, ids, types, mask).numpy()
    tlogits = _torch_call(tm, ids, types, mask)
    np.testing.assert_allclose(tlogits.detach().numpy(), jlogits, atol=1e-4,
                               rtol=0)
    jloss = _jax_call(jm, ids, types, mask, labels)
    jloss.backward()
    tloss = _torch_call(tm, ids, types, mask, labels)
    assert tloss.dtype == torch.float32 and tloss.dim() == 0
    np.testing.assert_allclose(float(tloss.detach()), float(jloss.numpy()),
                               atol=1e-5, rtol=0)
    tloss.backward()
    jgrads = {n: p.grad for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        if jgrads[n] is None:  # the pooler: not on the MLM loss's path
            assert p.grad is None and n.startswith("bert.pooler."), n
            continue
        _close_normalized(p.grad.numpy(), np.asarray(jgrads[n].numpy()),
                          1e-4, n)


def test_adamw_5_steps_match_reference():
    jm, tm = _pair(seed=2)
    jstep = JaxTrainStep(jm, pt.optimizer.AdamW(
        learning_rate=1e-3, weight_decay=0.01, parameters=jm.parameters()),
        lambda m, *b: m(*b))
    step = TrainStep(tm, AdamW(learning_rate=1e-3, weight_decay=0.01,
                               parameters=tm.parameters()))
    losses = []
    for i in range(5):
        ids, types, mask, labels = _batch(10 + i)
        jl = float(jstep(*(pt.to_tensor(a) for a in (ids, types, mask,
                                                     labels))).numpy())
        tl = float(step(*(torch.from_numpy(a) for a in (ids, types, mask,
                                                        labels))))
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0,
                                   err_msg=f"step {i}")
        losses.append(tl)
    want = jax_arrays(jm)
    for n, p in tm.named_parameters():
        got = p.detach().numpy()
        if n.endswith("attention.qkv.bias"):
            # the k part's true gradient is 0 (a bias on every key shifts
            # a row's scores alike): Adam moves it by ~lr per step in the
            # direction of rounding noise, up to 2 x 5 x lr apart
            np.testing.assert_allclose(got[64:128], want[n][64:128],
                                       atol=1e-2, rtol=0, err_msg=n)
            got, want[n] = np.delete(got, np.s_[64:128]), np.delete(
                want[n], np.s_[64:128])
        np.testing.assert_allclose(got, want[n], atol=2e-3, rtol=0,
                                   err_msg=n)


def test_amp_o2_bf16_matches_reference(monkeypatch):
    jm, tm = _pair(seed=3, dtype="bfloat16")
    jm = pt.amp.decorate(jm, level="O2", dtype="bfloat16")
    tm = amp.decorate(tm, level="O2", dtype="bfloat16")
    jopt = pt.optimizer.AdamW(learning_rate=1e-3,
                              parameters=jm.parameters(),
                              multi_precision=True)
    opt = AdamW(learning_rate=1e-3, parameters=tm.parameters())
    tm, opt = amp.decorate(tm, opt, level="O2", dtype="bfloat16")
    assert opt._multi_precision
    jstep = JaxTrainStep(jm, jopt, lambda m, *b: m(*b))
    step = TrainStep(tm, opt)
    seen = []
    sdpa = TF.scaled_dot_product_attention

    def spy(q, k, v, attn_mask=None, *a, **kw):
        seen.append(attn_mask)
        return sdpa(q, k, v, attn_mask, *a, **kw)

    monkeypatch.setattr(tbert.F, "scaled_dot_product_attention", spy)
    ids, types, mask, labels = _batch(4)
    losses = []
    for i in range(4):
        jl = float(jstep(*(pt.to_tensor(a) for a in (ids, types, mask,
                                                     labels))).numpy())
        tl = float(step(*(torch.from_numpy(a) for a in (ids, types, mask,
                                                        labels))))
        np.testing.assert_allclose(tl, jl, atol=5e-2, rtol=0,
                                   err_msg=f"step {i}")
        losses.append(tl)
    assert losses[-1] < losses[0]
    # the mask bias is built in bf16, where -1e4 rounds to -9984
    assert seen[0].dtype == torch.bfloat16
    assert seen[0].min().item() == -9984.0
    for n, p in tm.named_parameters():
        assert p.dtype == torch.bfloat16, n
        if not n.startswith("bert.pooler."):  # the pooler has no gradient
            assert opt._master_weights[id(p)].dtype == torch.float32, n


@pytest.mark.parametrize("level, dtype", [("O1", "bfloat16"),
                                          ("O2", "float16")])
def test_amp_decorate_raises_on_what_is_not_ported(level, dtype):
    """O1 and float16 are ported now: decorate keeps O1's parameters
    fp32 (``auto_cast`` casts per op) and casts O2's to float16, forcing
    the optimizer's fp32 masters either way; what it still refuses (an
    unknown level or dtype) raises and leaves the parameters as they
    were."""
    tm = BertForMaskedLM(BertConfig.tiny(), device="cpu")
    for bad in (dict(level="O3", dtype=dtype), dict(level=level,
                                                    dtype="float8")):
        with pytest.raises(ValueError):
            amp.decorate(tm, **bad)
        assert all(p.dtype == torch.float32 for p in tm.parameters())
    opt = AdamW(1e-3, parameters=tm.parameters())
    tm, opt = amp.decorate(tm, opt, level=level, dtype=dtype)
    want = torch.float32 if level == "O1" else torch.float16
    assert all(p.dtype == want for p in tm.parameters())
    assert opt._multi_precision


def test_sequence_classification_eval_matches_reference():
    """Dropout 0.1 is configured but off in eval mode on both sides."""
    pt.seed(6)
    jm = JaxBertCls(JaxBertConfig.tiny(), num_classes=3)
    jm.eval()
    tm = BertForSequenceClassification(BertConfig.tiny(), num_classes=3,
                                       device="cpu")
    load_jax_weights(tm, jax_arrays(jm))
    tm.eval()
    ids, types, mask, _ = _batch(6)
    want = _jax_call(jm, ids, types, mask).numpy()
    got = _torch_call(tm, ids, types, mask)
    assert got.shape == (B, 3)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4,
                               rtol=0)


def test_dropout_statistics_and_seeding():
    """``F.dropout`` keeps ~1 - p and scales kept values by exactly
    1/(1 - p); eval and p = 0 are identities (``downscale_in_infer``
    keeps values unscaled in training); ``framework.random.seed`` makes
    a training forward (hidden and attention dropout) repeatable, and
    two draws differ."""
    trandom.seed(0)
    x = torch.ones(200_000)
    y = TF.dropout(x, 0.1)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.01
    assert (y[kept] == torch.tensor(1.0) / 0.9).all()
    assert TF.dropout(x, 0.1, training=False) is x
    assert TF.dropout(x, 0.0) is x
    down = TF.dropout(x, 0.1, mode="downscale_in_infer")
    assert set(down.unique().tolist()) == {0.0, 1.0}
    tm = BertForMaskedLM(BertConfig.tiny(), device="cpu")
    ids, types, mask, _ = _batch(7)
    trandom.seed(5)
    a = _torch_call(tm, ids, types, mask)
    b = _torch_call(tm, ids, types, mask)
    trandom.seed(5)
    c = _torch_call(tm, ids, types, mask)
    torch.testing.assert_close(a, c, rtol=0, atol=0)
    assert not torch.equal(a, b)
    tm.eval()
    torch.testing.assert_close(_torch_call(tm, ids, types, mask),
                               _torch_call(tm, ids, types, mask),
                               rtol=0, atol=0)
    w0, w1 = trandom.next_seed_words(), trandom.next_seed_words()
    assert w0 != w1 and all(-2 ** 31 <= w < 2 ** 31 for w in w0 + w1)
