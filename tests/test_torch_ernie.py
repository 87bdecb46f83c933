"""The port's ERNIE 3.0 held against the JAX package on the CPU.

``ErnieConfig.tiny`` (trunk 4 x 64 with 4 heads of 16, task branches 2 x
32 with 2 heads of 16, vocab 128) with weights loaded through
``load_jax_weights``; token ids, token types, a padded
``attention_mask`` (batch row 1 keeps 11 of 16 tokens), MLM labels
(-100 where not predicted) and LM labels are numpy arrays from a seed,
fed to both packages. Dropout is 0 where the two are compared (the
reference draws its masks from ``jax.random``). Attention runs through
the port's plain versions: kernels 1-3's without a mask, kernels 4-6's
with one (and with dropout: the routing test). Tolerances, as
``tests/test_torch_bert.py``:

- fp32: logits of both heads within 1e-4, the joint loss within 1e-5,
  every gradient within 1e-4 after dividing by its max abs, without and
  with the mask;
- 5 AdamW ``TrainStep`` s under ``LinearWarmup(PolynomialDecay)``:
  losses within 1e-4 at every step, params within 2e-3 (the k part of
  each ``qkv.bias`` within 1e-2: its true gradient is 0);
- ``amp.decorate`` O2 in bf16 (the mask bias -9984): losses within 5e-2
  over 4 steps;
- eval-mode ``ErnieForSequenceClassification``: logits within 1e-4.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.jit.train_step import TrainStep as JaxTrainStep
from paddle_tpu.models import ErnieConfig as JaxErnieConfig
from paddle_tpu.models import ErnieForPretraining as JaxErnie
from paddle_tpu.models import ErnieForSequenceClassification as JaxErnieCls
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import amp
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (
    ErnieConfig, ErnieForPretraining, ErnieForSequenceClassification,
    load_jax_weights,
)
from paddle_tpu_torch.models import ernie as ternie
from paddle_tpu_torch.nn.functional import attention as tattn
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr

B, S, V = 2, 16, 128
NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def jax_arrays(model):
    return {n: np.asarray(p._data) for n, p in model.named_parameters()}


def _pair(seed=0, **kw):
    """(jax pretraining model, port model on the CPU, same weights)."""
    cfg = dict(NO_DROP, **kw)
    pt.seed(seed)
    jm = JaxErnie(JaxErnieConfig.tiny(**cfg))
    tm = ErnieForPretraining(ErnieConfig.tiny(**cfg), device="cpu")
    load_jax_weights(tm, jax_arrays(jm))
    return jm, tm


def _batch(seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, V, (B, S)).astype(np.int32)
    types = rng.randint(0, 4, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 11:] = 0
    mlm = np.where((rng.rand(B, S) < 0.3) & (mask > 0), ids,
                   -100).astype(np.int32)
    mlm[0, 0] = ids[0, 0]  # at least one predicted token
    lm = np.where(mask > 0, ids, -100).astype(np.int32)
    return ids, types, mask, mlm, lm


def _close_normalized(got, want, atol, name):
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, atol=atol,
                               rtol=0, err_msg=name)


def _jax_call(jm, *arrays):
    return jm(*(None if a is None else pt.to_tensor(a) for a in arrays))


def _torch_call(tm, *arrays):
    return tm(*(None if a is None else torch.from_numpy(a) for a in arrays))


@pytest.mark.parametrize("task_hidden", [32, 64], ids=["proj", "no_proj"])
def test_names_shapes_and_flops_are_the_references(task_hidden):
    """Names and shapes as the reference's, ``proj`` only where the task
    width differs from the trunk's; the default config is the 10B
    model's."""
    jm, tm = _pair(task_hidden_size=task_hidden,
                   num_task_attention_heads=4 if task_hidden == 64 else 2)
    want = {n: tuple(p.shape) for n, p in jm.named_parameters()}
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    assert got == want
    assert ("ernie.nlu_branch.proj.weight" in got) == (task_hidden == 32)
    for n in ("ernie.encoder.0.attention.qkv.weight",
              "ernie.nlu_branch.layer.1.inter.bias",
              "mlm_head.decoder.bias", "lm_head.weight"):
        assert n in got, n
    assert "lm_head.bias" not in got
    for s in (S, 1024):
        assert tm.flops_per_token(s) == jm.flops_per_token(s)
    big, ref = ErnieConfig(), JaxErnieConfig()
    assert vars(big) == vars(ref)
    assert vars(ErnieConfig.ernie3_10b()) == vars(ref)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "kmask"])
@pytest.mark.parametrize("task_hidden", [32, 64], ids=["proj", "no_proj"])
def test_forward_and_grads_match_reference(masked, task_hidden):
    """Without a mask attention takes kernels 1-3's plain versions, with
    the padded mask kernels 4-6's; both heads' logits, the joint loss
    and every gradient against the reference."""
    jm, tm = _pair(seed=1, task_hidden_size=task_hidden,
                   num_task_attention_heads=4 if task_hidden == 64 else 2)
    ids, types, mask, mlm, lm = _batch(1)
    mask = mask if masked else None
    jlogits = _jax_call(jm, ids, types, mask)
    tlogits = _torch_call(tm, ids, types, mask)
    for j, t in zip(jlogits, tlogits):
        assert t.shape == (B, S, V)
        np.testing.assert_allclose(t.detach().numpy(), j.numpy(), atol=1e-4,
                                   rtol=0)
    jloss = _jax_call(jm, ids, types, mask, mlm, lm)
    jloss.backward()
    tloss = _torch_call(tm, ids, types, mask, mlm, lm)
    assert tloss.dtype == torch.float32 and tloss.dim() == 0
    np.testing.assert_allclose(float(tloss.detach()), float(jloss.numpy()),
                               atol=1e-5, rtol=0)
    tloss.backward()
    jgrads = {n: p.grad for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        assert p.grad is not None, n
        _close_normalized(p.grad.numpy(), np.asarray(jgrads[n].numpy()),
                          1e-4, n)


def _spy(monkeypatch):
    """Record each attention call's kernel family and causality."""
    calls = []
    flash, hb = tattn.flash_kernel, tattn.hb_flash

    def spy_flash(q, k, v, causal=False, **kw):
        calls.append(("1-3", causal))
        return flash(q, k, v, causal=causal, **kw)

    def spy_hb(q, k, v, seed=None, kmask=None, causal=False, **kw):
        calls.append(("4-6", causal))
        return hb(q, k, v, seed=seed, kmask=kmask, causal=causal, **kw)

    monkeypatch.setattr(tattn, "flash_kernel", spy_flash)
    monkeypatch.setattr(tattn, "hb_flash", spy_hb)
    return calls


@pytest.mark.parametrize("route", ["dropout", "kmask", "eval"])
def test_attention_routes(monkeypatch, route):
    """Each forward makes 2 x trunk + 2 x task-layer attention calls, half
    causal (the NLG pass and branch): with attention dropout while
    training, or with a mask, all go to kernels 4-6; in eval without a
    mask, to kernels 1-3."""
    cfg = ErnieConfig.tiny(hidden_dropout_prob=0.0)
    tm = ErnieForPretraining(cfg, device="cpu")
    ids, types, mask, mlm, lm = _batch(2)
    if route == "eval":
        tm.eval()
    calls = _spy(monkeypatch)
    _torch_call(tm, ids, types, mask if route == "kmask" else None, mlm,
                lm).backward()
    family = "1-3" if route == "eval" else "4-6"
    n = cfg.num_hidden_layers + cfg.num_task_layers
    assert calls == [(family, False)] * n + [(family, True)] * n


def _sched(mod):
    return mod.LinearWarmup(mod.PolynomialDecay(1e-3, decay_steps=10), 2,
                            1e-4, 1e-3)


def test_adamw_5_steps_match_reference():
    jm, tm = _pair(seed=2)
    jsched, tsched = _sched(jlr), _sched(tlr)
    jstep = JaxTrainStep(jm, pt.optimizer.AdamW(
        learning_rate=jsched, weight_decay=0.01,
        parameters=jm.parameters()), lambda m, *b: m(*b))
    step = TrainStep(tm, AdamW(learning_rate=tsched, weight_decay=0.01,
                               parameters=tm.parameters()))
    for i in range(5):
        batch = _batch(10 + i)
        jl = float(jstep(*(pt.to_tensor(a) for a in batch)).numpy())
        tl = float(step(*(torch.from_numpy(a) for a in batch)))
        assert step.last_lr == jsched()
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0,
                                   err_msg=f"step {i}")
        jsched.step()
        tsched.step()
    want = jax_arrays(jm)
    for n, p in tm.named_parameters():
        got = p.detach().numpy()
        if n.endswith("attention.qkv.bias"):
            # the k part's true gradient is 0 (a bias on every key shifts
            # a row's scores alike): Adam moves it by ~lr per step in the
            # direction of rounding noise
            h = got.shape[0] // 3
            np.testing.assert_allclose(got[h:2 * h], want[n][h:2 * h],
                                       atol=1e-2, rtol=0, err_msg=n)
            got = np.delete(got, np.s_[h:2 * h])
            want[n] = np.delete(want[n], np.s_[h:2 * h])
        np.testing.assert_allclose(got, want[n], atol=2e-3, rtol=0,
                                   err_msg=n)


def test_amp_o2_bf16_matches_reference(monkeypatch):
    jm, tm = _pair(seed=3, dtype="bfloat16")
    jm = pt.amp.decorate(jm, level="O2", dtype="bfloat16")
    jopt = pt.optimizer.AdamW(learning_rate=1e-3,
                              parameters=jm.parameters(),
                              multi_precision=True)
    opt = AdamW(learning_rate=1e-3, parameters=tm.parameters())
    tm, opt = amp.decorate(tm, opt, level="O2", dtype="bfloat16")
    jstep = JaxTrainStep(jm, jopt, lambda m, *b: m(*b))
    step = TrainStep(tm, opt)
    seen = []
    sdpa = ternie.F.scaled_dot_product_attention

    def spy(q, k, v, attn_mask=None, *a, **kw):
        seen.append(attn_mask)
        return sdpa(q, k, v, attn_mask, *a, **kw)

    monkeypatch.setattr(ternie.F, "scaled_dot_product_attention", spy)
    batch = _batch(4)
    losses = []
    for i in range(4):
        jl = float(jstep(*(pt.to_tensor(a) for a in batch)).numpy())
        tl = float(step(*(torch.from_numpy(a) for a in batch)))
        np.testing.assert_allclose(tl, jl, atol=5e-2, rtol=0,
                                   err_msg=f"step {i}")
        losses.append(tl)
    assert losses[-1] < losses[0]
    assert seen[0].dtype == torch.bfloat16
    assert seen[0].min().item() == -9984.0
    for n, p in tm.named_parameters():
        assert p.dtype == torch.bfloat16, n
        assert opt._master_weights[id(p)].dtype == torch.float32, n


def test_sequence_classification_eval_matches_reference():
    """Dropout 0.1 configured, off in eval on both sides; no mask, so the
    attention takes kernels 1-3's plain versions."""
    pt.seed(6)
    jm = JaxErnieCls(JaxErnieConfig.tiny(), num_classes=3)
    jm.eval()
    tm = ErnieForSequenceClassification(ErnieConfig.tiny(), num_classes=3,
                                        device="cpu")
    want_names = {n: tuple(p.shape) for n, p in jm.named_parameters()}
    assert {n: tuple(p.shape) for n, p in tm.named_parameters()} \
        == want_names
    load_jax_weights(tm, jax_arrays(jm))
    tm.eval()
    ids, types, mask, _, _ = _batch(6)
    for m in (None, mask):
        want = _jax_call(jm, ids, types, m).numpy()
        got = _torch_call(tm, ids, types, m)
        assert got.shape == (B, 3)
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4,
                                   rtol=0)


def test_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ErnieForPretraining(ErnieConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ErnieForSequenceClassification(ErnieConfig.tiny())
