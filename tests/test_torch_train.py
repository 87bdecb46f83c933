"""The port's training path held against the JAX package on the CPU.

Weights reach the port through ``load_jax_weights``; token ids and
labels are numpy arrays from a seed, so both sides compute the same
function on the same inputs (fp32, ``LlamaConfig.tiny(num_hidden_layers
=2)``, attention through the flash kernels' plain versions here and the
composite in the reference):

- logits within 1e-4, the loss within 1e-5 and every parameter's
  gradient within 1e-4 after dividing by its max abs, with
  ``use_parallel_cross_entropy`` on and off and ``sliding_window`` 0
  and 8 (fp32; the frameworks sum in different orders);
- one SGD ``TrainStep`` within 1e-5 of the JAX ``TrainStep``;
- 20 AdamW steps with ``ClipGradByGlobalNorm(1.0)``: losses within 1e-4
  at every step;
- bf16 with ``multi_precision``: the loss falls, params stay bf16 and
  masters fp32, losses within 2e-2 of JAX;
- serving after training: the engine and ``generate()`` read the
  updated weights.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.jit.train_step import TrainStep as JaxTrainStep
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    ParallelCrossEntropy, masked_token_mean,
)
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (
    LlamaConfig, LlamaForCausalLM, generate, load_jax_weights,
)
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.nn import (
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
)
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import SGD, Adam, AdamW
from paddle_tpu_torch.serving import ServingConfig, ServingEngine

B, S = 2, 16


def jax_arrays(model):
    return {n: np.asarray(p._data) for n, p in model.named_parameters()}


def _pair(seed=0, **kw):
    """(jax model, port model on the CPU with the same weights)."""
    cfg = dict(num_hidden_layers=2, **kw)
    pt.seed(seed)
    jm = JaxLlama(JaxLlamaConfig.tiny(**cfg))
    if cfg.get("dtype") == "bfloat16":
        for p in jm.parameters():
            p._data = p._data.astype("bfloat16")
    tm = LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu")
    load_jax_weights(tm, jax_arrays(jm))
    return jm, tm


def _batch(seed, vocab=128, ignore=True):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (B, S)).astype(np.int32)
    labels = rng.randint(0, vocab, (B, S)).astype(np.int32)
    if ignore:  # a few ignored labels: the mean must skip them
        labels[0, :3] = -100
    return ids, labels


def _close_normalized(got, want, atol, name):
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, atol=atol,
                               rtol=0, err_msg=name)


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("parallel_ce", [True, False])
def test_forward_and_grads_match_reference(parallel_ce, window):
    jm, tm = _pair(use_parallel_cross_entropy=parallel_ce,
                   sliding_window=window)
    ids, labels = _batch(1)
    jlogits = jm(pt.to_tensor(ids)).numpy()
    tlogits = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(tlogits.detach().numpy(), jlogits,
                               atol=1e-4, rtol=0)
    jloss = jm(pt.to_tensor(ids), pt.to_tensor(labels))
    jloss.backward()
    tloss = tm(torch.from_numpy(ids), torch.from_numpy(labels))
    assert tloss.dtype == torch.float32 and tloss.dim() == 0
    np.testing.assert_allclose(float(tloss.detach()), float(jloss.numpy()),
                               atol=1e-5, rtol=0)
    tloss.backward()
    jgrads = {n: np.asarray(p.grad.numpy())
              for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        assert p.requires_grad and p.grad is not None, n
        _close_normalized(p.grad.numpy(), jgrads[n], 1e-4, n)


def test_losses_and_helpers_match_their_definitions():
    """The two per-token CEs agree, ignored labels give 0, and the mean
    divides by the count of the rest."""
    rng = np.random.RandomState(2)
    logits = torch.from_numpy(rng.randn(2, 5, 11).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 11, (2, 5)))
    labels[1, 1:] = -100
    pce = ParallelCrossEntropy()(logits, labels)
    ce = TF.cross_entropy(logits, labels.unsqueeze(-1), reduction="none")
    assert pce.shape == (2, 5, 1) and ce.shape == (2, 5)
    torch.testing.assert_close(pce[..., 0], ce)
    assert (ce[1, 1:] == 0).all()
    want = ce.sum() / 6
    torch.testing.assert_close(masked_token_mean(ce, labels), want)
    torch.testing.assert_close(
        TF.cross_entropy(logits, labels, reduction="mean"), want)


def test_sgd_train_step_matches_reference():
    """One SGD TrainStep (lr 0.1) leaves params within 1e-5 of the JAX
    TrainStep's, as test_train_step_matches_eager holds the JAX one to
    its eager step."""
    jm, tm = _pair(seed=3)
    ids, labels = _batch(3)
    jstep = JaxTrainStep(jm, pt.optimizer.SGD(
        learning_rate=0.1, parameters=jm.parameters()),
        lambda m, i, l: m(i, l))
    jloss = jstep(pt.to_tensor(ids), pt.to_tensor(labels))
    step = TrainStep(tm, SGD(learning_rate=0.1,
                             parameters=tm.parameters()))
    loss = step(torch.from_numpy(ids), torch.from_numpy(labels))
    assert not loss.requires_grad
    np.testing.assert_allclose(float(loss), float(jloss.numpy()),
                               atol=1e-5, rtol=0)
    want = jax_arrays(jm)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], atol=1e-5,
                                   rtol=0, err_msg=n)


def test_adamw_clip_20_steps_match_reference():
    """20 AdamW steps (lr 1e-3, wd 0.01, global-norm clip 1.0) on fresh
    batches: losses within 1e-4 of the JAX TrainStep at every step.
    Params within 2e-3: Adam's first steps move each weight by about
    lr * sign(g), so a gradient near 0 whose sign the two frameworks'
    summation orders flip moves the weight ~2 lr apart."""
    jm, tm = _pair(seed=4)
    jstep = JaxTrainStep(jm, pt.optimizer.AdamW(
        learning_rate=1e-3, weight_decay=0.01, parameters=jm.parameters(),
        grad_clip=pt.nn.ClipGradByGlobalNorm(1.0)),
        lambda m, i, l: m(i, l))
    step = TrainStep(tm, AdamW(learning_rate=1e-3, weight_decay=0.01,
                               parameters=tm.parameters(),
                               grad_clip=ClipGradByGlobalNorm(1.0)))
    losses = []
    for i in range(20):
        ids, labels = _batch(100 + i)
        jl = float(jstep(pt.to_tensor(ids), pt.to_tensor(labels)).numpy())
        tl = float(step(torch.from_numpy(ids), torch.from_numpy(labels)))
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0,
                                   err_msg=f"step {i}")
        losses.append(tl)
    assert losses[-1] < losses[0]
    want = jax_arrays(jm)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], atol=2e-3,
                                   rtol=0, err_msg=n)


def test_bf16_multi_precision_matches_reference():
    """bf16 params with fp32 masters: over 4 steps on one batch the loss
    falls, params stay bf16, masters and moments are fp32, and the
    losses stay within 2e-2 of JAX (bf16 rounds at other places in the
    two frameworks)."""
    jm, tm = _pair(seed=5, dtype="bfloat16")
    ids, labels = _batch(5)
    jstep = JaxTrainStep(jm, pt.optimizer.AdamW(
        learning_rate=1e-3, parameters=jm.parameters(),
        multi_precision=True), lambda m, i, l: m(i, l))
    opt = AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                multi_precision=True)
    step = TrainStep(tm, opt)
    losses = []
    for i in range(4):
        jl = float(jstep(pt.to_tensor(ids), pt.to_tensor(labels)).numpy())
        tl = float(step(torch.from_numpy(ids), torch.from_numpy(labels)))
        np.testing.assert_allclose(tl, jl, atol=2e-2, rtol=0,
                                   err_msg=f"step {i}")
        losses.append(tl)
    assert losses[-1] < losses[0]
    for p in tm.parameters():
        assert p.dtype == torch.bfloat16
        master = opt._master_weights[id(p)]
        assert master.dtype == torch.float32
        assert all(m.dtype == torch.float32
                   for m in opt._accumulators[id(p)].values())
        # the parameter is its master rounded to bf16
        torch.testing.assert_close(p.detach(), master.to(torch.bfloat16),
                                   atol=0, rtol=0)


def test_optimizer_rules_by_hand():
    """SGD's coupled decay, Adam's per-parameter step count and bias
    correction, AdamW's decay filter, and the clips, against the
    formulas written out."""
    w0 = torch.tensor([1.0, -2.0, 3.0])
    g = torch.tensor([0.5, 0.25, -1.0])

    def run(opt_cls, n=1, **kw):
        p = torch.nn.Parameter(w0.clone())
        opt = opt_cls(parameters=[p], **kw)
        for _ in range(n):
            p.grad = g.clone()
            opt.step()
        return p.detach(), opt

    got, _ = run(SGD, learning_rate=0.1, weight_decay=0.5)
    torch.testing.assert_close(got, w0 - 0.1 * (g + 0.5 * w0))
    got, opt = run(Adam, n=2, learning_rate=0.01)
    w = w0.clone()
    m = v = torch.zeros(3)
    for t in (1, 2):
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        w = w - 0.01 * (m / (1 - 0.9 ** t)) / (
            torch.sqrt(v / (1 - 0.999 ** t)) + 1e-8)
    torch.testing.assert_close(got, w)
    assert list(opt._step_counts.values()) == [2]
    got, _ = run(AdamW, learning_rate=0.01, weight_decay=0.5)
    decayed = w0 * (1 - 0.01 * 0.5)
    torch.testing.assert_close(got, decayed - 0.01 * g / (g.abs() + 1e-8))
    got, _ = run(AdamW, learning_rate=0.01, weight_decay=0.5,
                 apply_decay_param_fun=lambda name: False)
    torch.testing.assert_close(got, w0 - 0.01 * g / (g.abs() + 1e-8))
    p = torch.nn.Parameter(w0.clone())
    q = torch.nn.Parameter(w0.clone())
    pg = [(p, g.clone()), (q, 2 * g.clone())]
    total = torch.sqrt((g ** 2).sum() * 5)
    clipped = ClipGradByGlobalNorm(1.0)(pg)
    torch.testing.assert_close(clipped[0][1], g / total)
    torch.testing.assert_close(clipped[1][1], 2 * g / total)
    clipped = ClipGradByNorm(0.5)(pg)
    torch.testing.assert_close(clipped[0][1], g * 0.5 / g.norm())
    clipped = ClipGradByValue(0.3)(pg)
    torch.testing.assert_close(clipped[0][1], g.clamp(-0.3, 0.3))


def test_serving_after_training_reads_the_new_weights():
    """One AdamW step updates the weights in place; _collect_params
    rebuilds its stack, and generate() and a fresh ServingEngine give
    the tokens of a fresh model loaded with the trained weights."""
    _, tm = _pair(seed=6)
    before = tgen._collect_params(tm)
    stacked_qkv = before["qkv"].clone()
    ids, labels = _batch(6)
    TrainStep(tm, AdamW(learning_rate=1e-2, parameters=tm.parameters()))(
        torch.from_numpy(ids), torch.from_numpy(labels))
    after = tgen._collect_params(tm)
    assert after is not before
    assert not torch.equal(after["qkv"], stacked_qkv)
    torch.testing.assert_close(after["qkv"][0],
                               tm.llama.layers[0].self_attn.qkv_proj.weight
                               .detach(), atol=0, rtol=0)
    fresh = LlamaForCausalLM(tm.config, device="cpu")
    load_jax_weights(fresh, {n: p.detach().numpy()
                             for n, p in tm.named_parameters()})
    prompt = ids[:1, :6]
    want = generate(fresh, prompt, max_new_tokens=6, device="cpu")
    np.testing.assert_array_equal(
        generate(tm, prompt, max_new_tokens=6, device="cpu").numpy(),
        want.numpy())
    eng = ServingEngine(tm, ServingConfig(max_lanes=2, block_size=4,
                                          max_seq_len=16), device="cpu")
    req = eng.submit(prompt[0], max_new_tokens=6)
    np.testing.assert_array_equal(eng.run()[req.request_id],
                                  want.numpy()[0])


def test_llama_options_not_ported_raise():
    tm = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1,
                                           use_parallel_cross_entropy=False,
                                           ce_chunk_size=32), device="cpu")
    ids = torch.zeros(1, 4, dtype=torch.int32)
    assert tm(ids).shape == (1, 4, 128)  # logits need no chunked CE
    # chunked CE is ported now: the chunked loss is the plain one
    plain = TF.cross_entropy(tm(ids).to(torch.float32), ids.long()[..., None],
                             reduction="none").mean()
    torch.testing.assert_close(tm(ids, ids), plain, rtol=1e-6, atol=1e-6)
    # context parallelism is ported now: without a sep group the
    # context-parallel model is the plain one, bit for bit
    cp = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1,
                                           context_parallel=True),
                          device="cpu")
    plain = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                             device="cpu")
    assert torch.equal(cp(ids), plain(ids))
    # MoE trains now; what still raises is the reference's refusal to
    # decode it, in generate() and in the serving engine
    moe = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1,
                                            moe_num_experts=2), device="cpu")
    assert torch.isfinite(moe(ids, ids))
    with pytest.raises(NotImplementedError, match="MoE"):
        tgen.generate(moe, ids, max_new_tokens=2, device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        ServingEngine(moe, ServingConfig(max_seq_len=32), device="cpu")


def test_flops_per_token_is_the_reference_count():
    cfg = dict(vocab_size=32000, hidden_size=1536, intermediate_size=4096,
               num_hidden_layers=12, num_attention_heads=12)
    want = JaxLlama.flops_per_token(
        type("M", (), {"config": JaxLlamaConfig(**cfg)})(), 1024)
    tm = LlamaForCausalLM(LlamaConfig.tiny(**{**cfg, "num_hidden_layers":
                                              1, "vocab_size": 128}),
                          device="cpu")
    tm.config = LlamaConfig(**cfg)
    assert tm.flops_per_token(1024) == want
