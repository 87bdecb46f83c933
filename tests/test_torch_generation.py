"""The port's Llama model and greedy decode held against the JAX package.

Weights reach the port through ``load_jax_weights`` from the reference
model's arrays, so both sides compute the same function on the same
inputs (fp32, ``LlamaConfig.tiny(num_hidden_layers=2)``, plus a GQA
variant with a sliding window):

- RoPE within 1e-6 and decode logits within 1e-4 (fp32; the two
  frameworks sum in different orders);
- greedy ``generate()`` tokens identical, with and without ``kv_int8``;
- ``quantize_weight_int8`` bit for bit, and ``generate(int8_weights=
  True)`` tokens identical;
- left-padded batches: tokens identical to the reference's, and each
  row identical to its own unpadded call; the mask checks raise the
  reference's errors;
- sampling: handed the Gumbel noise JAX draws for the same keys, the
  port's ``_sample`` and ``generate(do_sample=True)`` give the
  reference's tokens (identical on these seeds: the logits agree within
  1e-4, far from the gaps that decide a draw here);
- the weights loader's name/shape checks and the entry points' device
  default.
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import generate as jax_generate
from paddle_tpu.models import generation as jgen
from paddle_tpu.models import llama as jllama
from paddle_tpu.quantization import quantize_weight_int8 as jax_quantize_w8
from paddle_tpu_torch import resolve_device, to_torch_dtype
from paddle_tpu_torch.models import (
    LlamaConfig, LlamaForCausalLM, generate, load_jax_weights,
)
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.quantization import quantize_weight_int8

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIGS = {
    "mha": dict(num_hidden_layers=2),
    "gqa_window": dict(num_hidden_layers=2, num_key_value_heads=2,
                       sliding_window=6),
}


def jax_arrays(model):
    return {n: np.asarray(p._data) for n, p in model.named_parameters()}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """(jax model, port model on the CPU with the same weights)."""
    kw = CONFIGS[request.param]
    pt.seed(0)
    jm = JaxLlama(JaxLlamaConfig.tiny(**kw))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu")
    load_jax_weights(tm, jax_arrays(jm))
    return jm, tm


def _prompts(vocab, seed, b=2, plen=7):
    return np.random.RandomState(seed).randint(0, vocab, (b, plen)) \
        .astype(np.int32)


def test_parameter_names_and_layout_match_reference(pair):
    jm, tm = pair
    want = {n: tuple(p.shape) for n, p in jm.named_parameters()}
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    assert got == want
    for n, p in tm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      jax_arrays(jm)[n])
    assert tm.model is tm.llama


@pytest.fixture(scope="module")
def mha_arrays():
    pt.seed(1)
    return jax_arrays(JaxLlama(JaxLlamaConfig.tiny(**CONFIGS["mha"])))


def _fresh_port_model():
    return LlamaForCausalLM(LlamaConfig.tiny(**CONFIGS["mha"]),
                            device="cpu")


def test_load_jax_weights_accepts_model_alias(mha_arrays):
    tm = _fresh_port_model()
    arrays = {"model." + n[len("llama."):] if n.startswith("llama.")
              else n: a for n, a in mha_arrays.items()}
    load_jax_weights(tm, arrays)
    for n, p in tm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), mha_arrays[n])


@pytest.mark.parametrize("fault", ["missing", "unexpected", "misshaped"])
def test_load_jax_weights_rejects(mha_arrays, fault):
    tm = _fresh_port_model()
    arrays = dict(mha_arrays)
    before = tm.lm_head.weight.clone()
    if fault == "missing":
        del arrays["llama.norm.weight"]
    elif fault == "unexpected":
        arrays["llama.extra.weight"] = np.zeros(3, np.float32)
    else:
        arrays["lm_head.weight"] = arrays["lm_head.weight"][:, :5]
    with pytest.raises(KeyError if fault != "misshaped" else ValueError):
        load_jax_weights(tm, arrays)
    # nothing is written before every name and shape checked out
    torch.testing.assert_close(tm.lm_head.weight, before, rtol=0, atol=0)


def test_rope_matches_reference():
    rng = np.random.RandomState(0)
    q = rng.randn(2, 5, 4, 16).astype(np.float32)
    k = rng.randn(2, 5, 2, 16).astype(np.float32)
    pos = rng.randint(0, 100, (2, 5)).astype(np.int32)
    for p in (None, pos):
        jq, jk = jllama._rope(jnp.asarray(q), jnp.asarray(k), 10000.0,
                              jnp.float32,
                              pos=None if p is None else jnp.asarray(p))
        tq, tk = tllama._rope(torch.from_numpy(q), torch.from_numpy(k),
                              10000.0, torch.float32,
                              pos=None if p is None else torch.from_numpy(p))
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-6)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_decode_logits_match_reference(pair, kv_int8):
    """Prefill logits and two decode steps' logits within 1e-4."""
    jm, tm = pair
    ids = _prompts(jm.config.vocab_size, seed=1)
    b, plen = ids.shape
    jcfg, tcfg = jgen._GenCfg(jm.config), tgen._GenCfg(tm.config)
    jp, tp = jgen._collect_params(jm), tgen._collect_params(tm)
    nh = jcfg.num_attention_heads
    nkv = jcfg.num_key_value_heads
    shape = (2, b, plen + 2, nkv, jcfg.hidden_size // nh)
    jk = jv = jnp.zeros(shape, jnp.float32)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    step_ids = ids
    for valid in (plen, plen + 1, plen + 2):
        jl, jk, jv = jgen._forward(jp, jnp.asarray(step_ids), jk, jv,
                                   jnp.asarray(valid), jcfg,
                                   kv_int8=kv_int8)
        tl = tgen._forward(tp, torch.from_numpy(step_ids), tk, tv, valid,
                           tcfg, kv_int8=kv_int8)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        step_ids = np.asarray(jnp.argmax(jl, -1), np.int32)[:, None]


@pytest.mark.parametrize("kv_int8", [False, True])
def test_greedy_generate_identical_to_reference(pair, kv_int8):
    jm, tm = pair
    ids = _prompts(jm.config.vocab_size, seed=2, b=3, plen=6)
    want = jax_generate(jm, pt.to_tensor(ids), max_new_tokens=10,
                        kv_int8=kv_int8).numpy()
    got = generate(tm, ids, max_new_tokens=10, kv_int8=kv_int8,
                   device="cpu")
    assert got.dtype == torch.int32 and got.shape == (3, 10)
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_generate_eos_identical_to_reference(pair):
    jm, tm = pair
    ids = _prompts(jm.config.vocab_size, seed=3, b=2, plen=5)
    free = generate(tm, ids, max_new_tokens=8, device="cpu").numpy()
    eos = int(free[0, 2])  # a token row 0 emits early
    want = jax_generate(jm, pt.to_tensor(ids), max_new_tokens=8,
                        eos_token_id=eos).numpy()
    got = generate(tm, torch.from_numpy(ids), max_new_tokens=8,
                   eos_token_id=eos, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, 2:] == eos).all()


def test_collect_params_follows_weight_updates(pair):
    _, tm = pair
    first = tgen._collect_params(tm)
    assert tgen._collect_params(tm) is first
    with torch.no_grad():
        tm.llama.norm.weight.mul_(1.0)  # an in-place write bumps the version
    again = tgen._collect_params(tm)
    assert again is not first
    torch.testing.assert_close(again["norm"], first["norm"])


def test_training_forward_waits_for_the_training_slice(pair):
    """The training slice has landed: the full-sequence forward gives
    finite logits (tests/test_torch_train.py holds them against JAX)."""
    _, tm = pair
    logits = tm(torch.zeros(1, 4, dtype=torch.int32))
    assert logits.shape == (1, 4, tm.config.vocab_size)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("given,want", [
    ("bfloat16", torch.bfloat16), ("float32", torch.float32),
    (np.int32, torch.int32), (np.dtype("int8"), torch.int8),
    (jnp.bfloat16, torch.bfloat16), (torch.float16, torch.float16)])
def test_dtype_names_map_to_torch(given, want):
    assert to_torch_dtype(given) is want


def test_unknown_dtype_and_device_raise():
    with pytest.raises(ValueError):
        to_torch_dtype("complex32")
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")


def test_moe_config_raises():
    """An MoE Llama trains, but neither package decodes it: generate()
    raises in both (the port's engine as well, tests/test_torch_train.py)."""
    cfg = dict(moe_num_experts=8, num_hidden_layers=1)
    ids = np.ones((1, 3), np.int32)
    tm = LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        generate(tm, ids, max_new_tokens=2, device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        jax_generate(JaxLlama(JaxLlamaConfig.tiny(**cfg)), pt.to_tensor(ids),
                     max_new_tokens=2)


@pytest.mark.parametrize("option", ["do_sample", "int8_weights",
                                    "left_pad_mask"])
def test_unported_generate_options_raise(pair, option):
    """The three options that raised before they were ported now run
    (their outputs are held against the reference below); what still
    raises is what the reference refuses too: a mask that is not left
    padding."""
    _, tm = pair
    ids = np.ones((2, 4), np.int32)
    kw = {"do_sample": dict(do_sample=True, top_k=3),
          "int8_weights": dict(int8_weights=True),
          "left_pad_mask": dict(attention_mask=np.array(
              [[0, 1, 1, 1], [1, 1, 1, 1]]))}[option]
    out = generate(tm, ids, max_new_tokens=2, device="cpu", **kw)
    assert out.dtype == torch.int32 and out.shape == (2, 2)
    assert ((out >= 0) & (out < tm.config.vocab_size)).all()
    if option == "left_pad_mask":
        with pytest.raises(ValueError, match="LEFT-padded"):
            generate(tm, ids, max_new_tokens=2, device="cpu",
                     attention_mask=np.array([[1, 0, 1, 1], [1, 1, 1, 1]]))
        # an all-ones mask is no mask
        np.testing.assert_array_equal(
            generate(tm, ids, max_new_tokens=2, device="cpu",
                     attention_mask=np.ones((2, 4), np.int32)).numpy(),
            generate(tm, ids, max_new_tokens=2, device="cpu").numpy())


# -- weight-only int8 ---------------------------------------------------------


def _tie_rich_weights(rng):
    """[2, 16, 8] weights whose scaled values sit exactly on .5: each
    column's max is 127 * 2^-3, so s = 2^-3 and w / s = n + 0.5 exactly
    (round half to even decides); one column all zero (the 1e-12
    clamp)."""
    n = rng.randint(-127, 127, (2, 16, 8)).astype(np.float32) + 0.5
    n[:, 0, :] = 127.0
    n[:, 1, :] = -127.0
    w = n / 8.0
    w[:, :, 3] = 0.0
    return w


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_quantize_weight_int8_bit_identical(kind):
    rng = np.random.RandomState(11)
    w = rng.randn(3, 24, 10).astype(np.float32) * 0.02 if kind == "random" \
        else _tie_rich_weights(rng)
    want = jax_quantize_w8(jnp.asarray(w))
    got = quantize_weight_int8(torch.from_numpy(w))
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    assert got["s"].shape == w.shape[:-2] + (1, w.shape[-1])
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))


def test_int8_weight_generate_identical_to_reference(pair):
    jm, tm = pair
    ids = _prompts(jm.config.vocab_size, seed=4, b=3, plen=6)
    want = jax_generate(jm, pt.to_tensor(ids), max_new_tokens=10,
                        int8_weights=True).numpy()
    got = generate(tm, ids, max_new_tokens=10, int8_weights=True,
                   device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    packs = tgen._collect_params(tm, int8_weights=True)
    assert set(k for k, v in packs.items() if isinstance(v, dict)) \
        == {"qkv", "o", "gate_up", "down", "lm_head"}
    # the flag is part of the cache key
    assert tgen._collect_params(tm) is not packs
    assert tgen._collect_params(tm)["qkv"].dtype == torch.float32


# -- left padding -------------------------------------------------------------

_MASK = np.array([[0, 0, 1, 1, 1, 1, 1],
                  [1, 1, 1, 1, 1, 1, 1],
                  [0, 0, 0, 0, 0, 1, 1]], np.int32)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_left_padded_generate_identical_to_reference(pair, kv_int8):
    jm, tm = pair
    ids = _prompts(jm.config.vocab_size, seed=5, b=3, plen=7)
    ids = np.where(_MASK == 1, ids, 0).astype(np.int32)
    want = jax_generate(jm, pt.to_tensor(ids), max_new_tokens=8,
                        attention_mask=_MASK, kv_int8=kv_int8).numpy()
    got = generate(tm, ids, max_new_tokens=8, attention_mask=_MASK,
                   kv_int8=kv_int8, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    for row, npad in enumerate((~_MASK.astype(bool)).sum(axis=1)):
        alone = generate(tm, ids[row:row + 1, npad:], max_new_tokens=8,
                         kv_int8=kv_int8, device="cpu").numpy()[0]
        np.testing.assert_array_equal(got[row], alone, err_msg=f"row {row}")


@pytest.mark.parametrize("mask", [
    np.ones((2, 5), np.int32),                  # wrong shape
    np.array([[1, 1, 1, 0], [1, 1, 1, 1]]),     # right padding
    np.array([[0, 1, 0, 1], [1, 1, 1, 1]]),     # interior zero
], ids=["shape", "right_pad", "interior"])
def test_mask_validation_raises_reference_errors(pair, mask):
    jm, tm = pair
    ids = np.ones((2, 4), np.int32)
    with pytest.raises(ValueError) as want:
        jax_generate(jm, pt.to_tensor(ids), max_new_tokens=2,
                     attention_mask=mask)
    with pytest.raises(ValueError) as got:
        generate(tm, ids, max_new_tokens=2, attention_mask=mask,
                 device="cpu")
    assert str(got.value) == str(want.value)


# -- sampling -----------------------------------------------------------------

_SAMPLING = {
    "temperature": dict(temperature=1.0),
    "cold_top_k": dict(temperature=0.7, top_k=5),
    "hot_top_p": dict(temperature=1.3, top_p=0.8),
    "top_k_top_p": dict(temperature=0.5, top_k=20, top_p=0.5),
    "top_k_past_vocab": dict(top_k=10_000),
}


def _jax_noise(seed):
    """A stand-in for the port's ``_gumbel`` that returns the noise
    ``_generate_jit`` draws: the key split once per sampled token, the
    Gumbel draw ``jax.random.categorical`` makes from each subkey."""
    state = [jax.random.key(seed)]

    def draw(shape, generator, device):
        state[0], sub = jax.random.split(state[0])
        return torch.from_numpy(np.asarray(
            jax.random.gumbel(sub, tuple(shape), jnp.float32)))

    return draw


@pytest.mark.parametrize("setting", sorted(_SAMPLING))
def test_sampled_generate_identical_to_reference(pair, setting,
                                                 monkeypatch):
    jm, tm = pair
    kw = _SAMPLING[setting]
    ids = _prompts(jm.config.vocab_size, seed=6, b=3, plen=6)
    want = jax_generate(jm, pt.to_tensor(ids), max_new_tokens=10,
                        do_sample=True, seed=3, **kw).numpy()
    monkeypatch.setattr(tgen, "_gumbel", _jax_noise(3))
    got = generate(tm, ids, max_new_tokens=10, do_sample=True, seed=3,
                   device="cpu", **kw).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("setting", sorted(_SAMPLING) + ["tiny_top_p",
                                                         "top_k_1"])
def test_sample_matches_reference_sample(setting):
    """``_sample`` on the same fp32 logits and JAX's noise for the same
    key: the reference's token, row by row."""
    kw = dict(_SAMPLING.get(setting, {}))
    kw.update({"tiny_top_p": dict(top_p=1e-6), "top_k_1": dict(top_k=1)}
              .get(setting, {}))
    rng = np.random.RandomState(7)
    logits = (rng.randn(16, 64) * 3).astype(np.float32)
    key = jax.random.key(9)
    args = dict(do_sample=True, temperature=kw.get("temperature", 1.0),
                top_k=min(kw.get("top_k", 0), 64), top_p=kw.get("top_p", 1.0),
                use_top_p=kw.get("top_p", 1.0) < 1.0)
    want = np.asarray(jgen._sample(
        jnp.asarray(logits), key, args["do_sample"],
        jnp.float32(args["temperature"]), args["top_k"],
        jnp.float32(args["top_p"]), args["use_top_p"]))
    noise = torch.from_numpy(np.asarray(
        jax.random.gumbel(key, logits.shape, jnp.float32)))
    got = tgen._sample(torch.from_numpy(logits), None, noise=noise, **args)
    np.testing.assert_array_equal(got.numpy(), want)
    if setting in ("tiny_top_p", "top_k_1"):  # one survivor: greedy
        np.testing.assert_array_equal(got.numpy(), logits.argmax(-1))


def test_sampling_seed_and_generator(pair):
    """The port's own draws: the same seed twice gives the same tokens,
    an explicit generator seeded alike gives them too, and the filters
    that leave one token give the greedy tokens."""
    _, tm = pair
    ids = _prompts(tm.config.vocab_size, seed=8, b=2, plen=5)
    run = functools.partial(generate, tm, ids, max_new_tokens=12,
                            device="cpu")
    a = run(do_sample=True, seed=4).numpy()
    np.testing.assert_array_equal(run(do_sample=True, seed=4).numpy(), a)
    np.testing.assert_array_equal(
        run(do_sample=True, seed=99,
            generator=torch.Generator().manual_seed(4)).numpy(), a)
    greedy = run().numpy()
    np.testing.assert_array_equal(run(do_sample=True, top_k=1).numpy(),
                                  greedy)
    np.testing.assert_array_equal(run(do_sample=True, top_p=1e-6).numpy(),
                                  greedy)


def test_default_device_raises_without_gpu(pair, monkeypatch):
    _, tm = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(tm, np.ones((1, 3), np.int32), max_new_tokens=2)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, imported in a fresh interpreter, leaves
    neither ``jax`` nor ``paddle_tpu`` in ``sys.modules``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import paddle_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'paddle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu'))\n"
        "assert not bad, bad\n"
        "print(' '.join(n for n in sys.modules "
        "if n.startswith('paddle_tpu_torch')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 15  # every module was imported
    # the train path's subpackages and modules are among them
    assert {"paddle_tpu_torch.hapi.model", "paddle_tpu_torch.hapi.callbacks",
            "paddle_tpu_torch.io.reader", "paddle_tpu_torch.metric",
            "paddle_tpu_torch.amp.grad_scaler",
            "paddle_tpu_torch.monitor.numerics",
            "paddle_tpu_torch.optimizer.lbfgs",
            "paddle_tpu_torch.tensor"} <= names
    # and the distributed slice's
    assert {"paddle_tpu_torch.distributed.env",
            "paddle_tpu_torch.distributed.store",
            "paddle_tpu_torch.distributed.collective",
            "paddle_tpu_torch.distributed.parallel",
            "paddle_tpu_torch.distributed.shard",
            "paddle_tpu_torch.distributed.fleet",
            "paddle_tpu_torch.distributed.fleet.base.topology",
            "paddle_tpu_torch.distributed.fleet.base.distributed_strategy",
            "paddle_tpu_torch.distributed.fleet.base.role_maker",
            "paddle_tpu_torch.distributed.fleet.meta_parallel."
            "parallel_layers.mp_layers",
            "paddle_tpu_torch.distributed.fleet.meta_parallel."
            "parallel_layers.random",
            "paddle_tpu_torch.distributed.fleet.utils."
            "sequence_parallel_utils",
            "paddle_tpu_torch.distributed.fleet.utils.recompute"} <= names
    # and the pipeline's and context parallelism's
    assert {"paddle_tpu_torch.distributed.fleet.meta_parallel."
            "parallel_layers.pp_layers",
            "paddle_tpu_torch.distributed.fleet.meta_parallel."
            "pipeline_parallel",
            "paddle_tpu_torch.ops.ring_attention",
            "paddle_tpu_torch.ops.ulysses_attention",
            "paddle_tpu_torch.models.llama",
            "paddle_tpu_torch.models.ernie"} <= names
    # and the experts', ZeRO's and the checkpoints'
    assert {"paddle_tpu_torch.incubate",
            "paddle_tpu_torch.incubate.distributed.models.moe.moe_layer",
            "paddle_tpu_torch.distributed.sharding",
            "paddle_tpu_torch.distributed.sharding.group_sharded",
            "paddle_tpu_torch.distributed.checkpoint",
            "paddle_tpu_torch.framework.io"} <= names
    # and the vision path's
    assert {"paddle_tpu_torch.nn.initializer",
            "paddle_tpu_torch.nn.layer.layers",
            "paddle_tpu_torch.nn.layer.common",
            "paddle_tpu_torch.nn.layer.activation",
            "paddle_tpu_torch.nn.layer.conv",
            "paddle_tpu_torch.nn.layer.norm",
            "paddle_tpu_torch.nn.layer.pooling",
            "paddle_tpu_torch.nn.layer.loss",
            "paddle_tpu_torch.nn.functional.conv",
            "paddle_tpu_torch.nn.functional.pooling",
            "paddle_tpu_torch.vision",
            "paddle_tpu_torch.vision.models.resnet",
            "paddle_tpu_torch.vision.models.lenet"} <= names
    # and the nn layer surface's
    assert {"paddle_tpu_torch.nn.layer.transformer",
            "paddle_tpu_torch.nn.layer.rnn"} <= names
    # chip_smoke.py (run where there is no jax) imports neither either
    import ast

    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
    imported |= {n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
    assert not {m for m in imported
                if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")}
