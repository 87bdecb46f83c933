"""The port's serving engine held against the JAX package.

- ``BlockPool`` prefix keys and the FCFS scheduler's ``events`` are
  byte-identical to the reference's on seeded traces with prefix sharing
  and preemption (pure host logic, simulated rounds).
- ``ServingEngine`` tokens are identical to the reference
  ``ServingEngine(paged=True)`` and to the port's own ``generate()``:
  fp32 ``LlamaConfig.tiny(num_hidden_layers=2)``, a pool small enough to
  force preemption, a shared prompt prefix, speculation on, with fp32
  pools and with ``kv_int8``; with ``int8_weights`` identical to the
  reference engine's and to ``generate(int8_weights=True)``. On the CPU
  the phases run eagerly and the paged read goes through the kernel
  wrapper's plain version; ``tests/test_torch_gpu.py`` runs the engine
  on CUDA graphs through the CUDA kernels on the card.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving import kv_cache as jkv
from paddle_tpu.serving import scheduler as jsched
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu_torch.models import (
    LlamaConfig, LlamaForCausalLM, generate, load_jax_weights,
)
from paddle_tpu_torch.ops.cuda import paged_attention as pa
from paddle_tpu_torch.serving import (
    NgramDrafter, ServingConfig, ServingEngine,
)
from paddle_tpu_torch.serving import kv_cache as tkv
from paddle_tpu_torch.serving import scheduler as tsched

# -- host logic: byte-identical to the reference ------------------------------


def test_prefix_keys_byte_identical():
    rng = np.random.RandomState(0)
    toks = rng.randint(0, 32000, (103,))
    for limit in (None, 50):
        assert tkv.prefix_keys(toks, 16, limit) \
            == jkv.prefix_keys(toks, 16, limit)


def _sim(mod_sched, mod_kv, seed, n, prefix_len, num_blocks, block_size=2,
         max_lanes=3, max_seq_len=16):
    """The engine's round in pure host logic (the reference tests'
    ``_sim_round_sharing``): one-lane-at-a-time admission with a fake
    prefill that publishes, growth with preemption in FCFS order, one
    emit per lane. Returns the event log and the requests."""
    sched = mod_sched.FCFSScheduler(
        mod_kv.BlockPool(num_blocks, block_size), max_lanes,
        mod_kv.blocks_needed(max_seq_len, block_size), max_seq_len)
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, 100, (prefix_len,))
    reqs = []
    for i in range(n):
        plen = int(rng.randint(1, max_seq_len // 2 - prefix_len))
        new = int(rng.randint(1, max_seq_len - prefix_len - plen + 1))
        prompt = np.concatenate([prefix, rng.randint(0, 100, (plen,))])
        reqs.append(sched.submit(mod_sched.Request(
            prompt, max_new_tokens=new, request_id=i)))

    def emit(req, tok):
        req.output.append(tok)
        if len(req.output) >= req.max_new_tokens:
            sched.finish(req)

    rounds = 0
    while sched.has_work():
        while True:
            batch = sched.admit(limit=1)
            if not batch:
                break
            req = batch[0]
            req.pool_len = len(req.prefill_tokens)
            sched.publish_prefix(req)
            if not req.output:
                emit(req, 0)
        for req in sched.running():
            if req.state == mod_sched.RUNNING:
                sched.ensure_capacity(req)
        for req in sched.running():
            req.pool_len += 1
            emit(req, len(req.output))
        sched.pool.check_invariant()
        rounds += 1
        assert rounds < 10_000, "scheduler livelocked"
    return list(sched.events), reqs


@pytest.mark.parametrize("seed,n,prefix_len,num_blocks", [
    (11, 12, 4, 9),   # sharing engages
    (3, 16, 4, 9),    # sharing under preemption pressure
    (5, 10, 0, 9),    # no shared prefix
])
def test_scheduler_events_byte_identical(seed, n, prefix_len, num_blocks):
    got, reqs = _sim(tsched, tkv, seed, n, prefix_len, num_blocks)
    want, _ = _sim(jsched, jkv, seed, n, prefix_len, num_blocks)
    assert repr(got) == repr(want)
    assert any(e[0] == "preempt" for e in got) or prefix_len
    assert all(r.state == tsched.FINISHED for r in reqs)


def test_ngram_drafter_matches_reference():
    from paddle_tpu.serving import NgramDrafter as JaxNgramDrafter

    rng = np.random.RandomState(4)
    for _ in range(20):
        toks = rng.randint(0, 6, (int(rng.randint(1, 30)),))
        for k in (0, 1, 4):
            np.testing.assert_array_equal(
                NgramDrafter().propose(toks, k),
                JaxNgramDrafter().propose(toks, k))


# -- the engine ---------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    pt.seed(0)
    jm = JaxLlama(JaxLlamaConfig.tiny(num_hidden_layers=2))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=2),
                          device="cpu")
    load_jax_weights(tm, {n: np.asarray(p._data)
                          for n, p in jm.named_parameters()})
    return jm, tm


# the geometry of tests/test_serving.py::test_engine_paged_token_identical
# (3 lanes, block 2, 12 blocks: preemption churn) and a shared prefix
_GEOM = dict(max_lanes=3, block_size=2, num_blocks=12, prefill_chunk=4,
             max_seq_len=20)


def _workload(vocab, seed=5, n=6):
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab, (4,)).astype(np.int32)
    out = []
    for i in range(n):
        tail = rng.randint(0, vocab, (int(rng.randint(1, 4)),))
        # every other request repeats its prompt, so the n-gram drafter
        # has something to propose
        prompt = np.concatenate([prefix, tail, tail if i % 2 else []])
        out.append((prompt.astype(np.int32), int(rng.randint(6, 10))))
    return out


def _serve(engine, work):
    reqs = [engine.submit(p, max_new_tokens=n) for p, n in work]
    outs = engine.run()
    return [outs[r.request_id] for r in reqs]


@pytest.fixture(scope="module", params=[False, True], ids=["f32", "int8"])
def reference_run(request, models):
    """Tokens of the reference engine with the Pallas paged read on."""
    jm, _ = models
    kv_int8 = request.param
    work = _workload(jm.config.vocab_size)
    eng = JaxServingEngine(jm, JaxServingConfig(paged=True, kv_int8=kv_int8,
                                                **_GEOM))
    return kv_int8, work, _serve(eng, work), dict(eng.counters)


@pytest.mark.parametrize("paged", ["auto", "0"])
def test_engine_tokens_identical_to_reference(models, reference_run, paged):
    _, tm = models
    kv_int8, work, want, jcount = reference_run
    eng = ServingEngine(tm, ServingConfig(paged=paged, kv_int8=kv_int8,
                                          **_GEOM), device="cpu")
    assert eng.paged_active is (paged == "auto")
    got = _serve(eng, work)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    c = eng.counters
    # the trace exercised what it claims to
    assert c["preemptions"] > 0 and c["prefix_hit_tokens"] > 0
    assert c["decode_steps"] > 0 and c["verify_steps"] > 0
    assert c["spec_proposed_tokens"] > 0
    # same schedule as the reference, round for round
    for key in ("admits", "preemptions", "prefill_chunks", "decode_steps",
                "verify_steps", "decoded_tokens", "spec_proposed_tokens",
                "spec_accepted_tokens", "prefix_hit_tokens",
                "kv_read_tokens", "kv_quant_tokens"):
        assert c[key] == jcount[key], key


@pytest.mark.parametrize("kv_int8", [False, True])
def test_engine_tokens_identical_to_generate(models, kv_int8):
    _, tm = models
    work = _workload(tm.config.vocab_size, seed=6)
    eng = ServingEngine(tm, ServingConfig(kv_int8=kv_int8, **_GEOM),
                        device="cpu")
    got = _serve(eng, work)
    for (prompt, n), g in zip(work, got):
        want = generate(tm, prompt[None], max_new_tokens=n, kv_int8=kv_int8,
                        device="cpu").numpy()[0]
        np.testing.assert_array_equal(g, want)
    assert eng.scheduler.pool.used_count == 0  # every block came back
    # the CPU wrapper counts no kernel launch
    assert pa.paged_attend.launches == 0
    assert pa.paged_attend_int8.launches == 0


@pytest.mark.parametrize("kv_int8", [False, True])
def test_int8_weight_engine_identical_to_reference_and_generate(models,
                                                                kv_int8):
    jm, tm = models
    work = _workload(tm.config.vocab_size, seed=8)
    jeng = JaxServingEngine(jm, JaxServingConfig(
        paged=True, kv_int8=kv_int8, int8_weights=True, **_GEOM))
    want = _serve(jeng, work)
    eng = ServingEngine(tm, ServingConfig(kv_int8=kv_int8, int8_weights=True,
                                          **_GEOM), device="cpu")
    assert eng.stats()["int8_weights"] is True
    got = _serve(eng, work)
    for i, ((prompt, n), g, w) in enumerate(zip(work, got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
        np.testing.assert_array_equal(
            g, generate(tm, prompt[None], max_new_tokens=n, kv_int8=kv_int8,
                        int8_weights=True, device="cpu").numpy()[0])
    assert eng.counters["preemptions"] > 0
    assert eng.counters["verify_steps"] > 0


def test_submit_takes_lists_arrays_and_tensors(models):
    _, tm = models
    eng = ServingEngine(tm, ServingConfig(max_lanes=2, block_size=4,
                                          max_seq_len=32), device="cpu")
    prompt = [3, 9, 27, 81 % 128, 5]
    reqs = [eng.submit(p, max_new_tokens=4) for p in
            (prompt, np.asarray(prompt), torch.tensor(prompt))]
    outs = eng.run()
    assert eng.stats()["uncollected"] == 0
    assert eng.stats()["decode_rounds"] > 0
    for r in reqs[1:]:
        np.testing.assert_array_equal(outs[r.request_id],
                                      outs[reqs[0].request_id])
    eng.submit(prompt, max_new_tokens=2, request_id="x")
    with pytest.raises(ValueError, match="duplicate"):
        eng.submit(prompt, max_new_tokens=2, request_id="x")


def test_config_env_and_validation(monkeypatch):
    monkeypatch.setenv("PT_SERVE_LANES", "5")
    monkeypatch.setenv("PT_SERVE_PAGED", "0")
    monkeypatch.setenv("PT_SERVE_SPEC_K", "0")
    cfg = ServingConfig()
    assert (cfg.max_lanes, cfg.paged, cfg.spec) == (5, "off", False)
    with pytest.raises(ValueError):
        ServingConfig(spec_k=-1)
    with pytest.raises(ValueError):
        ServingConfig(block_size=0)


def test_engine_default_device_raises_without_gpu(models, monkeypatch):
    _, tm = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(tm)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(tm, ServingConfig(int8_weights=True))
    # int8 weights are ported: on the CPU the engine builds (its tokens
    # are held against the reference above)
    ServingEngine(tm, ServingConfig(int8_weights=True), device="cpu")
