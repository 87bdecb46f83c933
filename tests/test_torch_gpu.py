"""The port's CUDA kernels and engine on the card.

Every test here is marked ``gpu`` and skips where no CUDA device is
present (the decision is made in the ``cuda`` fixture, never at import).
This file imports neither ``jax`` nor ``paddle_tpu``, so it runs on a
machine that has only PyTorch for CUDA::

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest

(``--noconftest``: the suite's conftest sets up JAX.) The CPU files
``tests/test_torch_*.py`` hold the plain versions used here against the
JAX package.
"""
import gc
import math

import numpy as np
import pytest
import torch

import torch_functional_cases as fcases  # the JAX-free tables
import torch_layer_cases as lcases
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.jit import TrainStep, exec_cache
from paddle_tpu_torch.models import (
    BertConfig, BertForMaskedLM, ErnieConfig, ErnieForPretraining,
    LlamaConfig, LlamaForCausalLM, generate, load_jax_weights,
)
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import head_flash as hf
from paddle_tpu_torch.ops.cuda import paged_attention as pa
from paddle_tpu_torch.nn.functional import attention as tattn
from paddle_tpu_torch.optimizer import AdamW, Lamb
from paddle_tpu_torch.quantization import quantize_kv
from paddle_tpu_torch.serving import ServingConfig, ServingEngine

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, lanes, m, b, nkv, g, d, pos, device):
    rng = np.random.RandomState(seed)
    nh = nkv * g
    q = rng.randn(lanes, nh, d).astype(np.float32)
    kpool = rng.randn(lanes * m + 1, b, nkv, d).astype(np.float32)
    vpool = rng.randn(lanes * m + 1, b, nkv, d).astype(np.float32)
    # one lane's blocks scattered over the pool; lane 0 is idle (pos 0,
    # table row of null block 0)
    tables = rng.permutation(lanes * m).astype(np.int32).reshape(lanes, m) + 1
    tables[0] = 0
    pos = np.asarray(pos, np.int32)
    return [torch.from_numpy(a).to(device)
            for a in (q, kpool, vpool, tables, pos)]


# kernel against plain version on the same card: fp32 within 2e-5
# (summation order only); bf16 outputs within 2e-2 (one bf16 rounding of
# an O(1) value is up to 2^-8, plus fp32 order differences)
_SHAPES = [
    # (lanes, M, B, nkv, g, d, pos)
    (4, 4, 8, 2, 2, 16, [0, 5, 11, 31]),
    (8, 32, 16, 12, 1, 128, [0, 1, 15, 16, 100, 255, 300, 511]),
    (8, 32, 16, 4, 3, 128, [0, 17, 64, 128, 200, 333, 480, 511]),
    # 8 query heads per block at d 256: the largest shared-memory carve-up
    (2, 3, 64, 2, 8, 256, [0, 191]),
    # live ranges that end (and, with the window, start) exactly on the
    # edges of 32-, 64- and 128-slot splits (fp32, bf16 and int8 pools at
    # d 128 split so on the card)
    (8, 32, 16, 12, 1, 128, [31, 63, 64, 127, 128, 255, 256, 511]),
    # chip_smoke.py's long-context shape: 2048 slots, up to 32 splits
    (8, 128, 16, 12, 1, 128, [0, 300, 700, 1023, 1300, 1600, 1900, 2047]),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("shape", _SHAPES)
def test_paged_attend_matches_plain(cuda, shape, window, dtype):
    lanes, m, b, nkv, g, d, pos = shape
    q, kp, vp, tab, ps = _inputs(6, lanes, m, b, nkv, g, d, pos, cuda)
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    n = pa.paged_attend.launches
    got = pa.paged_attend(q, kp, vp, tab, ps, window=window)
    torch.cuda.synchronize()
    assert pa.paged_attend.launches == n + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = pa.paged_attend_ref(q, kp, vp, tab, ps, window=window)
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("shape", _SHAPES)
def test_paged_attend_int8_matches_plain(cuda, shape, window, dtype):
    lanes, m, b, nkv, g, d, pos = shape
    q, kp, vp, tab, ps = _inputs(7, lanes, m, b, nkv, g, d, pos, cuda)
    kq, ks = quantize_kv(kp)
    vq, vs = quantize_kv(vp)
    q = q.to(dtype)
    n = pa.paged_attend_int8.launches
    got = pa.paged_attend_int8(q, kq, vq, ks, vs, tab, ps, window=window)
    torch.cuda.synchronize()
    assert pa.paged_attend_int8.launches == n + 1
    want = pa.paged_attend_int8_ref(q, kq, vq, ks, vs, tab, ps,
                                    window=window)
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_kernels_bit_identical(cuda, quant):
    """The splits merge in a fixed order: two calls give the same bits."""
    q, kp, vp, tab, ps = _inputs(9, *_SHAPES[-1][:6], _SHAPES[-1][6], cuda)
    q = q.to(torch.bfloat16)
    if quant:
        (kq, ks), (vq, vs) = quantize_kv(kp), quantize_kv(vp)
        pools = (kq, vq, ks, vs)
        fn = pa.paged_attend_int8
    else:
        pools = (kp.to(torch.bfloat16), vp.to(torch.bfloat16))
        fn = pa.paged_attend
    a = fn(q, *pools, tab, ps, window=300)
    b = fn(q, *pools, tab, ps, window=300)
    c = fn(q, *pools, tab, ps)
    d = fn(q, *pools, tab, ps)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(c, d)


# a tensor-parallel rank's heads at the served geometry (12 q heads of d
# 128, 8 lanes, 512 slots), (kv heads, mp, rank): the 0.44B Llama at mp
# 2 (6 q and 6 kv heads a rank), and 12 q heads over 3 and over 1 kv
# heads, whose ranks read their kv heads through an offset (rank 1 of
# 12 over 3: kv heads 1, 1, 2, 2, 2, 2, offset 2), and at mp 8, which
# does not divide the 12 heads: the first 4 ranks hold 2, the others 1
_RANK_HEADS = [(12, 2, 0), (12, 2, 1), (3, 2, 0), (3, 2, 1), (1, 2, 1),
               (12, 8, 0), (12, 8, 7), (3, 8, 5)]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("heads", _RANK_HEADS)
def test_paged_kernels_at_a_rank_heads(cuda, heads, dtype, quant):
    """Kernels 7 and 8 on one rank's q heads over a pool of the kv heads
    they read: each launches once, and matches its plain version on the
    rank's heads and the slice of the plain version over every head
    (bf16 within 2e-2; float16 within two ulps, ``_fp16_over``; fp32,
    where only the order of the sums differs, within 1e-4)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers \
        .mp_layers import rank_heads

    nkv, mp, rank = heads
    g = 12 // nkv
    q, kp, vp, tab, ps = _inputs(13, 8, 32, 16, nkv, g, 128,
                                 [0, 17, 64, 128, 200, 333, 480, 511], cuda)
    n, q0 = rank_heads(12, mp, rank)
    lo, hi = q0 // g, (q0 + n - 1) // g
    q = q.to(dtype)
    mine = slice(q0, q0 + n)
    ql = q[:, mine].contiguous()
    kl, vl = (t[:, :, lo:hi + 1].contiguous() for t in (kp, vp))
    hmap = dict(kv_group=g, head_offset=q0 - lo * g)
    if quant:
        fn, ref = pa.paged_attend_int8, pa.paged_attend_int8_ref
        (kq, ks), (vq, vs) = quantize_kv(kl), quantize_kv(vl)
        local = (ql, kq, vq, ks, vs, tab, ps)
        whole = (q, *quantize_kv(kp)[:1], *quantize_kv(vp)[:1],
                 quantize_kv(kp)[1], quantize_kv(vp)[1], tab, ps)
    else:
        fn, ref = pa.paged_attend, pa.paged_attend_ref
        kl, vl, kp, vp = (t.to(dtype) for t in (kl, vl, kp, vp))
        local = (ql, kl, vl, tab, ps)
        whole = (q, kp, vp, tab, ps)
    before = fn.launches
    got = fn(*local, **hmap)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.dtype == dtype and got.shape == ql.shape
    for want in (ref(*local, **hmap), ref(*whole)[:, mine]):
        if dtype == torch.float16:
            assert _fp16_over(got, want) <= 1
        else:
            atol = 1e-4 if dtype == torch.float32 else 2e-2
            torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                       rtol=0)


def test_wrapper_rejects_a_cpu_cuda_mix(cuda):
    q, kp, vp, tab, pos = _inputs(8, 4, 4, 8, 2, 2, 16, [0, 5, 11, 31],
                                  cuda)
    with pytest.raises(ValueError):
        pa.paged_attend(q, kp.cpu(), vp, tab, pos)


def _workload(vocab, seed, n=6):
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab, (4,)).astype(np.int32)
    out = []
    for i in range(n):
        tail = rng.randint(0, vocab, (int(rng.randint(1, 4)),))
        prompt = np.concatenate([prefix, tail, tail if i % 2 else []])
        out.append((prompt.astype(np.int32), int(rng.randint(6, 10))))
    return out


@pytest.mark.parametrize("kv_int8", [False, True])
def test_engine_launches_kernels_and_matches_generate(cuda, kv_int8):
    """The decode rounds go through the CUDA kernels, one launch per
    layer per plain decode round, and the fp32 engine's tokens equal the
    port's own greedy generate() under preemption churn."""
    tm = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=2),
                          device=cuda,
                          generator=torch.Generator(cuda).manual_seed(0))
    work = _workload(tm.config.vocab_size, seed=7)
    eng = ServingEngine(tm, ServingConfig(
        max_lanes=3, block_size=2, num_blocks=12, prefill_chunk=4,
        max_seq_len=20, kv_int8=kv_int8), device=cuda)
    wrapper = pa.paged_attend_int8 if kv_int8 else pa.paged_attend
    wrapper.launches = 0
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in work]
    outs = eng.run()
    assert eng.counters["decode_steps"] > 0
    assert eng.counters["preemptions"] > 0
    assert wrapper.launches == 2 * eng.counters["decode_steps"]
    for r, (prompt, n) in zip(reqs, work):
        want = generate(tm, prompt[None], max_new_tokens=n,
                        kv_int8=kv_int8, device=cuda).cpu().numpy()[0]
        np.testing.assert_array_equal(outs[r.request_id], want)


# -- the engine on CUDA graphs ------------------------------------------------

# 3 lanes of 8 blocks of 4 slots, prefill chunk 8, speculation k 4
_GRAPH_GEOM = dict(max_lanes=3, block_size=4, max_seq_len=32,
                   prefill_chunk=8)


def _tiny_llama(device, dtype="float32", seed=0):
    return LlamaForCausalLM(
        LlamaConfig.tiny(num_hidden_layers=2, dtype=dtype), device=device,
        generator=torch.Generator(device).manual_seed(seed))


def _phase_inputs(eng, phase, rng):
    """Round inputs that exercise every write rule: lanes 0 and 1 live on
    private blocks, lane 2 idle on null block 0; the prefill chunk has a
    padded tail; the verify drafts stop short of k (wlimit)."""
    L, M = eng.config.max_lanes, eng.blocks_per_lane
    C, V = eng.config.prefill_chunk, eng.model.config.vocab_size
    tables = np.zeros((L, M), np.int32)
    tables[:2] = 1 + np.arange(2 * M).reshape(2, M)
    if phase == "decode":
        return dict(tables=tables, cur_len=[13, 30, 0],
                    last_tok=rng.randint(0, V, (L,)))
    if phase == "prefill":
        return dict(table=tables[:1], ids=rng.randint(0, V, (1, C)),
                    start=8, ctx_len=13, last_idx=4)
    K = eng.config.spec_k
    return dict(tables=tables, cur_len=[10, 20, 0],
                toks=rng.randint(0, V, (L, K + 1)), wlimit=[13, 25, 0])


def _fill_pools(eng, gen):
    """Random pool contents (null block included), as written K/V."""
    for t in (eng._kpool, eng._vpool):
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, device=t.device,
                                  generator=gen, dtype=torch.int8))
        else:
            t.copy_(torch.randn(t.shape, device=t.device, generator=gen))
    for t in (eng._kscale, eng._vscale):
        if t is not None:
            t.copy_(torch.rand(t.shape, device=t.device, generator=gen)
                    * 0.05)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["pool", "int8pool"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("phase", ["decode", "prefill", "verify"])
def test_graph_phase_matches_eager(cuda, phase, dtype, kv_int8):
    """Each captured phase replayed against an eager call of the same
    phase program on the same inputs and pools, on the live lanes (0 and
    1; the idle lane reads null block 0, where idle lanes' and pads'
    writes race by design, and the engine drops its output). fp32:
    tokens, logits and every pool slot outside block 0 (the live slots)
    bit-identical. bf16: logits within 1e-2 of their largest magnitude
    (one bf16 rounding is 2^-8 ~ 4e-3; the same kernels run, so only a
    matmul algorithm picked otherwise under capture could move them),
    and tokens equal where the eager logits' top two differ by more
    than that limit."""
    eng = ServingEngine(_tiny_llama(cuda, dtype), ServingConfig(
        kv_int8=kv_int8, **_GRAPH_GEOM), device=cuda)
    eng.warmup()
    assert eng.stats()["graphs"] and sorted(eng._graphs) == [
        "decode", "prefill", "verify"]
    gen = torch.Generator(cuda).manual_seed(3)
    _fill_pools(eng, gen)
    pools = [t for t in (eng._kpool, eng._vpool, eng._kscale, eng._vscale)
             if t is not None]
    before = [t.clone() for t in pools]
    flat = eng._pack(phase, **_phase_inputs(eng, phase,
                                            np.random.RandomState(4)))
    entry = eng._graphs[phase]
    entry.inputs["flat"].copy_(torch.from_numpy(flat))
    tok_g, logits_g = (t.clone() for t in entry.replay())
    after_g = [t.clone() for t in pools]
    for t, b in zip(pools, before):
        t.copy_(b)
    tok_e, logits_e = eng._programs[phase](
        flat=torch.from_numpy(flat).to(cuda), **eng._state)
    torch.cuda.synchronize()
    if phase != "prefill":  # the live lanes
        tok_g, logits_g, tok_e, logits_e = (
            t[:2] for t in (tok_g, logits_g, tok_e, logits_e))
    for got, want, old in zip(after_g, pools, before):
        assert not torch.equal(got[:, 1:], old[:, 1:])  # live writes
        if dtype == "float32":
            assert torch.equal(got[:, 1:], want[:, 1:])
    if dtype == "float32":
        assert torch.equal(tok_g, tok_e)
        assert torch.equal(logits_g, logits_e)
        return
    scale = logits_e.abs().max()
    assert (logits_g - logits_e).abs().max() <= 1e-2 * scale
    top2 = logits_e.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-2 * scale
    assert torch.equal(tok_g[clear], tok_e[clear])


def test_phase_writes_reach_the_live_slots(cuda):
    """The decode replay writes each live lane's K/V at its position and
    nothing else outside null block 0."""
    eng = ServingEngine(_tiny_llama(cuda), ServingConfig(**_GRAPH_GEOM),
                        device=cuda)
    eng.warmup()
    _fill_pools(eng, torch.Generator(cuda).manual_seed(5))
    before = eng._kpool.clone()
    eng._run("decode", **_phase_inputs(eng, "decode",
                                       np.random.RandomState(6)))
    torch.cuda.synchronize()
    changed = (eng._kpool != before).flatten(3).any(-1)  # [layers, blk, off]
    B, M = eng.config.block_size, eng.blocks_per_lane
    want = torch.zeros_like(changed)
    for lane, cur in ((0, 13), (1, 30)):
        want[:, 1 + lane * M + cur // B, cur % B] = True
    assert torch.equal(changed[:, 1:], want[:, 1:])


def test_second_engine_hits_the_cache(cuda):
    """A second engine of the same geometry on the same model takes the
    first one's pools once it is collected, so its graph keys equal the
    first one's: it captures nothing and serves the same tokens."""
    tm = _tiny_llama(cuda)
    work = _workload(tm.config.vocab_size, seed=9)
    first = ServingEngine(tm, ServingConfig(**_GRAPH_GEOM), device=cuda)
    hits = exec_cache.stats()["hits"]
    first.warmup()
    assert first.counters["graph_captures"] + \
        exec_cache.stats()["hits"] - hits == 3
    reqs = [first.submit(p, max_new_tokens=n) for p, n in work]
    outs = first.run()
    want = [outs[r.request_id] for r in reqs]
    del first, reqs, outs
    gc.collect()
    captures, hits = exec_cache.stats()["captures"], \
        exec_cache.stats()["hits"]
    second = ServingEngine(tm, ServingConfig(**_GRAPH_GEOM), device=cuda)
    second.warmup()
    assert second.counters["graph_captures"] == 0
    assert exec_cache.stats()["captures"] == captures
    assert exec_cache.stats()["hits"] == hits + 3
    reqs = [second.submit(p, max_new_tokens=n) for p, n in work]
    outs = second.run()
    for r, w in zip(reqs, want):
        np.testing.assert_array_equal(outs[r.request_id], w)


def test_uncapturable_phase_raises(cuda):
    """A phase that syncs with the host (``.item()``) cannot be captured:
    get_or_capture raises naming it, the caller's stream is current
    again, and later captures and eager work go on."""
    def phase(x):
        return x * float((x + 1).sum().item())

    x = torch.ones(4, device=cuda)
    stream = torch.cuda.current_stream(cuda)
    with pytest.raises(RuntimeError, match="bad_phase"):
        exec_cache.get_or_capture({"kind": "bad_phase"}, phase, {"x": x},
                                  label="bad_phase")
    assert torch.cuda.current_stream(cuda) == stream
    torch.testing.assert_close((x * 2).sum().item(), 8.0)
    entry = exec_cache.get_or_capture({"kind": "good_phase"},
                                      lambda x: x * 3, {"x": x},
                                      label="good_phase")
    x.fill_(2.0)
    torch.testing.assert_close(entry.replay().sum().item(), 24.0)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_graph_replays_and_paged_launches(cuda, kv_int8):
    """On graphs: one replay per prefill chunk and per round, and the
    paged kernel counted once per layer per decode replay."""
    tm = _tiny_llama(cuda)
    eng = ServingEngine(tm, ServingConfig(
        max_lanes=3, block_size=2, num_blocks=12, prefill_chunk=4,
        max_seq_len=20, kv_int8=kv_int8), device=cuda)
    eng.warmup()
    wrapper = pa.paged_attend_int8 if kv_int8 else pa.paged_attend
    wrapper.launches = 0
    for p, n in _workload(tm.config.vocab_size, seed=10):
        eng.submit(p, max_new_tokens=n)
    eng.run()
    c = eng.counters
    assert c["decode_steps"] > 0 and c["verify_steps"] > 0
    assert c["graph_replays"] == c["decode_steps"] + c["verify_steps"] \
        + c["prefill_chunks"]
    assert wrapper.launches == tm.config.num_hidden_layers \
        * c["decode_steps"]


@pytest.mark.parametrize("kv_int8", [False, True])
def test_int8_weight_engine_matches_generate(cuda, kv_int8):
    tm = _tiny_llama(cuda)
    work = _workload(tm.config.vocab_size, seed=11)
    eng = ServingEngine(tm, ServingConfig(
        max_lanes=3, block_size=2, num_blocks=12, prefill_chunk=4,
        max_seq_len=20, kv_int8=kv_int8, int8_weights=True), device=cuda)
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in work]
    outs = eng.run()
    assert eng.counters["graph_captures"] + eng.counters["graph_replays"] \
        > 0 and eng.counters["preemptions"] > 0
    for r, (prompt, n) in zip(reqs, work):
        want = generate(tm, prompt[None], max_new_tokens=n, kv_int8=kv_int8,
                        int8_weights=True, device=cuda).cpu().numpy()[0]
        np.testing.assert_array_equal(outs[r.request_id], want)


def test_left_padded_generate_card_equals_cpu(cuda):
    cpu = _tiny_llama("cpu")
    card = LlamaForCausalLM(cpu.config, device=cuda)
    load_jax_weights(card, {n: p.detach().numpy()
                            for n, p in cpu.named_parameters()})
    rng = np.random.RandomState(12)
    mask = np.array([[0, 0, 1, 1, 1, 1, 1], [1, 1, 1, 1, 1, 1, 1],
                     [0, 0, 0, 0, 0, 1, 1]], np.int32)
    ids = np.where(mask == 1, rng.randint(0, 128, mask.shape), 0)
    for kw in ({}, {"int8_weights": True}, {"kv_int8": True}):
        want = generate(cpu, ids, max_new_tokens=10, attention_mask=mask,
                        device="cpu", **kw).numpy()
        got = generate(card, ids, max_new_tokens=10, attention_mask=mask,
                       device=cuda, **kw).cpu().numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(kw))


def _chi2_critical(df, z=3.0902):
    """The chi-square quantile at 1 - 1e-3 (z of the normal), by
    Wilson and Hilferty's approximation."""
    return df * (1 - 2 / (9 * df) + z * math.sqrt(2 / (9 * df))) ** 3


@pytest.mark.parametrize("kw", [dict(temperature=0.8, top_k=20),
                                dict(temperature=1.2, top_p=0.9),
                                dict(temperature=1.0, top_k=30, top_p=0.95)],
                         ids=["top_k", "top_p", "both"])
def test_sampling_statistics(cuda, kw):
    """10^4 draws of ``_sample`` on the card from one row of logits: the
    support equals the filtered set (every kept token drawn, no other),
    and the counts pass a chi-square test against the filtered softmax
    over the tokens of p > 1e-3 at significance 1e-3."""
    n, vocab = 10_000, 64
    rng = np.random.RandomState(13)
    row = torch.from_numpy((rng.randn(vocab) * 2).astype(np.float32))
    logits = row.to(cuda)[None].expand(n, vocab).contiguous()
    gen = torch.Generator(cuda).manual_seed(14)
    args = dict(do_sample=True, temperature=kw["temperature"],
                top_k=kw.get("top_k", 0), top_p=kw.get("top_p", 1.0),
                use_top_p=kw.get("top_p", 1.0) < 1.0)
    draws = tgen._sample(logits, gen, **args).cpu().numpy()
    # the filtered distribution, from the plain rule on the CPU
    filt = tgen._sample(row[None], None, noise=torch.zeros(1, vocab),
                        **{**args, "do_sample": True})
    scaled = row / kw["temperature"]
    keep = torch.ones(vocab, dtype=torch.bool)
    if args["top_k"]:
        keep &= scaled >= scaled.topk(args["top_k"]).values[-1]
    if args["use_top_p"]:
        srt = scaled[keep].sort(descending=True).values
        cum = torch.cumsum(torch.softmax(srt, 0), 0)
        cut = srt[min(int((cum < args["top_p"]).sum()), srt.numel() - 1)]
        keep &= scaled >= cut
    assert keep[int(filt)]
    p = torch.softmax(torch.where(keep, scaled, torch.tensor(-1e30)), 0)
    p = p.double().numpy()
    counts = np.bincount(draws, minlength=vocab)
    assert set(np.flatnonzero(counts)) == set(np.flatnonzero(keep.numpy()))
    big = p > 1e-3
    expect = p[big] * n
    stat = float(((counts[big] - expect) ** 2 / expect).sum())
    assert stat < _chi2_critical(int(big.sum()) - 1), stat


def test_sampling_seed_and_greedy_limits_on_the_card(cuda):
    tm = _tiny_llama(cuda)
    ids = np.random.RandomState(15).randint(0, 128, (2, 5))
    run = lambda **kw: generate(tm, ids, max_new_tokens=12, device=cuda,
                                **kw).cpu().numpy()  # noqa: E731
    a = run(do_sample=True, seed=4)
    np.testing.assert_array_equal(run(do_sample=True, seed=4), a)
    greedy = run()
    np.testing.assert_array_equal(run(do_sample=True, top_k=1), greedy)
    np.testing.assert_array_equal(run(do_sample=True, top_p=1e-6), greedy)


# -- flash attention ----------------------------------------------------------

# (b, sq, sk, h, h_kv, d, causal, window): d 16 (the tiny model), ragged
# lengths, GQA, a window, sq < sk and sq > sk (rows without keys), a
# non-causal d 256 case (the fp32-FMA kernels in bf16 too), the 64 x 64
# tiles' exact fit, and one query row against 5 keys at d 24 (not a
# multiple of the tensor cores' k16 step)
_FLASH = [
    (2, 64, 64, 4, 4, 16, True, 0),
    (2, 100, 100, 4, 2, 16, True, 0),
    (1, 100, 100, 4, 2, 64, True, 24),
    (2, 37, 100, 2, 1, 128, True, 0),
    (1, 130, 70, 2, 2, 32, True, 0),
    (1, 90, 90, 2, 2, 256, False, 0),
    (2, 128, 128, 4, 4, 128, True, 0),
    (1, 200, 200, 4, 2, 40, True, 50),
    (1, 1, 5, 2, 1, 24, True, 0),
]


def _flash_inputs(seed, shape, dtype, device):
    b, sq, sk, h, h_kv, d, _, _ = shape
    rng = np.random.RandomState(seed)
    arrs = (rng.randn(b, sq, h, d), rng.randn(b, sk, h_kv, d),
            rng.randn(b, sk, h_kv, d), rng.randn(b, sq, h, d))
    return [torch.from_numpy(a.astype(np.float32)).to(device, dtype)
            for a in arrs]


def _normalized_close(got, want, atol, name):
    scale = want.float().abs().max().clamp(min=1e-9)
    torch.testing.assert_close(got.float() / scale, want.float() / scale,
                               atol=atol, rtol=0, msg=name)


def _tile_rel_err(got, want, tile=64):
    """The largest relative Frobenius error over the output tiles of
    ``[b, s, h, d]`` tensors: ``tile`` rows (the kernels' tile) of one
    (batch, head) each. A tile whose reference is exactly zero (rows that
    see no key) must be exactly zero too."""
    b, s, h, d = want.shape
    pad = (0, 0, 0, 0, 0, -s % tile)

    def tile_sq_norms(x):
        x = torch.nn.functional.pad(x, pad)
        return x.reshape(b, -1, tile, h, d).square().sum((2, 4))

    dn = tile_sq_norms(got.float() - want.float())
    wn = tile_sq_norms(want.float())
    rel = torch.where(wn > 0, dn / wn, torch.where(
        dn > 0, torch.full((), float("inf"), device=dn.device), 0.0))
    return rel.max().sqrt().item()


# kernel against plain version on the same card and inputs: fp32 within
# 1e-4 (summation order only: streaming against one-pass softmax); bf16
# outputs within 2e-2 (one bf16 rounding of an O(1) value is up to
# 2^-8, plus the order differences); gradients after dividing by their
# max abs, lse (fp32 in both) within 1e-4.
# Those limits take their scale from the largest values, which causal
# attention puts in the first rows and keys. So every output is also
# held tile by tile against the plain version run on fp32 copies of the
# same inputs, by its relative error per tile (_tile_rel_err): fp32
# within 1e-5 (order of the sums only, ~1e-6 expected); bf16 within
# 1e-2 (one bf16 rounding of the output, relative RMS up to ~2.3e-3, and
# in the tensor-core kernels the bf16 rounding of P and dS as operands;
# a tile 10 % off fails).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _FLASH)
def test_flash_kernels_match_plain(cuda, shape, dtype):
    causal, window = shape[6], shape[7]
    q, k, v, do = _flash_inputs(11, shape, dtype, cuda)
    atol = 1e-4 if dtype == torch.float32 else 2e-2
    rel_tol = 1e-5 if dtype == torch.float32 else 1e-2
    kw = dict(causal=causal, window=window)
    n = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
         fa.flash_bwd_dkv.launches)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    want_out, want_lse = fa.flash_fwd_ref(q, k, v, **kw)
    torch.testing.assert_close(out.float(), want_out.float(), atol=atol,
                               rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
    b, sq, h = q.shape[:3]
    delta = (do.float() * want_out.float()).sum(-1).permute(0, 2, 1) \
        .reshape(b * h, sq).contiguous()
    dq = fa.flash_bwd_dq(q, k, v, do, want_lse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, want_lse, delta, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == tuple(x + 1 for x in n)
    want_dq = fa.flash_bwd_dq_ref(q, k, v, do, want_lse, delta, **kw)
    want_dk, want_dv = fa.flash_bwd_dkv_ref(q, k, v, do, want_lse, delta,
                                            **kw)
    _normalized_close(dq, want_dq, atol, "dq")
    _normalized_close(dk, want_dk, atol, "dk")
    _normalized_close(dv, want_dv, atol, "dv")
    f32 = [t.float() for t in (q, k, v, do)]
    want32_out, _ = fa.flash_fwd_ref(*f32[:3], **kw)
    want32_dq = fa.flash_bwd_dq_ref(*f32, want_lse, delta, **kw)
    want32_dk, want32_dv = fa.flash_bwd_dkv_ref(*f32, want_lse, delta, **kw)
    for name, got, want in (("O", out, want32_out), ("dq", dq, want32_dq),
                            ("dk", dk, want32_dk), ("dv", dv, want32_dv)):
        err = _tile_rel_err(got, want)
        assert err <= rel_tol, f"{name}: per-tile relative error {err}"


@pytest.mark.parametrize("h, s", [(1, 1024), (2, 1024), (1, 1020),
                                  (2, 1020)],
                         ids=["1", "2", "1-s1020", "2-s1020"])
def test_flash_kernels_at_a_rank_heads(cuda, h, s):
    """Kernels 1-3 at a tensor-parallel rank's 1 and 2 heads (the 0.44B
    Llama's 12 heads at mp 8) at the train shape, b8 s1024 d128 bf16
    causal, where kernels 2 and 3 start their blocks in groups of 16
    heads, and at s1020, the sequence that mp 8 pads under SP and trims
    before attention (a ragged last tile): each launches once, and every
    output tile is within 1e-2 of the plain version on fp32 copies
    (``test_flash_kernels_match_plain``'s limits)."""
    q, k, v, do = _flash_inputs(5, (8, s, s, h, h, 128, True, 0),
                                torch.bfloat16, cuda)
    n = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
         fa.flash_bwd_dkv.launches)
    out, lse = fa.flash_fwd(q, k, v, causal=True)
    f32 = [t.float() for t in (q, k, v, do)]
    want_out, want_lse = fa.flash_fwd_ref(*f32[:3], causal=True)
    delta = fa._delta(do, want_out.to(q.dtype))
    dq, delta_f = fa.flash_bwd_dq_delta(q, k, v, do, want_out.to(q.dtype),
                                        want_lse, causal=True)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, want_lse, delta, causal=True)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == tuple(x + 1 for x in n)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
    torch.testing.assert_close(delta_f, delta, atol=1e-4, rtol=1e-5)
    want_dq = fa.flash_bwd_dq_ref(*f32, want_lse, delta, causal=True)
    want_dk, want_dv = fa.flash_bwd_dkv_ref(*f32, want_lse, delta,
                                            causal=True)
    for name, got, want in (("O", out, want_out), ("dq", dq, want_dq),
                            ("dk", dk, want_dk), ("dv", dv, want_dv)):
        err = _tile_rel_err(got, want)
        assert err <= 1e-2, f"{name}: per-tile relative error {err}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_block_calls_match_plain(cuda, dtype):
    """Ring attention's block calls (``ops/ring_attention.py``) at a small
    shape, each against its plain version on the same inputs and, tile
    by tile, on fp32 copies (the limits of
    ``test_flash_kernels_match_plain``): kernel 1 on the diagonal block
    (causal) and on an earlier key block (no mask), each returning lse;
    then kernels 2 and 3 on each block given the *global* lse and delta
    of the two blocks combined, as the ring's backward calls them."""
    b, s, h, d = 2, 128, 4, 128
    rng = np.random.RandomState(21)
    q, k0, v0, k1, v1, do = (
        torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
        .to(cuda, dtype) for _ in range(6))
    atol = 1e-4 if dtype == torch.float32 else 2e-2
    rel_tol = 1e-5 if dtype == torch.float32 else 1e-2
    blocks = ((k0, v0, True), (k1, v1, False))
    outs = []
    for k, v, causal in blocks:
        out, lse = fa.flash_fwd(q, k, v, causal=causal)
        want_out, want_lse = fa.flash_fwd_ref(q, k, v, causal=causal)
        torch.testing.assert_close(out.float(), want_out.float(), atol=atol,
                                   rtol=0)
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
        f32, _ = fa.flash_fwd_ref(q.float(), k.float(), v.float(),
                                  causal=causal)
        assert _tile_rel_err(out, f32) <= rel_tol
        outs.append((want_out.float(), want_lse))
    # the global lse and output of the two blocks (the ring's combine)
    (o0, l0), (o1, l1) = outs
    lse = torch.logaddexp(l0, l1)

    def rows(x):
        return x.reshape(b, h, s).permute(0, 2, 1)[..., None]

    out = (o0 * torch.exp(rows(l0 - lse))
           + o1 * torch.exp(rows(l1 - lse))).to(dtype)
    delta = fa._delta(do, out)
    n = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    for k, v, causal in blocks:
        kw = dict(causal=causal)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        want_dq = fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, **kw)
        want_dk, want_dv = fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta,
                                                **kw)
        f32 = [t.float() for t in (q, k, v, do)]
        w32_dq = fa.flash_bwd_dq_ref(*f32, lse, delta, **kw)
        w32_dk, w32_dv = fa.flash_bwd_dkv_ref(*f32, lse, delta, **kw)
        for name, got, want, want32 in (("dq", dq, want_dq, w32_dq),
                                        ("dk", dk, want_dk, w32_dk),
                                        ("dv", dv, want_dv, w32_dv)):
            _normalized_close(got, want, atol, name)
            err = _tile_rel_err(got, want32)
            assert err <= rel_tol, f"{name}: per-tile relative error {err}"
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == \
        (n[0] + 2, n[1] + 2)


def test_flash_reads_strided_qkv_views(cuda):
    """q/k/v as [b, s, h, d] views of one fused projection output (the
    Llama layout) give the results of contiguous copies, and the
    autograd Function launches each kernel once per pass."""
    b, s, h, h_kv, d = 2, 96, 4, 2, 32
    gen = torch.Generator(cuda).manual_seed(3)
    qkv = torch.randn(b, s, (h + 2 * h_kv) * d, device=cuda, generator=gen)
    q, k, v = torch.split(qkv, [h * d, h_kv * d, h_kv * d], dim=-1)
    q, k, v = (t.reshape(b, s, -1, d).requires_grad_()
               for t in (q.detach(), k.detach(), v.detach()))
    assert not q.is_contiguous()
    n = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
         fa.flash_bwd_dkv.launches)
    out = fa.flash_attention(q, k, v, causal=True)
    out.square().sum().backward()
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == tuple(x + 1 for x in n)
    qc, kc, vc = (t.detach().contiguous().requires_grad_()
                  for t in (q, k, v))
    outc = fa.flash_attention(qc, kc, vc, causal=True)
    outc.square().sum().backward()
    torch.testing.assert_close(out, outc, atol=0, rtol=0)
    for a, c in ((q, qc), (k, kc), (v, vc)):
        torch.testing.assert_close(a.grad, c.grad, atol=0, rtol=0)


# The wgmma forward (bf16, d <= 128, no key row or dropout): 128-row
# query tiles, 128-key TMA tiles zero-filled past sq, sk and d (d 96 is
# one and a half 64-column boxes), against the plain version on fp32
# copies of the same inputs with the tolerances above: O per 64-row tile
# within 1e-2 and within 2e-2 abs, lse within 1e-4. Layouts: GQA causal
# (sq == sk), a causal window with sq < sk, non-causal with sq < sk, and
# q, k, v as [b, s, h, d] views of one fused projection output.
@pytest.mark.parametrize("layout", ["gqa", "window_sq_lt_sk",
                                    "noncausal_sq_lt_sk", "strided"])
@pytest.mark.parametrize("sq", [1, 65, 1000])
@pytest.mark.parametrize("d", [64, 96, 128])
def test_wgmma_forward_matches_plain(cuda, d, sq, layout):
    b, h, h_kv = 2, 4, 2
    causal, window, sk = {"gqa": (True, 0, sq),
                          "window_sq_lt_sk": (True, 48, sq + 30),
                          "noncausal_sq_lt_sk": (False, 0, sq + 100),
                          "strided": (True, 0, sq)}[layout]
    rng = np.random.RandomState(d + sq)
    if layout == "strided":
        qkv = torch.from_numpy(rng.randn(b, sq, (h + 2 * h_kv) * d).astype(
            np.float32)).to(cuda, torch.bfloat16)
        q, k, v = (t.reshape(b, sq, -1, d) for t in torch.split(
            qkv, [h * d, h_kv * d, h_kv * d], dim=-1))
        assert not q.is_contiguous()
    else:
        q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                   .to(cuda, torch.bfloat16)
                   for shape in ((b, sq, h, d), (b, sk, h_kv, d),
                                 (b, sk, h_kv, d)))
    kw = dict(causal=causal, window=window)
    n = fa.flash_fwd.launches
    out, lse = fa.flash_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == n + 1
    want, want_lse = fa.flash_fwd_ref(q.float(), k.float(), v.float(), **kw)
    torch.testing.assert_close(out.float(), want, atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
    err = _tile_rel_err(out, want)
    assert err <= 1e-2, f"O: per-tile relative error {err}"


# The wgmma backward (bf16, d <= 128, no key row or dropout): kernel 2
# through both entries (delta given, and computing delta itself) and
# kernel 3, against the plain versions on fp32 copies of the same inputs:
# dQ, dK, dV per 64-row tile within 1e-2 (as above), the fused delta per
# (batch, head) row within 1e-5 of the relative Frobenius error (fp32
# sums in another order); each entry launched once a call, and two calls
# bit-identical (no atomics). d 72 and 96 leave the second 64-column TMA
# box partly or wholly past d (zero fill). Layouts: GQA groups of 1, 2
# and 12, a window with sq < sk, ragged 1000 rows and keys, and q, k, v
# as [b, s, h, d] views of one fused projection output.
_WG_BWD = {
    # layout: (b, sq, sk, h, h_kv, causal, window)
    "group1": (2, 300, 300, 4, 4, True, 0),
    "group2": (2, 300, 300, 4, 2, True, 0),
    "group12": (1, 260, 260, 12, 1, True, 0),
    "window_sq_lt_sk": (2, 200, 330, 4, 2, True, 70),
    "ragged1000": (1, 1000, 1000, 4, 2, True, 0),
    "noncausal": (1, 130, 257, 2, 1, False, 0),
    "strided": (2, 300, 300, 4, 2, True, 0),
}


@pytest.mark.parametrize("layout", list(_WG_BWD))
@pytest.mark.parametrize("d", [72, 96, 128])
def test_wgmma_backward_matches_plain(cuda, d, layout):
    b, sq, sk, h, h_kv, causal, window = _WG_BWD[layout]
    rng = np.random.RandomState(d + sq + h)
    if layout == "strided":
        qkv = torch.from_numpy(rng.randn(b, sq, (h + 2 * h_kv) * d).astype(
            np.float32)).to(cuda, torch.bfloat16)
        q, k, v = (t.reshape(b, sq, -1, d) for t in torch.split(
            qkv, [h * d, h_kv * d, h_kv * d], dim=-1))
        assert not q.is_contiguous()
        do = torch.from_numpy(rng.randn(b, sq, h, d).astype(np.float32)).to(
            cuda, torch.bfloat16)
    else:
        q, k, v, do = _flash_inputs(d, (b, sq, sk, h, h_kv, d, causal, window),
                                    torch.bfloat16, cuda)
    kw = dict(causal=causal, window=window)
    f32 = [t.float() for t in (q, k, v, do)]
    want_out, lse = fa.flash_fwd_ref(*f32[:3], **kw)
    out = want_out.to(torch.bfloat16)
    delta = fa._delta(do, out)
    n = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dq_f, delta_f = fa.flash_bwd_dq_delta(q, k, v, do, out, lse, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    again = (fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
             *fa.flash_bwd_dq_delta(q, k, v, do, out, lse, **kw),
             *fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == (
        n[0] + 4, n[1] + 2)
    for first, second in zip((dq, dq_f, delta_f, dk, dv), again):
        assert torch.equal(first, second)
    want_dq = fa.flash_bwd_dq_ref(*f32, lse, delta, **kw)
    want_dk, want_dv = fa.flash_bwd_dkv_ref(*f32, lse, delta, **kw)
    for name, got, want in (("dq", dq, want_dq), ("dq fused", dq_f, want_dq),
                            ("dk", dk, want_dk), ("dv", dv, want_dv)):
        err = _tile_rel_err(got, want)
        assert err <= 1e-2, f"{name}: per-tile relative error {err}"
    err = _row_rel(delta_f[:, None], delta[:, None])
    assert err <= 1e-5, f"delta: relative error per row {err}"


def test_wgmma_backward_refused_launch_raises(cuda):
    """A launch the C entry refuses raises, and no launch is counted:
    the fused entry at d 136 (it takes d <= 128), and a tensor map that
    cannot be encoded (a head stride of 264 bytes, not a multiple of 16),
    both called past the wrappers' own checks."""
    gen = torch.Generator(cuda).manual_seed(5)

    def launch(q, k, v):
        b, sq, h, d = q.shape
        out, do = torch.zeros_like(q), torch.zeros_like(q)
        lse = torch.zeros(b * h, sq, device=cuda)
        delta = torch.empty_like(lse)
        dq = torch.empty_like(out)
        fa._launch(fa._lib().pt_flash_bwd_dq_delta, "flash_bwd_dq_delta",
                   (q, k, v, do, out, lse, delta, dq), q, k, True, 0, 0.1,
                   (q, k, v, do, out, dq), None)

    n = fa.flash_bwd_dq.launches
    big = torch.randn(1, 64, 2, 136, device=cuda, generator=gen).to(
        torch.bfloat16)
    with pytest.raises(RuntimeError, match="launch failed"):
        launch(big, big, big)
    odd = torch.randn(1, 64, 2, 132, device=cuda, generator=gen).to(
        torch.bfloat16)[..., :128]
    with pytest.raises(RuntimeError, match="tensor map"):
        launch(odd, odd, odd)
    with pytest.raises(ValueError):  # the wrapper's own check
        fa.flash_bwd_dq_delta(big, big, big, big, big,
                              torch.zeros(2, 64, device=cuda), causal=True)
    assert fa.flash_bwd_dq.launches == n


# Kernel 6 on a padded batch whose rows hold 0, 64, 100 and 512 live keys
# (BERT's -1e4 padding, dropout 0.1): dK, dV per 64-row tile within 1e-2
# and dmask per batch row within 1e-3 of the plain version on fp32
# copies; two calls bit-identical (per-head dmask rows summed over heads
# in a fixed order, no atomics); and the keys of the wholly padded 64-key
# tiles of rows that have a live key, which the kernel skips, exactly 0
# in dK, dV and dmask (as the plain version computes them: exp(-1e4 +
# s - lse) is 0 in fp32).
@pytest.mark.parametrize("causal", [False, True], ids=["noncausal",
                                                       "causal"])
def test_hb_dkv_padded_rows_skip_and_determinism(cuda, causal):
    b, s, h, d = 4, 512, 4, 64
    lengths = np.array([0, 64, 100, 512])
    rng = np.random.RandomState(21)
    q, k, v, do = (torch.from_numpy(rng.randn(b, s, h, d).astype(
        np.float32)).to(cuda, torch.bfloat16) for _ in range(4))
    kmask = torch.from_numpy(np.where(
        np.arange(s)[None] < lengths[:, None], 0.0, -1e4).astype(
            np.float32)).reshape(b, 1, s).to(cuda)
    kw = dict(causal=causal, kmask=kmask, seed=_SEED, dropout=0.1)
    f32 = [t.float() for t in (q, k, v, do)]
    want_out, lse = hf.hb_fwd_ref(*f32[:3], **kw)
    delta = (do.float() * want_out.to(q.dtype).float()).sum(-1) \
        .permute(0, 2, 1).reshape(b * h, s).contiguous()
    n = hf.hb_bwd_dkv.launches
    dk, dv, dm = hf.hb_bwd_dkv(q, k, v, do, lse, delta, **kw)
    dk2, dv2, dm2 = hf.hb_bwd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert hf.hb_bwd_dkv.launches == n + 2
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2) \
        and torch.equal(dm, dm2)
    want_dk, want_dv, want_dm = hf.hb_bwd_dkv_ref(*f32, lse, delta, **kw)
    for name, got, want in (("dk", dk, want_dk), ("dv", dv, want_dv)):
        err = _tile_rel_err(got, want)
        assert err <= 1e-2, f"{name}: per-tile relative error {err}"
    assert dm.shape == (b, 1, s)
    err = _row_rel(dm, want_dm)
    assert err <= 1e-3, f"dmask: relative error per row {err}"
    for row, length in enumerate(lengths):
        if length == 0:  # no live key: every tile is computed
            assert (dk[row] != 0).any()
            continue
        pad0 = -(-length // 64) * 64  # the first wholly padded tile
        assert (dk[row, pad0:] == 0).all() and (dv[row, pad0:] == 0).all()
        assert (dm[row, 0, pad0:] == 0).all()


def _train_tiny(device, weights, steps=10):
    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    model = LlamaForCausalLM(cfg, device=device)
    load_jax_weights(model, weights)
    step = TrainStep(model, AdamW(learning_rate=1e-3, weight_decay=0.01,
                                  parameters=model.parameters(),
                                  grad_clip=ClipGradByGlobalNorm(1.0)))
    losses = []
    for i in range(steps):
        rng = np.random.RandomState(100 + i)
        ids, labels = (torch.from_numpy(rng.randint(
            0, cfg.vocab_size, (2, 16)).astype(np.int32)).to(device)
            for _ in range(2))
        losses.append(float(step(ids, labels)))
    return losses, model


def test_train_identity_card_vs_cpu(cuda):
    """10 fp32 AdamW steps with global-norm clipping on the card (flash
    kernels, one launch each per layer per step) and on the CPU (plain
    versions) from the same weights: losses within 1e-4 at every step,
    params within 2e-3 (Adam's first steps move a weight by about
    lr * sign(g); a near-zero gradient whose sign the summation orders
    flip moves it ~2 lr apart)."""
    seed = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=2),
                            device="cpu")
    weights = {n: p.detach().numpy() for n, p in seed.named_parameters()}
    n = fa.flash_fwd.launches, fa.flash_bwd_dq.launches, \
        fa.flash_bwd_dkv.launches
    got, gm = _train_tiny(cuda, weights)
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == tuple(x + 20 for x in n)
    want, wm = _train_tiny("cpu", weights)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    for (name, p), q in zip(gm.named_parameters(), wm.parameters()):
        np.testing.assert_allclose(p.detach().cpu().numpy(),
                                   q.detach().numpy(), atol=2e-3, rtol=0,
                                   err_msg=name)


# The key-mask and dropout variants: kernels 1-3 with one key row per
# query head, kernels 4-6 (head-batched) with one per batch row, each
# against its plain version on the same card, inputs, mask and seed
# words. (b, sq, sk, h, h_kv, d, causal, window, dropout): BERT-like
# non-causal d 64, GQA with a causal band, ragged lengths with rows that
# see no key, a window, and d 256 (the fp32-FMA kernels in bf16 too).
_VARIANT = [
    (2, 100, 100, 4, 4, 64, False, 0, 0.1),
    (2, 64, 64, 4, 2, 32, True, 0, 0.1),
    (1, 130, 70, 2, 2, 32, True, 0, 0.0),
    (1, 200, 200, 4, 2, 40, True, 50, 0.1),
    (2, 90, 90, 2, 2, 256, False, 0, 0.1),
]
_SEED = (20240607, -77)


def _row_rel(got, want):
    """The largest relative Frobenius error over the rows of ``[rows, 1,
    sk]`` tensors; a row whose reference is exactly zero must be too."""
    dn = (got.float() - want.float()).square().sum((1, 2))
    wn = want.float().square().sum((1, 2))
    rel = torch.where(wn > 0, dn / wn, torch.where(
        dn > 0, torch.full((), float("inf"), device=dn.device), 0.0))
    return rel.max().sqrt().item()


def _variant_family(head_batched):
    if head_batched:
        return hf.hb_fwd, hf.hb_bwd_dq, hf.hb_bwd_dkv, hf.hb_fwd_ref, \
            hf.hb_bwd_dq_ref, hf.hb_bwd_dkv_ref
    return fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv, fa.flash_fwd_ref, \
        fa.flash_bwd_dq_ref, fa.flash_bwd_dkv_ref


# Tolerances as test_flash_kernels_match_plain: every output per 64-row
# tile of each (batch, head) against the plain version on fp32 copies,
# fp32 within 1e-5 (with dropout, one flipped keep bit moves its row by
# ~p / (1 - p) of one probability, far past that), bf16 within 1e-2; lse
# within 1e-4 plus 4e-7 of its size (~3 fp32 ulps: a row whose visible
# keys are all padded at -1e4 has |lse| ~ 1e4, where one ulp is ~1e-3).
# dmask, an fp32 sum over rows of fp32 ds terms that partly cancel, by
# the relative Frobenius error of each of its rows, within 1e-4 (fp32:
# order of the sums) or 1e-3 (bf16). Unmasked, the cases are dropout
# only (as an encoder without attention_mask calls kernels 4-6), and
# kernel 6 takes kernel 3's grid.
@pytest.mark.parametrize("masked", [True, False], ids=["kmask", "nomask"])
@pytest.mark.parametrize("head_batched", [False, True],
                         ids=["kernels1-3", "kernels4-6"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _VARIANT)
def test_variant_kernels_match_plain(cuda, shape, dtype, head_batched,
                                     masked):
    b, sq, sk, h, h_kv, d, causal, window, p = shape
    q, k, v, do = _flash_inputs(12, shape[:6] + (causal, window), dtype,
                                cuda)
    rng = np.random.RandomState(13)
    rows = b if head_batched else b * h
    lengths = rng.randint(sk // 3, sk + 1, rows)
    kmask = torch.from_numpy(np.where(
        np.arange(sk)[None] < lengths[:, None], 0.0, -1e4).astype(
            np.float32)).reshape(rows, 1, sk).to(cuda) if masked else None
    fwd, bdq, bdkv, fwd_ref, bdq_ref, bdkv_ref = _variant_family(
        head_batched)
    kw = dict(causal=causal, window=window, kmask=kmask,
              seed=_SEED if p else None, dropout=p)
    f32 = [t.float() for t in (q, k, v, do)]
    n = (fwd.launches, bdq.launches, bdkv.launches)
    out, lse = fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    want_out, want_lse = fwd_ref(*f32[:3], **kw)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=4e-7)
    delta = (do.float() * want_out.to(dtype).float()).sum(-1) \
        .permute(0, 2, 1).reshape(b * h, sq).contiguous()
    dq = bdq(q, k, v, do, want_lse, delta, **kw)
    dk, dv, *dm = bdkv(q, k, v, do, want_lse, delta, **kw)
    torch.cuda.synchronize()
    assert (fwd.launches, bdq.launches, bdkv.launches) == tuple(
        x + 1 for x in n)
    want_dq = bdq_ref(*f32, want_lse, delta, **kw)
    want_dk, want_dv, *want_dm = bdkv_ref(*f32, want_lse, delta, **kw)
    rel_tol = 1e-5 if dtype == torch.float32 else 1e-2
    for name, got, want in (("O", out, want_out), ("dq", dq, want_dq),
                            ("dk", dk, want_dk), ("dv", dv, want_dv)):
        err = _tile_rel_err(got, want)
        assert err <= rel_tol, f"{name}: per-tile relative error {err}"
    assert len(dm) == len(want_dm) == masked
    if masked:
        assert dm[0].shape == (rows, 1, sk)
        err = _row_rel(dm[0], want_dm[0])
        assert err <= (1e-4 if dtype == torch.float32 else 1e-3), \
            f"dmask: relative error per row {err}"


# The tile mode of kernels 1-3: (b, sq, sk, h, h_kv, d, causal, mask
# dims kept full (b, h, sq) or a structured mask's name, dropout). The
# random mask is -1e30 on ~30 % of its elements and on every element of
# query row 5 (a fully masked row: its cell row's full-row flag is set),
# else N(0, 1); the structured ones are _structured_mask's, at the
# Transformer decoder's shape (b 64, s 256, h 8, d 64, dropout 0.1), at
# d 128 (the wgmma kernels' 2-stage rings) with sq != sk, and at the CPU
# skip rule's shapes (several query tiles a head, GQA, the causal flag
# beside a mask whose cells the forward skips or visits whole).
_TILE = [
    (2, 100, 100, 4, 4, 64, False, (0, 0, 1), 0.0),
    (2, 100, 100, 4, 4, 64, False, (1, 0, 1), 0.1),
    (2, 64, 96, 4, 2, 32, True, (1, 1, 1), 0.0),
    (1, 130, 70, 2, 2, 128, False, (0, 1, 1), 0.1),
    (2, 90, 90, 2, 2, 256, True, (1, 0, 1), 0.1),
    (2, 72, 72, 2, 1, 128, False, (0, 0, 0), 0.0),
    (64, 256, 256, 8, 8, 64, False, "causal", 0.1),
    (64, 256, 256, 8, 8, 64, False, "causal_pad", 0.1),
    (64, 256, 256, 8, 8, 64, True, "blocks", 0.1),
    (2, 200, 300, 4, 2, 128, False, "causal_pad", 0.1),
    (2, 300, 200, 4, 4, 128, True, "blocks", 0.0),
    (2, 192, 192, 4, 2, 64, False, "causal", 0.1),
    (2, 260, 200, 4, 2, 64, True, "blocks", 0.1),
    (2, 130, 130, 4, 4, 128, True, (1, 1, 1), 0.1),
]


def _structured_mask(kind, b, h, sq, sk, seed=23):
    """numpy fp32 masks whose 64 x 64 cells the backward skips or stages:
    "causal" the decoder's causal triangle ``[1, 1, sq, sk]`` (-1e30
    above the diagonal, 0 elsewhere); "causal_pad" that triangle with a
    seeded key padding per batch row, ``[b, 1, sq, sk]`` (each row keeps
    key 0); "blocks" ``[1, h, sq, sk]`` N(0, 1) with whole dead cells
    (every third by cell index), a -1e4 cell (MIXED, never dead), a zero
    cell, and query row 70 fully masked inside otherwise live cells."""
    rng = np.random.RandomState(seed)
    tri = np.triu(np.full((sq, sk), -1e30, np.float32), 1)
    if kind == "causal":
        return tri[None, None]
    if kind == "causal_pad":
        lens = rng.randint(1, sk + 1, b)
        pad = np.arange(sk)[None] >= lens[:, None]
        return np.where(pad[:, None, None], np.float32(-1e30),
                        tri[None, None]).astype(np.float32)
    m = rng.randn(1, h, sq, sk).astype(np.float32)
    for rt in range(-(-sq // 64)):
        for ct in range(-(-sk // 64)):
            if (rt + ct) % 3 == 0:
                m[..., 64 * rt:64 * rt + 64, 64 * ct:64 * ct + 64] = -1e30
    m[..., 64:128, 64:128] = -1e4
    m[..., :64, 128:192] = 0.0
    m[..., 70, :] = -1e30
    return m


def _tile_mask(seed, b, h, sq, sk, full, device):
    if isinstance(full, str):
        return torch.from_numpy(_structured_mask(full, b, h, sq, sk)).to(
            device)
    rng = np.random.RandomState(seed)
    shape = tuple(n if f else 1 for n, f in zip((b, h, sq), full)) + (sk,)
    m = rng.randn(*shape).astype(np.float32)
    m = np.where(rng.rand(*shape) < 0.3, -1e30, m).astype(np.float32)
    if full[2]:
        m[:, :, 5] = -1e30
    return torch.from_numpy(m).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _TILE)
def test_tile_mode_kernels_match_plain(cuda, shape, dtype):
    """Kernels 1-3 in the tile mode against their plain versions (fp32
    copies of the inputs): O, dQ, dK and dV per 64-row tile within 1e-5
    (fp32) or 1e-2 (bf16), lse as test_variant_kernels_match_plain, and
    the per-element dmask of each (batch, head) within 1e-4 or 1e-3
    relative; the launches count on ``tile_launches`` only. On the wgmma
    kernels (bfloat16, d <= 128) each call also runs the class pass
    (``tile_classes.launches``; the forward reads its full-row flags),
    and the fused dQ entry's dQ and delta are held alike (delta within
    1e-5 per row)."""
    b, sq, sk, h, h_kv, d, causal, full, p = shape
    q, k, v, do = _flash_inputs(21, (b, sq, sk, h, h_kv, d, causal, 0),
                                dtype, cuda)
    tmask = _tile_mask(22, b, h, sq, sk, full, cuda)
    kw = dict(causal=causal, tmask=tmask, seed=_SEED if p else None,
              dropout=p)
    f32 = [t.float() for t in (q, k, v, do)]
    n = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
         fa.flash_bwd_dkv.launches)
    t = (fa.flash_fwd.tile_launches, fa.flash_bwd_dq.tile_launches,
         fa.flash_bwd_dkv.tile_launches)
    classes = fa.tile_classes.launches
    wgmma = dtype == torch.bfloat16 and d <= 128
    out, lse = fa.flash_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    want_out, want_lse = fa.flash_fwd_ref(*f32[:3], **kw)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=4e-7)
    delta = (do.float() * want_out.to(dtype).float()).sum(-1) \
        .permute(0, 2, 1).reshape(b * h, sq).contiguous()
    dq = fa.flash_bwd_dq(q, k, v, do, want_lse, delta, **kw)
    dk, dv, dm = fa.flash_bwd_dkv(q, k, v, do, want_lse, delta,
                                  tmask_grad=True, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == n
    assert (fa.flash_fwd.tile_launches, fa.flash_bwd_dq.tile_launches,
            fa.flash_bwd_dkv.tile_launches) == tuple(x + 1 for x in t)
    assert fa.tile_classes.launches == classes + 3 * wgmma
    want_dq = fa.flash_bwd_dq_ref(*f32, want_lse, delta, **kw)
    want_dk, want_dv, want_dm = fa.flash_bwd_dkv_ref(
        *f32, want_lse, delta, tmask_grad=True, **kw)
    rel_tol = 1e-5 if dtype == torch.float32 else 1e-2
    checked = [("O", out, want_out), ("dq", dq, want_dq), ("dk", dk, want_dk),
               ("dv", dv, want_dv)]
    if wgmma:
        dq_f, delta_f = fa.flash_bwd_dq_delta(q, k, v, do, want_out.to(dtype),
                                              want_lse, **kw)
        torch.cuda.synchronize()
        assert fa.flash_bwd_dq.tile_launches == t[1] + 2
        checked.append(("dq fused", dq_f, want_dq))
        err = _row_rel(delta_f[:, None], delta[:, None])
        assert err <= 1e-5, f"delta: relative error per row {err}"
    for name, got, want in checked:
        err = _tile_rel_err(got, want)
        assert err <= rel_tol, f"{name}: per-tile relative error {err}"
    # dmask by (batch, head) slice: a query row that sees one key has ds
    # = dp - delta = 0 up to rounding, so its own relative error is noise
    assert dm.shape == (b * h, sq, sk)
    err = _row_rel(dm.reshape(b * h, 1, sq * sk),
                   want_dm.reshape(b * h, 1, sq * sk))
    assert err <= (1e-4 if dtype == torch.float32 else 1e-3), \
        f"dmask: relative error per (batch, head) {err}"


# masks for the class pass: (shape over [b, h, sq, sk], kind) at ragged
# sq and sk; "random" is _tile_mask's (a stride of 70 or 100 floats per
# row: the kernels' 4-byte copies), "zeros", "minus1e4" (-1e4 cells:
# MIXED, never DEAD), and the structured masks
_CLASS_MASKS = [
    ((2, 4, 100, 70), "random"),
    ((1, 1, 300, 200), "random"),
    ((2, 1, 1, 130), "random"),
    ((1, 1, 256, 256), "causal"),
    ((3, 1, 200, 300), "causal_pad"),
    ((1, 4, 300, 200), "blocks"),
    ((1, 1, 130, 130), "zeros"),
    ((2, 2, 128, 192), "minus1e4"),
]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", _CLASS_MASKS,
                         ids=[k for _, k in _CLASS_MASKS])
def test_tile_classes_match_plain(cuda, case, causal):
    """The class pass against ``tile_classes_ref`` byte for byte, its
    class table and its full-row flags (bottom-right causal or not), on
    the mask as given and on an expanded view of its broadcast dims
    (stride 0: one slice is read)."""
    (b, h, sq, sk), kind = case
    if kind == "random":
        m = _tile_mask(24, b, h, sq, sk, (b > 1, h > 1, sq > 1), cuda)
        sq = 256 if sq == 1 else sq
    elif kind == "zeros":
        m = torch.zeros(b, h, sq, sk, device=cuda)
    elif kind == "minus1e4":
        m = torch.zeros(b, h, sq, sk, device=cuda)
        m[..., :64, 64:128] = -1e4
        m[..., 64:, :64] = -1e30
    else:
        m = _tile_mask(24, b, h, sq, sk, kind, cuda)
    n = fa.tile_classes.launches
    for mask in (m, m.expand(2, 4, sq, sk) if m.shape[0] == m.shape[1] == 1
                 else m):
        got, flags = fa.tile_classes(mask, sq, sk, causal, full_rows=True)
        # on the view's strides
        want, want_flags = fa.tile_classes_ref(mask, sq, sk, causal,
                                               full_rows=True)
        assert got.dtype == flags.dtype == torch.uint8
        assert torch.equal(got, want) and torch.equal(flags, want_flags)
        assert torch.equal(fa.tile_classes(mask, sq, sk), want)
    assert fa.tile_classes.launches == n + 4
    # row 5 or 70 is fully masked (without the causal flag, which hides
    # every key from them at sq 300, sk 200)
    if not causal and kind in ("random", "blocks") and case[0][2] > 1:
        assert want_flags.any()
    if kind == "minus1e4":
        assert (want[..., 0, 1] == fa.TILE_MIXED).all()
        assert (want[..., 1, 0] == fa.TILE_DEAD).all()


def test_tile_attention_runs_one_class_pass(cuda):
    """One class pass per attention call on the wgmma path: a forward
    plus backward through ``flash_attention(tmask=...)`` (the forward's
    table handed on to dQ and dK/dV) and a forward under
    ``torch.no_grad`` each launch ``tile_classes`` once, beside one
    forward and (with the backward) one dQ and one dK/dV."""
    b, s, h, d = 2, 200, 4, 64
    q, k, v, do = _flash_inputs(26, (b, s, s, h, h, d, True, 0),
                                torch.bfloat16, cuda)
    mask = torch.from_numpy(_structured_mask("blocks", b, h, s, s)).to(cuda)

    def counts():
        return (fa.tile_classes.launches, fa.flash_fwd.tile_launches,
                fa.flash_bwd_dq.tile_launches, fa.flash_bwd_dkv.tile_launches)

    n = counts()
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention(*leaves, tmask=mask, causal=True).backward(do)
    torch.cuda.synchronize()
    assert counts() == tuple(x + 1 for x in n)
    with torch.no_grad():
        fa.flash_attention(q, k, v, tmask=mask, causal=True)
    torch.cuda.synchronize()
    assert counts() == (n[0] + 2, n[1] + 2, n[2] + 1, n[3] + 1)


def test_tile_backward_runs_the_fused_dq_and_wgmma_dkv(cuda, monkeypatch):
    """``flash_attention(tmask=...)``'s backward in bfloat16 at the
    decoder's shape: one class pass (the forward's), the fused dQ entry
    and dK/dV once each, and no delta computed by torch ops; dQ, dK, dV
    within 1e-2 per
    tile of the plain versions given the forward's O and lse, and the
    mask's gradient within 1e-3 per (batch, head) slice."""
    b, s, h, d, rate = 8, 256, 8, 64, 0.1
    q, k, v, do = _flash_inputs(25, (b, s, s, h, h, d, False, 0),
                                torch.bfloat16, cuda)
    mask = torch.from_numpy(_structured_mask("causal_pad", b, h, s, s)).to(
        cuda)
    kw = dict(causal=False, seed=_SEED, dropout=rate)
    out, lse = fa.flash_fwd(q, k, v, tmask=mask, **kw)
    calls = []
    monkeypatch.setattr(fa, "_delta", lambda *a: calls.append(a))
    n = (fa.tile_classes.launches, fa.flash_bwd_dq.tile_launches,
         fa.flash_bwd_dkv.tile_launches, fa.flash_bwd_dq.launches,
         fa.flash_bwd_dkv.launches)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, mask)]
    fa.flash_attention(*leaves[:3], tmask=leaves[3], **kw).backward(do)
    torch.cuda.synchronize()
    assert not calls
    assert (fa.tile_classes.launches, fa.flash_bwd_dq.tile_launches,
            fa.flash_bwd_dkv.tile_launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == (n[0] + 1, n[1] + 1, n[2] + 1,
                                           n[3], n[4])
    monkeypatch.undo()
    f32 = [t.float() for t in (q, k, v, do)]
    delta = fa._delta(do, out)
    want = (fa.flash_bwd_dq_ref(*f32, lse, delta, tmask=mask, **kw),
            *fa.flash_bwd_dkv_ref(*f32, lse, delta, tmask=mask,
                                  tmask_grad=True, **kw))
    for name, got, w in zip(("dq", "dk", "dv"), leaves[:3], want[:3]):
        err = _tile_rel_err(got.grad, w)
        assert err <= 1e-2, f"{name}: per-tile relative error {err}"
    want_dm = want[3].reshape(b, h, s, s).sum(1, keepdim=True)
    err = _row_rel(leaves[3].grad.reshape(b, 1, s * s),
                   want_dm.reshape(b, 1, s * s))
    assert err <= 1e-3, f"dmask: relative error per batch row {err}"


def test_sdpa_row_varying_mask_runs_the_tile_mode(cuda):
    """``F.scaled_dot_product_attention`` with a ``[sq, sk]`` float mask
    that requires grad: forward and every gradient (the mask's summed
    over batch and heads) on the card against the CPU's plain versions,
    through the tile mode's three kernels."""
    b, s, h, d = 2, 80, 4, 64
    q, k, v, do = _flash_inputs(31, (b, s, s, h, h, d, False, 0),
                                torch.float32, cuda)
    m = _tile_mask(32, 1, 1, s, s, (0, 0, 1), cuda)[0, 0]
    grads = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v, m)]
        out = tattn.scaled_dot_product_attention(*leaves[:3],
                                                 attn_mask=leaves[3])
        out.backward(do.to(dev))
        grads.append([out.detach().cpu()] + [t.grad.cpu() for t in leaves])
    t = fa.flash_fwd.tile_launches
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)
    assert t > 0 and fa.flash_bwd_dkv.tile_launches > 0


def test_hb_flash_autograd_and_dmask_is_the_head_sum(cuda):
    """The head-batched autograd Function launches kernels 4, 5 and 6
    once per pass; its mask gradient is kernel 3's per-head dmask summed
    over heads, and its output and gradients equal kernels 1-3's with
    the mask repeated per head (the same dropout bits)."""
    b, s, h, d = 2, 96, 4, 32
    gen = torch.Generator(cuda).manual_seed(5)
    q, k, v = (torch.randn(b, s, h, d, device=cuda, generator=gen)
               .requires_grad_() for _ in range(3))
    km = torch.zeros(b, 1, s, device=cuda)
    km[0, 0, 70:] = -1e4
    km.requires_grad_()
    n = (hf.hb_fwd.launches, hf.hb_bwd_dq.launches, hf.hb_bwd_dkv.launches)
    out = hf.hb_flash(q, k, v, seed=_SEED, kmask=km, dropout=0.1)
    out.square().sum().backward()
    assert (hf.hb_fwd.launches, hf.hb_bwd_dq.launches,
            hf.hb_bwd_dkv.launches) == tuple(x + 1 for x in n)
    q1, k1, v1 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    km1 = km.detach()[:, None].expand(b, h, 1, s).reshape(b * h, 1, s) \
        .clone().requires_grad_()
    out1 = fa.flash_attention(q1, k1, v1, causal=False, kmask=km1,
                              seed=_SEED, dropout=0.1)
    out1.square().sum().backward()
    torch.testing.assert_close(out, out1, atol=0, rtol=0)
    for a, c in ((q, q1), (k, k1), (v, v1)):
        torch.testing.assert_close(a.grad, c.grad, atol=0, rtol=0)
    torch.testing.assert_close(km.grad, km1.grad.reshape(b, h, 1, s).sum(1),
                               atol=1e-4, rtol=1e-5)


# Kernels 4 and 5 on the wgmma kernels (bf16, d 64 and 128) with the key
# row, dropout and both, causal (sq 200 against sk 331) and not (sq 300,
# sk 331: key rows that start at odd floats), on a padded batch whose rows
# hold 0 live keys (every key padding: no tile is skipped), 1, 100 and all
# 331 (so the 128-key forward tiles and 64-key dQ tiles past a row's live
# keys are skipped): O and dQ (given delta, and computing delta itself) per 64-row tile
# within 1e-2 of the plain version on fp32 copies, lse within 1e-4 plus
# 4e-7 of its size (rows whose keys are all padding have |lse| ~ 1e4),
# the fused delta per (batch, head) row within 1e-5; each entry launched
# once a call, and two calls bit-identical. Without dropout the row with
# one live key attends to that key alone, so its dQ is exactly 0 in exact
# arithmetic (dp - delta cancels) and only rounding is left: that row's
# dQ is held by its size (within 1e-3 of the batch's largest), not per
# tile.
@pytest.mark.parametrize("variant", ["kmask", "dropout", "both"])
@pytest.mark.parametrize("causal", [False, True], ids=["noncausal",
                                                       "causal"])
@pytest.mark.parametrize("d", [64, 128])
def test_hb_wgmma_fwd_and_dq_match_plain(cuda, d, causal, variant):
    b, sq, sk, h = 4, 200 if causal else 300, 331, 4
    rng = np.random.RandomState(d + sq)
    q, do = (torch.from_numpy(rng.randn(b, sq, h, d).astype(np.float32))
             .to(cuda, torch.bfloat16) for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(b, sk, h, d).astype(np.float32))
            .to(cuda, torch.bfloat16) for _ in range(2))
    lengths = np.array([0, 1, 100, sk])
    kmask = torch.from_numpy(np.where(
        np.arange(sk)[None] < lengths[:, None], 0.0, -1e4).astype(
            np.float32)).reshape(b, 1, sk).to(cuda)
    kw = dict(causal=causal, kmask=None if variant == "dropout" else kmask,
              seed=None if variant == "kmask" else _SEED,
              dropout=0.0 if variant == "kmask" else 0.1)
    f32 = [t.float() for t in (q, k, v, do)]
    n = (hf.hb_fwd.launches, hf.hb_bwd_dq.launches)
    out, lse = hf.hb_fwd(q, k, v, **kw)
    want_out, want_lse = hf.hb_fwd_ref(*f32[:3], **kw)
    out_b = want_out.to(torch.bfloat16)
    delta = fa._delta(do, out_b)
    dq = hf.hb_bwd_dq(q, k, v, do, want_lse, delta, **kw)
    dq_f, delta_f = hf.hb_bwd_dq_delta(q, k, v, do, out_b, want_lse, **kw)
    again = (*hf.hb_fwd(q, k, v, **kw),
             hf.hb_bwd_dq(q, k, v, do, want_lse, delta, **kw),
             *hf.hb_bwd_dq_delta(q, k, v, do, out_b, want_lse, **kw))
    torch.cuda.synchronize()
    assert (hf.hb_fwd.launches, hf.hb_bwd_dq.launches) == (n[0] + 2,
                                                           n[1] + 4)
    for first, second in zip((out, lse, dq, dq_f, delta_f), again):
        assert torch.equal(first, second)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=4e-7)
    want_dq = hf.hb_bwd_dq_ref(*f32, want_lse, delta, **kw)
    rows = [0, 2, 3] if variant == "kmask" else [0, 1, 2, 3]
    for name, got, want in (("O", out, want_out), ("dq", dq, want_dq),
                            ("dq fused", dq_f, want_dq)):
        err = _tile_rel_err(got[rows], want[rows])
        assert err <= 1e-2, f"{name}: per-tile relative error {err}"
    if variant == "kmask":
        assert _tile_rel_err(out[1:2], want_out[1:2]) <= 1e-2
        for got in (dq, dq_f, want_dq):
            assert got[1].float().abs().max() <= 1e-3 * want_dq.abs().max()
    err = _row_rel(delta_f[:, None], delta[:, None])
    assert err <= 1e-5, f"delta: relative error per row {err}"


def test_hb_backward_computes_delta_in_kernel_5(cuda, monkeypatch):
    """On CUDA in bf16 ``_HbFlashFn.backward`` takes delta from kernel 5:
    the torch ops of ``_delta`` are never called (they raise here), the
    backward is one launch each of kernels 5 and 6, and dQ is the fused
    entry's on the saved O and lse, bit for bit."""
    b, s, h, d = 2, 160, 4, 64
    gen = torch.Generator(cuda).manual_seed(7)
    q, k, v = (torch.randn(b, s, h, d, device=cuda, generator=gen).to(
        torch.bfloat16).requires_grad_() for _ in range(3))
    km = torch.zeros(b, 1, s, device=cuda)
    km[0, 0, 70:] = -1e4
    kw = dict(seed=_SEED, kmask=km, dropout=0.1)

    def no_torch_delta(*a, **k_):
        raise AssertionError("delta computed by torch ops on CUDA")

    monkeypatch.setattr(fa, "_delta", no_torch_delta)
    n = (hf.hb_fwd.launches, hf.hb_bwd_dq.launches, hf.hb_bwd_dkv.launches)
    out = hf.hb_flash(q, k, v, **kw)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert (hf.hb_fwd.launches, hf.hb_bwd_dq.launches,
            hf.hb_bwd_dkv.launches) == tuple(x + 1 for x in n)
    qd, kd, vd = (t.detach() for t in (q, k, v))
    o2, lse = hf.hb_fwd(qd, kd, vd, **kw)
    assert torch.equal(o2, out.detach())
    dq, _ = hf.hb_bwd_dq_delta(qd, kd, vd, (2 * out.detach().float()).to(
        torch.bfloat16), o2, lse, **kw)
    assert torch.equal(q.grad, dq)
    assert all(t.grad.isfinite().all() for t in (q, k, v))


def test_hb_fused_dq_refuses_what_it_does_not_take(cuda):
    """``hb_bwd_dq_delta`` on CUDA takes bfloat16 with d <= 128 only:
    fp32 and d 136 raise before any launch (no fallback)."""
    gen = torch.Generator(cuda).manual_seed(9)
    n = hf.hb_bwd_dq.launches
    for dtype, d in ((torch.float32, 64), (torch.bfloat16, 136)):
        x = torch.randn(1, 64, 2, d, device=cuda, generator=gen).to(dtype)
        lse = torch.zeros(2, 64, device=cuda)
        with pytest.raises(ValueError, match="bfloat16 with head_dim"):
            hf.hb_bwd_dq_delta(x, x, x, x, x, lse)
    assert hf.hb_bwd_dq.launches == n


def _train_tiny_bert(device, weights, steps=10):
    trandom.seed(0)
    cfg = BertConfig.tiny(hidden_dropout_prob=0.0)
    model = BertForMaskedLM(cfg, device=device)
    load_jax_weights(model, weights)
    step = TrainStep(model, AdamW(learning_rate=1e-3, weight_decay=0.01,
                                  parameters=model.parameters()))
    losses = []
    for i in range(steps):
        rng = np.random.RandomState(200 + i)
        ids = rng.randint(0, cfg.vocab_size, (2, 32))
        mask = (np.arange(32)[None] < np.array([[32], [21]])).astype(
            np.int32)
        labels = np.where((rng.rand(2, 32) < 0.3) & (mask > 0), ids, -100)
        losses.append(float(step(
            torch.from_numpy(ids).to(device), None,
            torch.from_numpy(mask).to(device),
            torch.from_numpy(labels).to(device))))
    return losses


def test_bert_train_identity_card_vs_cpu(cuda):
    """10 fp32 AdamW steps of the tiny BERT with a padded batch and
    attention dropout 0.1 (the same seed words on both sides; hidden
    dropout 0: CPU and CUDA generators differ) on the card (kernels 4-6)
    and on the CPU (plain versions): losses within 1e-4 at every step."""
    seed = BertForMaskedLM(BertConfig.tiny(), device="cpu")
    weights = {n: p.detach().numpy() for n, p in seed.named_parameters()}
    n = hf.hb_fwd.launches, hf.hb_bwd_dq.launches, hf.hb_bwd_dkv.launches
    got = _train_tiny_bert(cuda, weights)
    assert (hf.hb_fwd.launches, hf.hb_bwd_dq.launches,
            hf.hb_bwd_dkv.launches) == tuple(x + 20 for x in n)
    want = _train_tiny_bert("cpu", weights)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "kmask"])
def test_tiny_ernie_trains_through_kernels_4_to_6(cuda, monkeypatch,
                                                   masked):
    """A tiny ERNIE with dropout 0.1 trains 3 AdamW steps on the card:
    every attention call (2 x trunk + 2 x task layers a step, half of
    them causal) goes to kernels 4-6, each launching once a call, and
    none to kernels 1-3."""
    trandom.seed(0)
    cfg = ErnieConfig.tiny()
    model = ErnieForPretraining(cfg, device=cuda)
    step = TrainStep(model, AdamW(learning_rate=1e-3,
                                  parameters=model.parameters()))
    causal = []
    hb = tattn.hb_flash

    def spy(*args, **kw):
        causal.append(kw["causal"])
        return hb(*args, **kw)

    monkeypatch.setattr(tattn, "hb_flash", spy)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (2, 64))
    mask = np.arange(64)[None] < np.array([[64], [40]])
    mlm = np.where((rng.rand(2, 64) < 0.3) & mask, ids, -100)
    lm = np.where(mask, ids, -100)
    ids, mask, mlm, lm = (torch.from_numpy(a.astype(np.int32)).to(cuda)
                          for a in (ids, mask, mlm, lm))
    before = [w.launches for w in (hf.hb_fwd, hf.hb_bwd_dq, hf.hb_bwd_dkv,
                                   fa.flash_fwd)]
    losses = [float(step(ids, None, mask if masked else None, mlm, lm))
              for _ in range(3)]
    per_step = 2 * cfg.num_hidden_layers + 2 * cfg.num_task_layers
    after = [w.launches for w in (hf.hb_fwd, hf.hb_bwd_dq, hf.hb_bwd_dkv,
                                  fa.flash_fwd)]
    assert [a - b for a, b in zip(after, before)] == [3 * per_step] * 3 \
        + [0]
    assert causal.count(True) == causal.count(False) == 3 * per_step // 2
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lamb_on_the_card_matches_the_cpu(cuda, dtype):
    """Lamb's per-parameter trust ratios (``torch._foreach_norm`` on CUDA)
    over parameters of several shapes, 5 steps from the same weights and
    gradients (bf16 with fp32 masters): every parameter, master and
    moment within 1e-6 of its max abs of the CPU's; bf16 parameters
    exactly their masters' rounding."""
    rng = np.random.RandomState(0)
    shapes = [(64, 48), (48,), (3, 5, 7), (1,)]
    ws = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(5)]

    def run(device):
        ps = [torch.nn.Parameter(torch.from_numpy(w).to(device, dtype))
              for w in ws]
        opt = Lamb(learning_rate=0.01, lamb_weight_decay=0.01, parameters=ps,
                   multi_precision=dtype == torch.bfloat16)
        for gs in grads:
            for p, g in zip(ps, gs):
                p.grad = torch.from_numpy(g).to(device, dtype)
            opt.step()
        return ps, opt

    got, gopt = run(cuda)
    want, wopt = run("cpu")
    for p, q in zip(got, want):
        pairs = [(p.detach(), q.detach())]
        pairs += [(v, wopt._accumulators[id(q)][k])
                  for k, v in gopt._accumulators[id(p)].items()]
        if dtype == torch.bfloat16:
            master = gopt._master_weights[id(p)]
            assert torch.equal(p.detach(), master.to(dtype))
            pairs.append((master, wopt._master_weights[id(q)]))
        for a, b in pairs[1:] if dtype == torch.bfloat16 else pairs:
            b = b.float()
            tol = 1e-6 * b.abs().max().item()
            assert (a.cpu().float() - b).abs().max().item() <= tol


# -- the rest of the train path: float16 kernels 1-8, graphs, optimizer ----

# float16 runs every kernel and variant that bfloat16 runs: (b, sq, sk,
# h, h_kv, d, causal, window, variant) with the Llama path's shapes
# (causal, a window, GQA, sq < sk, ragged, non-causal at d 128), d 64,
# key rows, dropout (the mma.sync dK/dV at d 128 with both), the tile
# mode, the head-batched kernels 4-6 and d > 128 (the fp32-FMA kernels).
# Held per 64-row tile within 1e-2 of the plain version on fp32 copies,
# as bf16 (one fp16 rounding of the output and of P and dS as operands);
# lse within 1e-3, dmask per row within 1e-3.
_FP16 = [
    (2, 256, 256, 4, 4, 128, True, 0, ""),
    (1, 300, 300, 4, 4, 128, True, 64, ""),
    (2, 128, 128, 8, 2, 128, True, 0, ""),
    (1, 100, 250, 2, 2, 128, True, 0, ""),
    (2, 200, 200, 4, 4, 128, False, 0, ""),
    (2, 256, 256, 4, 4, 64, True, 0, ""),
    (2, 256, 256, 4, 2, 64, False, 0, "kmask"),
    (2, 256, 256, 4, 4, 64, True, 0, "dropout"),
    (2, 256, 256, 4, 4, 128, False, 0, "kmask_dropout"),
    (2, 256, 256, 4, 4, 64, True, 0, "tile"),
    (2, 256, 256, 4, 4, 128, True, 0, "tile"),
    (2, 256, 256, 4, 4, 64, False, 0, "hb"),
    (1, 128, 128, 2, 2, 256, True, 0, ""),
]


def _fp16_case(shape, cuda):
    """The inputs and keyword arguments of one ``_FP16`` case: (q, k, v,
    dO in float16, their fp32 copies, the kernel keywords, the family:
    ``"flash"`` or ``"hb"``)."""
    b, sq, sk, h, _, d, causal, window, variant = shape
    q, k, v, do = _flash_inputs(11, shape[:8], torch.float16, cuda)
    rng = np.random.RandomState(12)
    live = rng.randint(sk // 2, sk + 1, b)
    live[0] = sk // 3
    rows = torch.from_numpy(np.where(np.arange(sk)[None] < live[:, None],
                                     0.0, -1e4).astype(np.float32)).to(cuda)
    kw = dict(causal=causal, window=window)
    if "kmask" in variant:
        kw["kmask"] = rows[:, None].repeat_interleave(h, 0)  # [b * h, 1, sk]
    if "dropout" in variant or variant == "hb":
        kw.update(seed=_SEED, dropout=0.1)
    if variant == "hb":
        kw["kmask"] = rows[:, None]  # [b, 1, sk]
    if variant == "tile":  # the causal mask with key padding, [b, 1, sq, sk]
        vis = torch.ones(sq, sk, dtype=torch.bool, device=cuda).tril(sk - sq)
        kw.update(causal=False, tmask=torch.where(
            vis, rows[:, None, None, :], -1e9).contiguous(),
            seed=_SEED, dropout=0.1)
    return (q, k, v, do), [t.float() for t in (q, k, v, do)], kw, \
        "hb" if variant == "hb" else "flash"


_FP16_FNS = {
    "flash": (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
              fa.flash_fwd_ref, fa.flash_bwd_dq_ref, fa.flash_bwd_dkv_ref,
              fa.flash_attention),
    "hb": (hf.hb_fwd, hf.hb_bwd_dq, hf.hb_bwd_dkv, hf.hb_fwd_ref,
           hf.hb_bwd_dq_ref, hf.hb_bwd_dkv_ref, hf.hb_flash),
}


@pytest.mark.parametrize("shape", _FP16)
def test_fp16_flash_kernels_match_plain(cuda, shape, monkeypatch):
    (q, k, v, do), f32, kw, family = _fp16_case(shape, cuda)
    fwd, dq_fn, dkv_fn, fwd_ref, dq_ref, dkv_ref, attn = _FP16_FNS[family]
    counters = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
                hf.hb_fwd, hf.hb_bwd_dq, hf.hb_bwd_dkv)
    before = [c.launches + getattr(c, "tile_launches", 0) for c in counters]
    out, lse = fwd(q, k, v, **kw)
    want_out, want_lse = fwd_ref(*f32[:3], **kw)
    out_h = want_out.to(torch.float16)
    want_delta = fa._delta(do, out_h)
    dq = dq_fn(q, k, v, do, want_lse, want_delta, **kw)  # given delta
    dk, dv, *dm = dkv_fn(q, k, v, do, want_lse, want_delta, **kw)
    want_dq = dq_ref(*f32, want_lse, want_delta, **kw)
    want_dk, want_dv, *want_dm = dkv_ref(*f32, want_lse, want_delta, **kw)
    fused = fa._fusable(q) and ("kmask" not in kw or family == "hb") \
        and ("dropout" not in kw or family == "hb" or "tmask" in kw)
    pairs = [("O", out, want_out), ("dQ", dq, want_dq), ("dK", dk, want_dk),
             ("dV", dv, want_dv)]
    if fused:  # the dQ entry that computes delta, as the backward runs it
        entry = hf.hb_bwd_dq_delta if family == "hb" \
            else fa.flash_bwd_dq_delta
        dq2, delta = entry(q, k, v, do, out_h, want_lse, **{
            n: x for n, x in kw.items()
            if family == "hb" or n != "kmask"})
        pairs.append(("dQ (computing delta)", dq2, want_dq))
        torch.testing.assert_close(delta, want_delta, atol=1e-4, rtol=1e-5)
    torch.cuda.synchronize()
    for name, got, want in pairs:
        assert got.dtype == torch.float16, name
        assert _tile_rel_err(got, want) <= 1e-2, name
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
    if "kmask" in kw:
        assert _row_rel(dm[0], want_dm[0]) <= 1e-3
    # each call launched its kernel
    after = [c.launches + getattr(c, "tile_launches", 0) for c in counters]
    ran = [a - b_ for a, b_ in zip(after, before)]
    first = 3 if family == "hb" else 0
    assert ran[first:first + 3] == [1, 1 + fused, 1], ran
    # autograd takes the same kernels: one launch of each, dQ through the
    # entry that computes delta wherever that entry takes the call
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    a_kw = {n: x for n, x in kw.items() if n != "window" or x}
    mod, entry = (hf, "hb_bwd_dq_delta") if family == "hb" \
        else (fa, "_dq_delta")
    real, took = getattr(mod, entry), []
    monkeypatch.setattr(mod, entry, lambda *a, **k_: took.append(1)
                        or real(*a, **k_))
    before = [c.launches + getattr(c, "tile_launches", 0) for c in counters]
    attn(qa, ka, va, **a_kw).backward(do)
    after = [c.launches + getattr(c, "tile_launches", 0) for c in counters]
    ran = [a - b_ for a, b_ in zip(after, before)]
    assert ran[first:first + 3] == [1, 1, 1] and sum(ran) == 3, ran
    assert len(took) == fused
    assert _tile_rel_err(qa.grad, want_dq) <= 1e-2


def _fp16_over(got, want):
    """The worst ratio of |got - want| to two float16 ulps of each
    element's magnitude, elements below 1/64 of the largest held as if
    they were that size (<= 1 passes)."""
    want = want.float()
    w = want.abs()
    return ((got.float() - want).abs()
            / (2.0 ** -9 * (w + w.max() / 64))).max().item()


def test_fp16_raises_where_no_kernel_exists(cuda):
    """The float16 calls that raised for want of a kernel (head_dim 64,
    a key row, dropout, dQ given delta, kernels 4-6, and kernels 7 and 8
    over float16) each launch their kernel now and match their plain
    version: per 64-row tile within 1e-2 (outputs) and, for the paged
    kernels, each element within two float16 ulps of its own magnitude
    (2**-9 of it, elements below 1/64 of the largest held as if they
    were that size: the kernels and their plain versions each round an
    fp32 result to float16 once)."""
    q, k, v, do = _flash_inputs(3, (1, 64, 64, 2, 2, 128, True, 0),
                                torch.float16, cuda)
    q64, k64, v64 = (t[..., :64].contiguous() for t in (q, k, v))
    f32 = [t.float() for t in (q, k, v, do)]
    out, lse = fa.flash_fwd(q, k, v, causal=True)
    delta = fa._delta(do, out)
    km = torch.zeros(2, 1, 64, device=cuda)
    km[:, :, 40:] = -1e4
    drop = dict(seed=(1, 2), dropout=0.1)
    calls = [  # (counter, kernel call, plain call on fp32 copies)
        (fa.flash_fwd, lambda: fa.flash_fwd(q64, k64, v64, causal=True)[0],
         lambda: fa.flash_fwd_ref(*(t.float() for t in (q64, k64, v64)),
                                  causal=True)[0]),
        (fa.flash_fwd, lambda: fa.flash_fwd(q, k, v, causal=True,
                                            kmask=km)[0],
         lambda: fa.flash_fwd_ref(*f32[:3], causal=True, kmask=km)[0]),
        (fa.flash_fwd, lambda: fa.flash_fwd(q, k, v, causal=True, **drop)[0],
         lambda: fa.flash_fwd_ref(*f32[:3], causal=True, **drop)[0]),
        (fa.flash_bwd_dq,
         lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=True),
         lambda: fa.flash_bwd_dq_ref(*f32, lse, delta, causal=True)),
        (fa.flash_bwd_dkv,
         lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=True,
                                  kmask=km)[0],
         lambda: fa.flash_bwd_dkv_ref(*f32, lse, delta, causal=True,
                                      kmask=km)[0]),
        (hf.hb_fwd, lambda: hf.hb_fwd(q, k, v, causal=True)[0],
         lambda: hf.hb_fwd_ref(*f32[:3], causal=True)[0]),
        (hf.hb_bwd_dq,
         lambda: hf.hb_bwd_dq(q, k, v, do, lse, delta, causal=True),
         lambda: hf.hb_bwd_dq_ref(*f32, lse, delta, causal=True)),
        (hf.hb_bwd_dkv,
         lambda: hf.hb_bwd_dkv(q, k, v, do, lse, delta, causal=True)[0],
         lambda: hf.hb_bwd_dkv_ref(*f32, lse, delta, causal=True)[0]),
        (hf.hb_bwd_dq,
         lambda: hf.hb_bwd_dq_delta(q, k, v, do, out, lse, causal=True)[0],
         lambda: hf.hb_bwd_dq_delta_ref(*f32, out.float(), lse,
                                        causal=True)[0]),
    ]
    for i, (counter, call, plain) in enumerate(calls):
        n = counter.launches
        got = call()
        torch.cuda.synchronize()
        assert counter.launches == n + 1, i
        assert got.dtype == torch.float16, i
        assert _tile_rel_err(got, plain()) <= 1e-2, i
    # kernels 7 and 8 take float16: pools, and q over int8 pools
    q7, kp, vp, tab, pos = _inputs(5, 4, 4, 16, 2, 2, 128, [0, 9, 33, 63],
                                   cuda)
    q7, kp, vp = (t.to(torch.float16) for t in (q7, kp, vp))
    n = pa.paged_attend.launches
    got = pa.paged_attend(q7, kp, vp, tab, pos)
    torch.cuda.synchronize()
    assert pa.paged_attend.launches == n + 1 and got.dtype == torch.float16
    want = pa.paged_attend_ref(q7, kp, vp, tab, pos)
    assert _fp16_over(got, want) <= 1
    (kq, ks), (vq, vs) = quantize_kv(kp.float()), quantize_kv(vp.float())
    n = pa.paged_attend_int8.launches
    got = pa.paged_attend_int8(q7, kq, vq, ks, vs, tab, pos)
    torch.cuda.synchronize()
    assert pa.paged_attend_int8.launches == n + 1
    assert got.dtype == torch.float16
    want = pa.paged_attend_int8_ref(q7, kq, vq, ks, vs, tab, pos)
    assert _fp16_over(got, want) <= 1


def test_backward_first_in_autograd_thread(cuda):
    """A flash backward that is the first CUDA work of PyTorch's autograd
    device thread (no context current there yet) still encodes its TMA
    maps: a fresh process, bf16 and float16."""
    import subprocess
    import sys

    code = (
        "import torch\n"
        "from paddle_tpu_torch.ops.cuda import flash_attention as fa\n"
        "for dt in (torch.bfloat16, torch.float16):\n"
        "    g = torch.Generator('cuda').manual_seed(0)\n"
        "    q, k, v, do = (torch.randn(2, 128, 2, 128, device='cuda',\n"
        "                   generator=g).to(dt) for _ in range(4))\n"
        "    qa = q.clone().requires_grad_()\n"
        "    fa.flash_attention(qa, k, v, causal=True).backward(do)\n"
        "    torch.cuda.synchronize()\n"
        "    assert torch.isfinite(qa.grad).all()\n"
        "print('ok')\n")
    root = __file__.rsplit("/tests/", 1)[0]
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=root)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _tiny_pair(seed=5):
    seed_model = LlamaForCausalLM(
        LlamaConfig.tiny(num_hidden_layers=2), device="cpu",
        generator=torch.Generator("cpu").manual_seed(seed))
    return {n: p.detach().numpy() for n, p in seed_model.named_parameters()}


def _eager_step(model, opt):
    def call(*batch):
        opt.clear_grad()
        loss = model(*batch)
        loss.backward()
        opt.step()
        return loss.detach()
    return call


def test_captured_train_step_equals_eager(cuda):
    """5 AdamW steps of the tiny fp32 Llama as one CUDA graph a step
    against eager steps: losses within 1e-6 relative, parameters within
    1e-5 of their max (the captured AdamW multiplies by its device-side
    rate as a separate op: one rounding more than the eager FMA); one
    capture, and one more after ``clear_grad()`` freed the gradients
    the first graph bound; kernels 1-3 counted once a layer a step."""
    weights = _tiny_pair()
    exec_cache.clear()
    runs = []
    for graphs in (True, False):
        model = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=2),
                                 device=cuda)
        load_jax_weights(model, weights)
        opt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                    parameters=model.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0))
        step = TrainStep(model, opt, donate=True) if graphs \
            else _eager_step(model, opt)
        n = fa.flash_fwd.launches
        losses = []
        for i in range(5):
            rng = np.random.RandomState(100 + i)
            ids, labels = (torch.from_numpy(rng.randint(
                0, 128, (2, 16)).astype(np.int32)).to(cuda)
                for _ in range(2))
            if i == 3:
                opt.clear_grad()  # the graph's gradients are freed
            losses.append(float(step(ids, labels)))
        assert fa.flash_fwd.launches == n + 10
        runs.append((losses, model, step))
    (gl, gm, gstep), (el, em, _) = runs
    np.testing.assert_allclose(gl, el, rtol=1e-6, atol=0)
    for p, q in zip(gm.parameters(), em.parameters()):
        assert ((p - q).abs().max() / q.abs().max()).item() <= 1e-5
    assert gstep.compiled_count == 1
    assert exec_cache.stats()["captures"] == 2
    assert gstep.memory_analysis(ids, labels).temp_size_in_bytes > 0
    exec_cache.clear()


_CAPTURE_RULES = ["SGD", "Momentum", "Adagrad", "Adam", "AdamW", "Adamax",
                  "RMSProp", "Lamb", "Adadelta"]


@pytest.mark.parametrize("rule", _CAPTURE_RULES)
def test_capturable_optimizer_equals_eager_on_card(cuda, rule):
    """Each rule inside a captured TrainStep against the same rule run
    eagerly, 4 steps of a small regression network: parameters within
    1e-5 of their max."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.nn import Linear

    kw = {"Adagrad": dict(learning_rate=0.05), "RMSProp":
          dict(learning_rate=1e-2, momentum=0.9, centered=True),
          "Adadelta": dict(learning_rate=1.0),
          "Momentum": dict(learning_rate=0.05, use_nesterov=True)}.get(
              rule, dict(learning_rate=1e-2))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(32, 8).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.randn(32, 1).astype(np.float32)).to(cuda)
    exec_cache.clear()
    runs = []
    for graphs in (True, False):
        gen = torch.Generator("cpu").manual_seed(0)
        net = torch.nn.Sequential(Linear(8, 16, device="cpu", generator=gen),
                                  torch.nn.Tanh(),
                                  Linear(16, 1, device="cpu", generator=gen))
        net = net.to(cuda)
        opt = getattr(topt, rule)(parameters=net.parameters(), **kw)

        def loss_fn(m, xb, yb):
            return ((m(xb) - yb) ** 2).mean()

        step = TrainStep(net, opt, loss_fn) if graphs else (
            lambda xb, yb, net=net, opt=opt: _eager_step(
                lambda *b: loss_fn(net, *b), opt)(xb, yb))
        for _ in range(4):
            step(x, y)
        runs.append(list(net.parameters()))
    for p, q in zip(*runs):
        assert ((p - q).abs().max() / q.abs().max()).item() <= 1e-5, rule
    assert exec_cache.stats()["captures"] == 1
    exec_cache.clear()


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_o1_llama_card_vs_cpu(cuda, dtype):
    """The tiny Llama under auto_cast O1 on the card (float16: kernels
    1-3 at __half) and on the CPU (plain versions) from the same fp32
    weights: the loss within 5e-3, every gradient within 5e-2 of its
    max (low-precision matmul outputs, rounded after sums taken in other
    orders)."""
    from paddle_tpu_torch import amp

    cfg = LlamaConfig.tiny(num_hidden_layers=2, hidden_size=256,
                           num_attention_heads=2)
    seed_model = LlamaForCausalLM(cfg, device="cpu",
                                  generator=torch.Generator("cpu")
                                  .manual_seed(2))
    weights = {n: p.detach().numpy() for n, p in seed_model.named_parameters()}
    rng = np.random.RandomState(4)
    ids = torch.from_numpy(rng.randint(0, 128, (2, 64)).astype(np.int32))
    labels = torch.from_numpy(rng.randint(0, 128, (2, 64)).astype(np.int32))
    out = []
    for device in (cuda, "cpu"):
        model = LlamaForCausalLM(cfg, device=device)
        load_jax_weights(model, weights)
        n = fa.flash_fwd.launches
        with amp.auto_cast(level="O1", dtype=dtype):
            loss = model(ids.to(device), labels.to(device))
        loss.backward()
        if device != "cpu":
            assert fa.flash_fwd.launches == n + 2
        out.append((float(loss), {k: p.grad.cpu() for k, p in
                                  model.named_parameters()}))
    (cl, cg), (hl, hg) = out
    assert np.isfinite(cl) and abs(cl - hl) < 5e-3
    for k in cg:
        scale = hg[k].abs().max().clamp(min=1e-12)
        assert ((cg[k] - hg[k]).abs().max() / scale).item() <= 5e-2, k


@pytest.fixture
def nccl_world(cuda):
    """The process group at world size 1 on NCCL and every axis group
    (fleet.init at degree 1); torn down after."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet

    dist.init_parallel_env()
    fleet.init(is_collective=True, strategy=fleet.DistributedStrategy())
    yield dist
    dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_collectives_on_nccl_at_world_size_one(nccl_world, dtype):
    """Every collective on CUDA tensors through NCCL at world size 1 (the
    card's machine has one card): each gives its input back, over the
    world and over each axis's group."""
    dist = nccl_world
    x = (torch.arange(8, device="cuda") + 1).to(dtype).reshape(2, 4)
    for op in ("SUM", "MAX", "MIN", "PROD", "AVG"):
        assert torch.equal(dist.all_reduce(
            x.clone(), op=getattr(dist.ReduceOp, op)), x), op
    for axis in ("dp", "pp", "sharding", "sep", "mp"):
        assert torch.equal(dist.all_reduce(x.clone(), group=axis), x)
    same = [dist.all_gather(x, axis=1), dist.broadcast(x.clone()),
            dist.reduce(x.clone()), dist.scatter(x),
            dist.scatter(torch.empty_like(x), [x]),
            dist.reduce_scatter(x, axis=1),
            dist.all_to_all(x, split_axis=1, concat_axis=0),
            dist.alltoall_single(None, x), dist.ppermute(x, [(0, 0)])]
    assert all(torch.equal(t, x) for t in same)
    assert [torch.equal(t, x) for t in dist.all_gather([], x)
            + dist.gather(x) + dist.all_to_all([], [x])] == [True] * 3
    dist.barrier()
    assert dist.all_gather_object([], 5) == [5]
    assert dist.get_backend() == "nccl"


def test_degree_one_fleet_step_equals_plain(cuda):
    """The tiny bf16 Llama through fleet.distributed_model and
    distributed_optimizer at world size 1 (NCCL) on CUDA graphs takes
    the plain model's steps bit for bit: at degree 1 no collective runs
    and the layers run the single-card ops."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet

    weights = _tiny_pair()
    cfg = LlamaConfig.tiny(num_hidden_layers=2, dtype="bfloat16")
    runs = []
    for path in ("plain", "fleet"):
        if path == "fleet":
            dist.init_parallel_env()
            fleet.init(is_collective=True,
                       strategy=fleet.DistributedStrategy())
        model = LlamaForCausalLM(cfg, device=cuda)
        load_jax_weights(model, weights)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                    multi_precision=True,
                    grad_clip=ClipGradByGlobalNorm(1.0))
        if path == "fleet":
            model = fleet.distributed_model(model)
            opt = fleet.distributed_optimizer(opt)
        exec_cache.clear()
        step = TrainStep(model, opt)
        losses = []
        for i in range(4):
            rng = np.random.RandomState(100 + i)
            ids, labels = (torch.from_numpy(rng.randint(
                0, 128, (2, 16)).astype(np.int32)).to(cuda)
                for _ in range(2))
            losses.append(float(step(ids, labels)))
        assert exec_cache.stats()["captures"] == 1
        runs.append((losses, [p.detach().clone()
                              for p in model.parameters()]))
        if path == "fleet":
            dist.destroy_process_group()
    exec_cache.clear()
    (pl, pp), (fl, fp) = runs
    assert pl == fl
    assert all(torch.equal(a, b) for a, b in zip(pp, fp))


def test_nan_check_update_born_nan_on_graphs(cuda):
    """A non-finite value born in the update of a captured step (the rate
    set to inf after two good steps, read by the graph from its device
    scalar): the card raises the CPU's (step, leaf, kind), a ``param``
    leaf, and leaves parameters, masters and states bit-identical and
    the step count at 2."""
    from paddle_tpu_torch.monitor.numerics import NonFiniteError

    weights = _tiny_pair()
    exec_cache.clear()
    found = []
    for device in (cuda, "cpu"):
        model = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=2),
                                 device=device)
        load_jax_weights(model, weights)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
        step = TrainStep(model, opt, nan_check=True)
        for i in range(3):
            rng = np.random.RandomState(300 + i)
            ids, labels = (torch.from_numpy(rng.randint(
                0, 128, (2, 16)).astype(np.int32)).to(device)
                for _ in range(2))
            if i < 2:
                step(ids, labels)
                continue
            opt.set_lr(float("inf"))
            before = [t.clone() for t in step._live()]
            with pytest.raises(NonFiniteError) as err:
                step(ids, labels)
            found.append((err.value.step, err.value.leaf, err.value.kind))
            assert all(torch.equal(a, b)
                       for a, b in zip(before, step._live()))
            assert opt._global_step == 2
        if device != "cpu":
            assert exec_cache.stats()["captures"] == 1
    exec_cache.clear()
    assert found[0] == found[1] and found[0][2] == "param"


# -- experts, ZeRO and the sharded checkpoint (chip_smoke.py phase 20) -------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_layer_on_the_card_matches_the_cpu(cuda, dtype, top_k):
    """The index-form MoE (a capacity that drops) on CUDA against the
    same layer on the CPU: the output and every gradient (fp32 within
    1e-5 of each tensor's largest value; bf16 within 2e-2), the same
    tokens dispatched."""
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer

    x = torch.from_numpy(np.random.RandomState(0).randn(4, 32, 64)
                         .astype(np.float32))
    got = []
    for dev in ("cpu", cuda):
        m = MoELayer(64, 128, 8, top_k=top_k, capacity_factor=0.75,
                     activation="silu", device=dev, dtype=dtype,
                     generator=torch.Generator(dev).manual_seed(0)
                     if dev == "cpu" else False)
        if dev != "cpu":
            with torch.no_grad():
                for p, q in zip(m.parameters(), got[0][0].parameters()):
                    p.copy_(q)
        xx = x.to(dev, dtype).clone().requires_grad_()
        y = m(xx)
        ((y.float() ** 2).sum() + 0.5 * m.aux_loss).backward()
        got.append((m, y.detach().float().cpu(), xx.grad.float().cpu(),
                    m.dispatched.cpu()))
    (cm, cy, cg, cd), (gm, gy, gg, gd) = got
    tol = 1e-5 if dtype == torch.float32 else 2e-2

    def close(a, b):
        assert ((a - b).abs().max() / b.abs().max()).item() <= tol

    close(gy, cy)
    close(gg, cg)
    for p, q in zip(gm.parameters(), cm.parameters()):
        close(p.grad.float().cpu(), q.grad.float())
    if dtype == torch.float32:
        assert torch.equal(gd, cd)
    assert gd.sum() < top_k * x.shape[0] * x.shape[1]  # some dropped


def _graph_like_step(model, opt):
    """An eager step whose updates round as a captured TrainStep's: the
    first with Python scalars, the later ones reading the rate and step
    count from device scalars."""
    buf = torch.zeros(2, dtype=torch.float64,
                      device=next(model.parameters()).device)

    def call(*batch):
        opt.clear_grad()
        loss = model(*batch)
        loss.backward()
        if opt._global_step:
            buf.copy_(torch.tensor([float(opt.get_lr()),
                                    float(opt._global_step + 1)],
                                   dtype=torch.float64))
            opt._dev_scalars = buf
        try:
            opt.step()
        finally:
            opt._dev_scalars = None
        return loss.detach()
    return call


def test_moe_llama_captured_step_equals_eager(cuda):
    """The tiny bf16 MoE Llama (4 experts, a capacity that drops) in a
    TrainStep on CUDA graphs against eager steps that read the same
    device scalars: 5 steps bit for bit (losses and parameters), one
    capture: the routing reads nothing from the host."""
    cfg = LlamaConfig.tiny(num_hidden_layers=2, moe_num_experts=4,
                           dtype="bfloat16")
    exec_cache.clear()
    runs = []
    for graphs in (True, False):
        model = LlamaForCausalLM(cfg, device=cuda,
                                 generator=torch.Generator(cuda)
                                 .manual_seed(3))
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                    multi_precision=True,
                    grad_clip=ClipGradByGlobalNorm(1.0))
        step = TrainStep(model, opt) if graphs \
            else _graph_like_step(model, opt)
        rng = np.random.RandomState(7)
        ids, labels = (torch.from_numpy(rng.randint(
            0, 128, (4, 32)).astype(np.int32)).to(cuda) for _ in range(2))
        n = fa.flash_fwd.launches
        losses = [float(step(ids, labels)) for _ in range(5)]
        assert fa.flash_fwd.launches == n + 10
        runs.append((losses, [p.detach().clone()
                              for p in model.parameters()]))
    (gl, gp), (el, ep) = runs
    assert gl == el
    assert all(torch.equal(a, b) for a, b in zip(gp, ep))
    assert exec_cache.stats()["captures"] == 1
    exec_cache.clear()


def test_zero_at_world_size_one_is_the_identity_and_captures(nccl_world):
    """group_sharded_parallel with no axis of degree > 1 returns the model
    and optimizer as they are; the step is one CUDA graph."""
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel

    model = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                             device="cuda")
    opt = AdamW(parameters=model.parameters())
    got = group_sharded_parallel(model, opt, level="p_g_os", offload=True)
    assert got[0] is model and got[1] is opt and opt._zero is None
    exec_cache.clear()
    step = TrainStep(model, opt)
    ids = torch.zeros((2, 16), dtype=torch.int32, device="cuda")
    for _ in range(3):
        step(ids, ids)
    assert exec_cache.stats()["captures"] == 1
    exec_cache.clear()


def test_offloaded_states_are_pinned_and_step_as_on_the_card(cuda):
    """ZeRO's offload placement on one card: masters and moments kept in
    pinned host memory and staged one parameter at a time give the bits
    of the states kept on the card, over 3 steps."""
    from paddle_tpu_torch.distributed.sharding.group_sharded import (
        _host_put,
    )

    weights = _tiny_pair()
    runs = []
    for offload in (False, True):
        model = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=2,
                                                  dtype="bfloat16"),
                                 device=cuda)
        load_jax_weights(model, weights)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                    multi_precision=True)
        if offload:
            opt._initial_state_placement = _host_put
        step = _eager_step(model, opt)
        rng = np.random.RandomState(7)
        ids, labels = (torch.from_numpy(rng.randint(
            0, 128, (2, 16)).astype(np.int32)).to(cuda) for _ in range(2))
        losses = [float(step(ids, labels)) for _ in range(3)]
        states = [v for st in opt._accumulators.values() for v in st.values()]
        states += list(opt._master_weights.values())
        if offload:
            assert all(not t.is_cuda and t.is_pinned() for t in states)
        runs.append((losses, [p.detach().clone() for p in model.parameters()],
                     [t.cpu() for t in states]))
    (pl, pp, ps), (ol, op, os_) = runs
    assert pl == ol
    assert all(torch.equal(a, b) for a, b in zip(pp, op))
    assert all(torch.equal(a, b) for a, b in zip(ps, os_))


def test_offload_holds_one_parameters_state_on_the_card(cuda):
    """Under offload the card holds one parameter's master and moments at
    a time: as each update starts, ``torch.cuda.memory_allocated`` is at
    most that parameter's staged master, moments and fp32 gradient (16
    bytes an element, each tensor rounded to the allocator's 512-byte
    blocks) over what the step started with, and at least its master
    and moments (they are on the card). The first step makes the states,
    the second finds them kept on the host."""
    from paddle_tpu_torch.distributed.sharding.group_sharded import (
        _host_put,
    )

    model = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=2,
                                              dtype="bfloat16"),
                             device=cuda)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                multi_precision=True)
    opt._initial_state_placement = _host_put
    base, seen = [0], []
    update = opt._update

    def watched(works, grads, states, group):
        seen.append((torch.cuda.memory_allocated() - base[0],
                     sum(w.numel() for w in works)))
        return update(works, grads, states, group)

    opt._update = watched
    ids = torch.zeros((2, 16), dtype=torch.int32, device=cuda)
    whole = 16 * sum(p.numel() for p in model.parameters())
    for _ in range(2):
        opt.clear_grad()
        model(ids, ids).backward()
        torch.cuda.synchronize()
        base[0] = torch.cuda.memory_allocated()
        seen.clear()
        opt.step()
        assert len(seen) == len(list(model.parameters()))
        for extra, n in seen:
            assert 12 * n <= extra <= 16 * n + 4 * 512, (extra, n, whole)


def test_checkpoint_of_card_tensors_round_trips(cuda, tmp_path):
    """save_state_dict (async) of a bf16 model on the card and its AdamW
    masters and moments; load_state_dict into a fresh model and
    optimizer on the card: every tensor bit for bit."""
    from paddle_tpu_torch.distributed import checkpoint as ckp

    cfg = LlamaConfig.tiny(num_hidden_layers=2, dtype="bfloat16")
    model = LlamaForCausalLM(cfg, device=cuda)
    opt = AdamW(parameters=list(model.named_parameters()),
                multi_precision=True)
    ids = torch.zeros((2, 16), dtype=torch.int32, device=cuda)
    _eager_step(model, opt)(ids, ids)
    state = {**model.state_dict(keep_vars=True), **ckp.optimizer_state(opt)}
    ckp.save_state_dict(state, str(tmp_path), async_save=True).join()
    assert ckp.is_complete(str(tmp_path))
    fresh = LlamaForCausalLM(cfg, device=cuda,
                             generator=torch.Generator(cuda).manual_seed(9))
    fopt = AdamW(parameters=list(fresh.named_parameters()),
                 multi_precision=True)
    dest = {**fresh.state_dict(keep_vars=True), **ckp.optimizer_state(fopt)}
    ckp.load_state_dict(dest, str(tmp_path))
    fopt.set_state_dict(dest)
    for p, q in zip(model.parameters(), fresh.parameters()):
        assert q.is_cuda and torch.equal(p, q)
    want, got = opt.state_dict(), fopt.state_dict()
    assert want.keys() == got.keys()
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, got[k]), k
        else:
            assert v == got[k], k


# -- attention dropout at global coordinates, the pipe under SP --------------


@pytest.mark.parametrize("causal", [False, True], ids=["noncausal", "causal"])
@pytest.mark.parametrize("head_batched", [False, True],
                         ids=["kernels1-3", "kernels4-6"])
def test_dropout_at_global_coordinates(cuda, head_batched, causal):
    """A launch over batch rows 2-3 and heads 4-7 of a b4 x h8 tensor
    (a dp and mp rank's part), given ``coords`` (2, 4, 8), drops what the
    whole tensor's launch drops there: its O, lse, dQ, dK and dV are that
    launch's slice bit for bit, and each is within 1e-2 per tile of its
    plain version at the same coordinates. Without them the part hashes
    its own heads 0-7 and drops other elements."""
    b, s, h, d = 4, 256, 8, 64
    gen = torch.Generator(cuda).manual_seed(31)
    q, k, v, do = (torch.randn(b, s, h, d, generator=gen, device=cuda)
                   .to(torch.bfloat16) for _ in range(4))
    fwd, bdq, bdkv, fwd_ref, bdq_ref, bdkv_ref = _variant_family(
        head_batched)
    kw = dict(causal=causal, seed=_SEED, dropout=0.25)
    out, lse = fwd(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1) \
        .reshape(b * h, s).contiguous()
    dq = bdq(q, k, v, do, lse, delta, **kw)
    dk, dv = bdkv(q, k, v, do, lse, delta, **kw)
    rows, heads = slice(2, 4), slice(4, 8)

    def stat(t):  # [b * h, s] -> the part's rows and heads
        return t.reshape(b, h, s)[rows, heads].reshape(-1, s).contiguous()

    part = [t[rows, :, heads].contiguous() for t in (q, k, v, do)]
    pkw = dict(kw, coords=(2, 4, 8))
    out_p, lse_p = fwd(*part[:3], **pkw)
    dq_p = bdq(*part, stat(lse), stat(delta), **pkw)
    dk_p, dv_p = bdkv(*part, stat(lse), stat(delta), **pkw)
    torch.cuda.synchronize()
    assert torch.equal(lse_p, stat(lse))
    for name, got, whole in (("O", out_p, out), ("dq", dq_p, dq),
                             ("dk", dk_p, dk), ("dv", dv_p, dv)):
        assert torch.equal(got, whole[rows, :, heads]), name
    f32 = [t.float() for t in part]
    want_out, _ = fwd_ref(*f32[:3], **pkw)
    want_dq = bdq_ref(*f32, stat(lse), stat(delta), **pkw)
    want_dk, want_dv = bdkv_ref(*f32, stat(lse), stat(delta), **pkw)
    for name, got, want in (("O", out_p, want_out), ("dq", dq_p, want_dq),
                            ("dk", dk_p, want_dk), ("dv", dv_p, want_dv)):
        err = _tile_rel_err(got, want)
        assert err <= 1e-2, f"{name}: per-tile relative error {err}"
    local, _ = fwd(*part[:3], **kw)
    assert not torch.equal(local, out_p)


def test_pipe_with_sp_at_world_size_one_equals_plain(cuda):
    """``LlamaForCausalLMPipe`` with ``sequence_parallel=True`` at world
    size 1 (NCCL, mp 1: SP is off at degree 1) on CUDA graphs, loaded
    through the canonical state, takes the plain model's steps bit for
    bit."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import LlamaForCausalLMPipe, to_pipe_layout

    weights = _tiny_pair()
    runs = []
    for path in ("plain", "pipe"):
        cfg = LlamaConfig.tiny(num_hidden_layers=2, dtype="bfloat16",
                               sequence_parallel=path == "pipe")
        if path == "pipe":
            dist.init_parallel_env()
            fleet.init(is_collective=True,
                       strategy=fleet.DistributedStrategy())
            model = LlamaForCausalLMPipe(cfg, device=cuda)
            missing, unexpected = model.set_state_dict(
                to_pipe_layout(weights, cfg.num_hidden_layers))
            assert not missing and not unexpected
            model = fleet.distributed_model(model)
            loss_of = lambda m, i, l: m.loss_fn(m(i), l)  # noqa: E731
        else:
            model = LlamaForCausalLM(cfg, device=cuda)
            load_jax_weights(model, weights)
            loss_of = lambda m, i, l: m(i, l)  # noqa: E731
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                    multi_precision=True,
                    grad_clip=ClipGradByGlobalNorm(1.0))
        exec_cache.clear()
        step = TrainStep(model, opt, loss_of)
        losses = []
        for i in range(4):
            rng = np.random.RandomState(100 + i)
            ids, labels = (torch.from_numpy(rng.randint(
                0, 128, (2, 16)).astype(np.int32)).to(cuda)
                for _ in range(2))
            losses.append(float(step(ids, labels)))
        assert exec_cache.stats()["captures"] == 1
        runs.append((losses, [p.detach().clone()
                              for p in model.parameters()]))
        if path == "pipe":
            dist.destroy_process_group()
    exec_cache.clear()
    (pl, pp), (fl, fp) = runs
    assert pl == fl
    assert all(torch.equal(a, b) for a, b in zip(pp, fp))


# -- the vision path ----------------------------------------------------------


@pytest.fixture
def exact_cudnn(cuda, monkeypatch):
    """fp32 convolutions without TF32, and deterministic algorithms (the
    weight-gradient algorithms may otherwise add in any order)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    return cuda


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_channel_last_layers_equal_nchw(exact_cudnn, dtype):
    """Conv (strided, asymmetric and SAME padding, groups), batch norm in
    train mode, the pools and the adaptive pool on NHWC input equal the
    same ops on NCHW input on the card; the NHWC tensors stay contiguous
    (a channels_last view in and out, no layout copy)."""
    from paddle_tpu_torch.nn import functional as F

    dev = exact_cudnn
    g = torch.Generator(dev).manual_seed(0)
    x = torch.randn(4, 16, 28, 30, device=dev, generator=g).to(dtype)
    w = torch.randn(32, 8, 3, 3, device=dev, generator=g).to(dtype) * 0.2
    b = torch.randn(32, device=dev, generator=g).to(dtype)
    nhwc = x.permute(0, 2, 3, 1).contiguous()
    assert nhwc.movedim(-1, 1).is_contiguous(
        memory_format=torch.channels_last)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for pad in (1, [1, 0, 2, 1], "SAME"):
        first = F.conv2d(x, w, b, stride=2, padding=pad, groups=2)
        last = F.conv2d(nhwc, w, b, stride=2, padding=pad, groups=2,
                        data_format="NHWC")
        assert last.is_contiguous()
        _normalized_close(last.permute(0, 3, 1, 2).float(), first.float(),
                          tol, f"conv {pad}")
    stats = [torch.zeros(16, device=dev), torch.ones(16, device=dev)]
    stats_l = [t.clone() for t in stats]
    scale = torch.ones(16, device=dev, dtype=dtype)
    first = F.batch_norm(x, *stats, scale, None, training=True)
    last = F.batch_norm(nhwc, *stats_l, scale, None, training=True,
                        data_format="NHWC")
    _normalized_close(last.permute(0, 3, 1, 2).float(), first.float(), tol,
                      "batch_norm")
    for a, c in zip(stats_l, stats):
        _normalized_close(a, c, 1e-5, "running statistics")
    for name, kw in (("max_pool2d", dict(kernel_size=3, stride=2,
                                         padding=1)),
                     ("avg_pool2d", dict(kernel_size=2, stride=2, padding=1,
                                         ceil_mode=True)),
                     ("adaptive_avg_pool2d", dict(output_size=(1, 1)))):
        first = getattr(F, name)(x, **kw)
        last = getattr(F, name)(nhwc, data_format="NHWC", **kw)
        assert last.is_contiguous()
        _normalized_close(last.permute(0, 3, 1, 2).float(), first.float(),
                          tol, name)


def _vision_step(dev, graphs=True, **kw):
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision import resnet18

    model = resnet18(num_classes=10, device=dev,
                     generator=torch.Generator(dev).manual_seed(0))
    opt = Momentum(learning_rate=0.01, momentum=0.9,
                   parameters=model.parameters())
    loss_fn = nn.CrossEntropyLoss()

    def loss_of(m, x, y):
        return loss_fn(m(x), y)

    if graphs:
        return model, opt, TrainStep(model, opt, loss_of, **kw)
    buf = torch.zeros(2, dtype=torch.float64, device=dev)

    def eager(x, y, as_replay=False):
        """One eager step; ``as_replay``: its update reads the rate from
        device scalars, as a replayed step's does (a separate multiply,
        one rounding more than the eager FMA)."""
        opt.clear_grad()
        loss = loss_of(model, x, y)
        loss.backward()
        if as_replay:
            buf.copy_(torch.tensor([float(opt.get_lr()),
                                    float(opt._global_step + 1)],
                                   dtype=torch.float64))
            opt._dev_scalars = buf
        try:
            opt.step()
        finally:
            opt._dev_scalars = None
        return loss.detach()
    return model, opt, eager


def _vision_batch(dev, i):
    g = torch.Generator(dev).manual_seed(100 + i)
    return (torch.randn(4, 3, 64, 64, device=dev, generator=g),
            torch.randint(0, 10, (4, 1), device=dev, generator=g))


def test_bn_running_stats_update_in_place_under_replay(exact_cudnn):
    """A captured resnet18 step updates BatchNorm's running statistics
    in place at every replay (the same addresses, new values), and they
    equal an eager run's bit for bit, as do the losses (the eager steps
    after the first round as replays do)."""
    dev = exact_cudnn
    exec_cache.clear()
    model, _, step = _vision_step(dev)
    ptr = model.bn1._mean.data_ptr()
    seen, losses = [], []
    for i in range(4):
        losses.append(float(step(*_vision_batch(dev, i))))
        seen.append(model.bn1._mean.clone())
    assert exec_cache.stats()["captures"] == 1
    assert model.bn1._mean.data_ptr() == ptr
    assert all(not torch.equal(a, b) for a, b in zip(seen, seen[1:]))
    ref, _, eager = _vision_step(dev, graphs=False)
    want = [float(eager(*_vision_batch(dev, i), as_replay=i > 0))
            for i in range(4)]
    assert losses == want
    for (n, a), b in zip(model.named_buffers(), ref.buffers()):
        assert torch.equal(a, b), n
    exec_cache.clear()


def test_bindings_recapture_after_set_state_dict(exact_cudnn):
    """``set_state_dict`` gives parameters and buffers new storage; the
    step's bindings see it and capture again, and the next step equals
    an eager step from the same state."""
    dev = exact_cudnn
    exec_cache.clear()
    model, _, step = _vision_step(dev)
    for i in range(2):
        step(*_vision_batch(dev, i))
    state = {k: v.detach().cpu().numpy() + 0.01
             for k, v in model.state_dict().items()}
    before = step._bindings()
    model.set_state_dict(state)
    assert step._bindings() != before
    got = float(step(*_vision_batch(dev, 2)))
    assert exec_cache.stats()["captures"] == 2
    ref, ropt, eager = _vision_step(dev, graphs=False)
    for i in range(2):  # the same state: an eager step, then a replay
        eager(*_vision_batch(dev, i), as_replay=i > 0)
    ref.set_state_dict(state)
    assert got == float(eager(*_vision_batch(dev, 2)))
    exec_cache.clear()


def test_vision_nan_check_restores_buffers_on_the_card(exact_cudnn):
    """A weight set to inf under ``nan_check`` on a captured step: the
    step raises, and parameters, velocities and running statistics are
    bit-identical to before it."""
    from paddle_tpu_torch.monitor.numerics import NonFiniteError

    dev = exact_cudnn
    exec_cache.clear()
    model, opt, step = _vision_step(dev, nan_check=True)
    for i in range(2):
        step(*_vision_batch(dev, i))
    with torch.no_grad():
        model.layer2[0].conv1.weight[0, 0, 0, 0] = float("inf")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    states = [v.clone() for st in opt._accumulators.values()
              for v in st.values()]
    with pytest.raises(NonFiniteError):
        step(*_vision_batch(dev, 2))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    after = [v for st in opt._accumulators.values() for v in st.values()]
    assert all(torch.equal(a, b) for a, b in zip(states, after))
    exec_cache.clear()


def test_capture_after_a_collected_step(exact_cudnn):
    """A captured step is collected while its model keeps the gradients
    its graph made: the next step captures into a fresh pool (the
    allocator refuses to begin a capture into the old one)."""
    dev = exact_cudnn
    exec_cache.clear()
    model, _, step = _vision_step(dev)
    for i in range(2):
        step(*_vision_batch(dev, i))
    assert model.conv1.weight.grad is not None
    del step
    gc.collect()
    _, _, other = _vision_step(dev)
    for i in range(2):
        other(*_vision_batch(dev, i))
    assert exec_cache.stats()["captures"] == 2
    exec_cache.clear()


# -- the tensor op surface ------------------------------------------------------

_OPS_RNG = np.random.RandomState(31)
_OX = _OPS_RNG.uniform(-1, 1, (5, 6)).astype(np.float32)
_OI = _OPS_RNG.randint(0, 9, (5, 6)).astype(np.int64)
_OSQ = _OPS_RNG.uniform(-1, 1, (5, 5)).astype(np.float32)
_OSPD = (_OSQ @ _OSQ.T + 5 * np.eye(5)).astype(np.float32)

OPS_ON_CARD = [  # (id, call(m, *tensors), inputs, exact)
    ("creation.arange", lambda m: m.arange(7), (), True),
    ("creation.full", lambda m: m.full([2, 3], 1.5), (), True),
    ("creation.tril_indices", lambda m: m.tril_indices(4, 3, 1), (), True),
    ("creation.diag", lambda m, a: m.diag(a[0], padding_value=-1.0),
     (_OX,), True),
    ("manipulation.gather", lambda m, a, i: m.gather(a, i[0, :3] % 6, axis=1),
     (_OX, _OI), True),
    ("manipulation.scatter_nd_add", lambda m, a, i: m.scatter_nd_add(
        a, i[:2, :2], a[0, :2]), (_OX, _OI % 5), False),
    ("manipulation.unique", lambda m, i: m.unique(
        i, return_index=True, return_inverse=True, return_counts=True),
     (_OI,), True),
    ("manipulation.put_along_axis", lambda m, a, i: m.put_along_axis(
        a, i[:, :2] % 6, 0.5, 1), (_OX, _OI), True),
    ("math.sum_int", lambda m, i: m.sum(i, axis=1), (_OI,), True),
    ("math.cummax", lambda m, a: m.cummax(a, axis=1), (_OX,), True),
    ("math.logsumexp", lambda m, a: m.logsumexp(a, axis=0), (_OX,), False),
    ("math.matmul", lambda m, a: m.matmul(a, a, transpose_y=True), (_OX,),
     False),
    ("logic.isclose", lambda m, a: m.isclose(a, a + 1e-6), (_OX,), True),
    ("logic.any", lambda m, a: m.any(a > 0.9, axis=1), (_OX,), True),
    ("search.topk", lambda m, a: m.topk(a, 3, axis=0), (_OX,), True),
    ("search.argsort", lambda m, i: m.argsort(i, descending=True), (_OI,),
     True),
    ("search.mode", lambda m, i: m.mode(i), (_OI,), True),
    ("search.nonzero", lambda m, i: m.nonzero(i > 6), (_OI,), True),
    ("stat.median", lambda m, a: m.median(a, axis=1), (_OX,), True),
    ("stat.quantile", lambda m, a: m.quantile(a, [0.1, 0.9], axis=0),
     (_OX,), False),
    ("stat.histogram", lambda m, a: m.histogram(a, bins=7), (_OX,), True),
    ("linalg.solve", lambda m, s, a: m.linalg.solve(s, a[:, :2]),
     (_OSPD, _OX), False),
    ("linalg.eigvalsh", lambda m, s: m.linalg.eigvalsh(s), (_OSPD,), False),
    ("linalg.svd_recon", lambda m, a: (lambda u, s, vh: (u * s[None]) @ vh)(
        *m.linalg.svd(a)), (_OX,), False),
    ("linalg.qr_recon", lambda m, a: (lambda q, r: q @ r)(*m.linalg.qr(a)),
     (_OX,), False),
    ("einsum.einsum", lambda m, a: m.einsum("ij,kj->ik", a, a), (_OX,),
     False),
]


@pytest.mark.parametrize("rid,call,inputs,exact", OPS_ON_CARD,
                         ids=[r[0] for r in OPS_ON_CARD])
def test_tensor_ops_on_the_card_equal_the_cpu(cuda, rid, call, inputs,
                                              exact):
    """A few ops of each tensor module on CUDA against the port's CPU
    result from the same numpy inputs: equal dtypes, ints, bools and
    exact ops equal, fp32 within 1e-4 of the largest magnitude (linalg
    through reconstructions)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework.device import using_device

    outs = {}
    for dev in ("cpu", "cuda"):
        with using_device(dev):
            outs[dev] = call(ptt, *[ptt.to_tensor(a, place=dev)
                                    for a in inputs])
    got = outs["cuda"] if isinstance(outs["cuda"], (list, tuple)) \
        else [outs["cuda"]]
    want = outs["cpu"] if isinstance(outs["cpu"], (list, tuple)) \
        else [outs["cpu"]]
    assert len(got) == len(want), (rid, len(got), len(want))
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == w.dtype and g.shape == w.shape, rid
        g = g.cpu()
        if exact or not w.is_floating_point():
            assert torch.equal(g, w), rid
        else:
            scale = w.abs().max().clamp_min(1e-30)
            assert float((g - w).abs().max() / scale) < 1e-4, rid


def test_random_ops_on_the_card_seed_and_count(cuda):
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework.device import using_device

    with using_device("gpu"):
        for make in (lambda: ptt.rand([1000]), lambda: ptt.randn([1000]),
                     lambda: ptt.randint(0, 5, [1000]),
                     lambda: ptt.tensor.poisson(
                         torch.full((1000,), 2.0, device="cuda"))):
            ptt.seed(7)
            n = trandom.draws()
            a = make()
            assert trandom.draws() == n + 1 and a.is_cuda
            ptt.seed(7)
            assert torch.equal(a, make())


# -- the nn.functional surface --------------------------------------------------


@pytest.mark.parametrize("row", fcases.ROWS, ids=[r.id for r in fcases.ROWS])
def test_functional_rows_on_the_card_equal_the_cpu(cuda, row):
    """Every row of ``tests/torch_functional_cases.py`` on CUDA against the
    port's CPU result from the same numpy inputs, forward and gradient:
    equal dtypes and shapes, ints and bools equal, floats within the
    row's ``card_tol`` of the largest magnitude (cuDNN's convolutions
    and the TF32 switch off)."""
    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.framework.device import using_device

    torch.backends.cudnn.allow_tf32 = False
    outs, grads = {}, {}
    for dev in ("cpu", "cuda"):
        with using_device(dev):
            outs[dev] = fcases.flat(row.call(F, *[
                ptt.to_tensor(np.array(a), place=dev) for a in row.inputs]))
            grads[dev] = fcases.port_grads(
                lambda *xs: row.call(F, *xs), row.inputs, row.grad,
                dev) if row.grad else []
    assert len(outs["cuda"]) == len(outs["cpu"]), row.id
    for g, w in zip(outs["cuda"], outs["cpu"]):
        if not isinstance(w, torch.Tensor):
            assert g == w, row.id
            continue
        assert g.is_cuda and g.dtype == w.dtype and g.shape == w.shape, \
            row.id
        g = g.detach().cpu()
        w = w.detach()
        if not w.is_floating_point():
            assert torch.equal(g, w), row.id
            continue
        scale = w.abs().max().clamp_min(1e-30)
        assert float((g - w).abs().max() / scale) <= row.card_tol, row.id
    for g, w in zip(grads["cuda"], grads["cpu"]):
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) / scale <= row.card_tol, row.id


@pytest.mark.parametrize("name", fcases.RANDOM)
def test_functional_random_on_the_card(cuda, name):
    """The random functions on CUDA: one seed one draw, one count a call,
    the mean within 6 standard errors."""
    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.framework.device import using_device

    with using_device("gpu"):
        fn, samples, mean, se = fcases.draw(F, name, "cuda")
        ptt.seed(6)
        n = trandom.draws()
        a = fn()
        assert trandom.draws() == n + 1
        ptt.seed(6)
        b = fn()
    for x, y in zip(fcases.flat(a), fcases.flat(b)):
        assert x.is_cuda and torch.equal(x, y)
    assert abs(float(samples(a).double().mean()) - mean) < fcases.SIGMAS * se


@pytest.mark.parametrize("fn,size,src", [
    ("adaptive_max_pool1d", 4, fcases.TIES1),
    ("adaptive_max_pool2d", [4, 3], fcases.TIES),
    ("adaptive_max_pool3d", [2, 3, 4], fcases.TIES3),
    ("max_pool2d", 3, fcases.TIES)], ids=["1d", "2d", "3d", "max_pool2d"])
def test_functional_pool_masks_on_the_card_equal_the_cpu(cuda, fn, size,
                                                         src):
    """``return_mask`` on CUDA: the pooled values and the first maximum's
    int32 indices equal the CPU's on inputs full of ties (the adaptive
    pools' masks are the port's own; no row holds them against the
    reference)."""
    import paddle_tpu_torch.nn.functional as F

    x = torch.from_numpy(src)
    want = getattr(F, fn)(x, size, return_mask=True)
    got = getattr(F, fn)(x.cuda(), size, return_mask=True)
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == w.dtype
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("case", lcases.CASES, ids=[c.id for c in lcases.CASES])
def test_layer_sweep_on_the_card_equals_the_cpu(cuda, case):
    """Each case of ``tests/torch_layer_cases.py`` on the card against the
    port's CPU result from the same weights: outputs, input and parameter
    gradients and the state after the call within the case's
    ``card_tol`` of its largest magnitude (or of 1), TF32 off."""
    torch.backends.cudnn.allow_tf32 = False
    assert lcases.card_error(case) <= case.card_tol


# -- the top-level namespace (autograd, flags, RNG state, device memory) ------

def test_pylayer_over_the_tile_mode_equals_the_plain_path(cuda):
    """A ``PyLayer`` whose backward recomputes the tile-mode attention
    under ``enable_grad`` and calls ``paddle.grad``: output and gradients
    per 64-row tile within 1e-2 of the fp32 plain version, kernel 1 and
    the class pass launched twice, dQ and dK/dV once."""
    import paddle_tpu_torch as paddle

    F = paddle.nn.functional
    s = 256
    mask = torch.triu(torch.full((s, s), float("-inf"), device=cuda), 1)

    class CausalAttention(paddle.autograd.PyLayer):
        @staticmethod
        def forward(ctx, q, k, v):
            ctx.save_for_backward(q, k, v)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

        @staticmethod
        def backward(ctx, do):
            q, k, v = (t.detach().requires_grad_()
                       for t in ctx.saved_tensor())
            with paddle.enable_grad():
                out = F.scaled_dot_product_attention(q, k, v,
                                                     attn_mask=mask)
            return tuple(paddle.grad(out, [q, k, v], do))

    gen = torch.Generator(cuda).manual_seed(0)
    q, k, v, do = (torch.randn(2, s, 2, 64, device=cuda, generator=gen,
                               dtype=torch.bfloat16) for _ in range(4))
    wrappers = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for w in wrappers:
        w.tile_launches = 0
    fa.tile_classes.launches = 0
    xs = [t.detach().requires_grad_() for t in (q, k, v)]
    out = CausalAttention.apply(*xs)
    got = [out, *torch.autograd.grad(out, xs, do)]
    assert [w.tile_launches for w in wrappers] == [2, 1, 1]
    assert fa.tile_classes.launches == 2
    xs = [t.detach().float().requires_grad_() for t in (q, k, v)]
    qt, kt, vt = (t.transpose(1, 2) for t in xs)
    p = (qt @ kt.transpose(-1, -2) / 8.0 + mask).softmax(-1)
    want_out = (p @ vt).transpose(1, 2)
    want = [want_out, *torch.autograd.grad(want_out, xs, do.float())]
    for g, w in zip(got, want):
        assert _tile_rel_err(g, w.detach()) <= 1e-2


def test_check_nan_inf_on_card_tensors_and_a_capture(cuda):
    import paddle_tpu_torch as paddle

    paddle.set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError, match="'log'"):
            paddle.log(torch.tensor([-1.0, 2.0], device=cuda))
        with pytest.raises(FloatingPointError):
            _ = torch.ones(2, device=cuda) / torch.zeros(2, device=cuda)
        paddle.seed(0)
        nn = paddle.nn
        net = nn.Sequential(nn.Linear(16, 32, device=cuda), nn.ReLU(),
                            nn.Linear(32, 1, device=cuda))
        step = TrainStep(net, AdamW(learning_rate=1e-3,
                                    parameters=net.parameters()),
                         lambda m, x, y: ((m(x) - y) ** 2).mean())
        x, y = torch.randn(8, 16, device=cuda), torch.randn(8, 1,
                                                            device=cuda)
        before = exec_cache.stats()["captures"]
        losses = [float(step(x, y)) for _ in range(4)]
        assert exec_cache.stats()["captures"] > before
        assert all(math.isfinite(v) for v in losses)
    finally:
        paddle.set_flags({"FLAGS_check_nan_inf": False})
    assert torch.isinf(torch.ones(1, device=cuda) / 0).all()


def test_device_memory_functions_equal_torch_cuda(cuda):
    import paddle_tpu_torch as paddle

    keep = torch.empty(1 << 20, device=cuda)
    dev = paddle.device
    assert dev.memory_allocated() == torch.cuda.memory_allocated()
    assert dev.max_memory_allocated() == torch.cuda.max_memory_allocated()
    assert dev.memory_reserved() == torch.cuda.memory_reserved()
    assert dev.max_memory_reserved() == torch.cuda.max_memory_reserved()
    assert dev.memory_stats()["allocation.all.current"] == \
        torch.cuda.memory_stats()["allocation.all.current"]
    dev.reset_max_memory_allocated()
    assert dev.max_memory_allocated() == torch.cuda.memory_allocated()
    props = dev.get_device_properties(0)
    assert props["name"] == torch.cuda.get_device_name(0)
    assert props["total_memory"] == \
        torch.cuda.get_device_properties(0).total_memory
    assert paddle.device_count() == torch.cuda.device_count()
    del keep
    dev.empty_cache()


def test_rng_state_round_trip_on_the_card(cuda):
    import paddle_tpu_torch as paddle

    paddle.set_device("gpu")
    paddle.seed(11)
    x = torch.ones(4096, device=cuda)

    def draws():
        return (paddle.randn([64]), paddle.nn.functional.dropout(x, 0.3),
                trandom.next_seed_words(), paddle.rand([8]))

    draws()
    state = paddle.get_rng_state()
    first = draws()
    assert not torch.equal(first[0], draws()[0])
    paddle.set_rng_state(state)
    again = draws()
    for a, b in zip(first, again):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    with trandom.rng_scope(state):
        scoped = draws()
    for a, b in zip(first, scoped):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
