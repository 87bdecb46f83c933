"""Drive the PyTorch/CUDA port's serving path on one NVIDIA Hopper card.

    python3 chip_smoke.py

Five phases in one process; any failure raises and exits non-zero, and
only a run in which every phase passed prints the final line:

1. device: name, capability (must be 9.0), versions, power limit;
2. build: compile every kernel under ``paddle_tpu_torch/ops/cuda/csrc``
   with nvcc (one process per source) and print ptxas's registers,
   shared memory and spills;
3. kernels at full width: each paged-attention kernel against its plain
   PyTorch version on the card (tolerance below), then timed with CUDA
   events beside the plain version, one library call and the byte bound;
4. serve: the 0.44B Llama (bf16, random weights from a seed) through
   ``ServingEngine`` with default settings on a seeded 16-request trace
   (a shared system prompt, so the prefix cache hits),
   once with bf16 KV pools and once with int8 pools; every request must
   finish, and each kernel's launch count over its run must equal
   layers x decode rounds (> 0);
5. token identity: a float32 tiny engine under preemption pressure must
   emit exactly the tokens of the port's own greedy ``generate()``.

Prints the card's name and power limit (``nvidia-smi``), then one JSON
line with every kernel's numbers, then as its last line
``{"ok": true, "device": {...}}``. Needs no network and no JAX; exits
non-zero without a CUDA device or without the repository beside it.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM, generate
from paddle_tpu_torch.ops.cuda import _build
from paddle_tpu_torch.ops.cuda import paged_attention as pa
from paddle_tpu_torch.quantization import quantize_kv
from paddle_tpu_torch.serving import ServingConfig, ServingEngine

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.int8: 1979e12,
                  torch.float32: 67e12}
# kernel vs plain version on the same card, bf16 outputs: one bf16
# rounding of an O(1) output is up to 2**-8 ~ 4e-3; the rest is fp32
# summation order (streaming vs one-pass softmax)
BF16_ATOL = 2e-2

# the repo's headline 0.44B Llama (benchmarks/serving_bench.py)
FULL = dict(vocab_size=32000, hidden_size=1536, intermediate_size=4096,
            num_hidden_layers=12, num_attention_heads=12,
            max_position_embeddings=2048, dtype="bfloat16")
MAX_SEQ_LEN = 512
# decode geometry of ServingConfig's defaults at max_seq_len 512
LANES, BLOCK, M = 8, 16, 32
POS = [0, 37, 100, 200, 255, 300, 450, M * BLOCK - 1]  # lane 0 idle


def log(*a):
    print(*a, flush=True)


# -- phase 1 ------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    log(f"[device] {name} capability {cap} torch {torch.__version__} "
        f"cuda {torch.version.cuda} count {torch.cuda.device_count()}")
    if cap != (9, 0):
        raise RuntimeError(f"needs a Hopper card (capability 9.0), got {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, smi


# -- phase 2 ------------------------------------------------------------------

def phase_build():
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"[build] {len(libs)} libraries in "
        f"{time.perf_counter() - t0:.1f} s: {sorted(libs)}")
    for name in sorted(libs):
        for line in _build.ptxas_report(name):
            log(f"[build] {name}: {line}")


# -- phase 3 ------------------------------------------------------------------

def _pools(nkv, d, layers, gen, quant):
    """One bf16 (or int8 + scales) pool per layer, the engine's layout,
    and a scattered block table: lane 0 idle on null block 0."""
    nblocks = LANES * M + 1
    shape = (layers, nblocks, BLOCK, nkv, d)
    k = torch.randn(shape, device="cuda", generator=gen)
    v = torch.randn(shape, device="cuda", generator=gen)
    tables = (torch.randperm(LANES * M, device="cuda", generator=gen)
              .to(torch.int32).reshape(LANES, M) + 1)
    tables[0] = 0
    if quant:
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        return (kq, vq, ks, vs), tables
    return (k.to(torch.bfloat16), v.to(torch.bfloat16)), tables


def _time(fn, layers, iters=60):
    """ms per call, cycling through the per-layer pools as the engine's
    decode step does, so K/V are not served from L2 by a repeat."""
    for li in range(3):
        fn(li % layers)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        fn(i % layers)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _bound(nkv, g, d, pos, window, kv_dtype, quant):
    """Least time for the work: the larger of the bytes it must move
    over the HBM rate and its operations over the peak rate for the
    inputs' type. Bytes: q and out (bf16), pos, the table entries of the
    live blocks, and each visible K/V slot once (plus its int8 scales)."""
    nh = nkv * g
    elt = 1 if quant else 2
    vis = [min(p + 1, window) if window else p + 1 for p in pos]
    live_blocks = sum(p // BLOCK + 1 for p in pos)
    nbytes = (2 * LANES * nh * d * 2 + 4 * LANES + 4 * live_blocks
              + 2 * sum(vis) * nkv * d * elt
              + (2 * sum(vis) * nkv * 4 if quant else 0))
    ops = sum(vis) * nh * (4 * d + 5)  # QK and PV dots + softmax
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kv_dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _check_case(nkv, g, window, quant, gen, layers=2):
    d = 128
    pools, tables = _pools(nkv, d, layers, gen, quant)
    q = torch.randn(LANES, nkv * g, d, device="cuda",
                    generator=gen).to(torch.bfloat16)
    pos = torch.tensor(POS, dtype=torch.int32, device="cuda")
    kern = pa.paged_attend_int8 if quant else pa.paged_attend
    ref = pa.paged_attend_int8_ref if quant else pa.paged_attend_ref

    def args(li):
        return (q, *(p[li] for p in pools), tables, pos)

    got = kern(*args(0), window=window)
    torch.cuda.synchronize()
    want = ref(*args(0), window=window)
    err = (got.float() - want.float()).abs().max().item()
    tag = (f"{kern.__name__} nkv={nkv} g={g} window={window}")
    log(f"[kernels] {tag}: max_abs_err {err:.3e} (tol {BF16_ATOL})")
    if not err <= BF16_ATOL:
        raise AssertionError(f"{tag}: kernel disagrees with its plain "
                             f"version: max_abs_err {err}")
    return err, pools, tables, q, pos


def _library_call(q, pools, tables, pos, quant, layers):
    """The yardstick: F.scaled_dot_product_attention over K/V already
    gathered (and dequantized) per layer, with the boolean visibility
    mask; the gather is outside the timing."""
    nh, d = q.shape[1], q.shape[2]
    idx = tables.long()
    dense = []
    for li in range(layers):
        if quant:
            kq, vq, ks, vs = (p[li] for p in pools)
            kc = (kq[idx].float() * ks[idx][..., None]).to(torch.bfloat16)
            vc = (vq[idx].float() * vs[idx][..., None]).to(torch.bfloat16)
        else:
            kc, vc = pools[0][li][idx], pools[1][li][idx]
        # [L, M, B, nkv, d] -> [L, nkv, M*B, d]
        dense.append(tuple(t.reshape(LANES, M * BLOCK, -1, d)
                           .transpose(1, 2).contiguous() for t in (kc, vc)))
    slots = torch.arange(M * BLOCK, device="cuda")
    mask = (slots[None, :] <= pos[:, None])[:, None, None, :]
    qs = q[:, :, None, :]
    nkv = dense[0][0].shape[1]

    def call(li):
        k, v = dense[li]
        return torch.nn.functional.scaled_dot_product_attention(
            qs, k, v, attn_mask=mask, enable_gqa=nkv != nh)

    return call


def phase_kernels():
    gen = torch.Generator("cuda").manual_seed(0)
    errs = {"paged_attend": 0.0, "paged_attend_int8": 0.0}
    for nkv, g, window, quant in ((12, 1, 0, False), (12, 1, 64, False),
                                  (4, 3, 0, False), (12, 1, 0, True),
                                  (12, 1, 64, True), (4, 3, 0, True)):
        err, *_ = _check_case(nkv, g, window, quant, gen)
        key = "paged_attend_int8" if quant else "paged_attend"
        errs[key] = max(errs[key], err)
    rows = {}
    layers = FULL["num_hidden_layers"]
    for quant in (False, True):
        name = "paged_attend_int8" if quant else "paged_attend"
        _, pools, tables, q, pos = _check_case(12, 1, 0, quant, gen,
                                               layers=layers)
        kern = pa.paged_attend_int8 if quant else pa.paged_attend
        ref = pa.paged_attend_int8_ref if quant else pa.paged_attend_ref

        def with_layer(fn):
            return lambda li: fn(q, *(p[li] for p in pools), tables, pos)

        ms = _time(with_layer(kern), layers)
        plain_ms = _time(with_layer(ref), layers)
        library_ms = _time(_library_call(q, pools, tables, pos, quant,
                                         layers), layers)
        bound_ms, bound_by = _bound(12, 1, 128, POS, 0,
                                    torch.int8 if quant else torch.bfloat16,
                                    quant)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          max_abs_err=errs[name])
        log(f"[kernels] {name} L={LANES} M={M} B={BLOCK} nkv=12 d=128 "
            f"pos={POS}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
            f"library_ms {library_ms:.4f} bound_ms {bound_ms:.5f} "
            f"({bound_by}); launches per decode round = {layers} (layers)")
        del pools
    return rows


# -- phase 4 ------------------------------------------------------------------

def _trace(seed=0, n=16, system=32):
    """Prompts of 64-192 tokens that open with one shared 32-token
    system prompt (two full blocks for the prefix cache), 32-64 new
    tokens each."""
    rng = np.random.RandomState(seed)
    vocab = FULL["vocab_size"]
    head = rng.randint(0, vocab, (system,))
    return [(np.concatenate([head, rng.randint(
        0, vocab, (int(rng.randint(64, 193)) - system,))]).astype(np.int32),
        int(rng.randint(32, 65))) for _ in range(n)]


def _serve_once(model, kv_int8, trace, card):
    """One measured run of the main path: counts zeroed just before,
    read just after. Returns the kernel's launch count over the run."""
    wrapper = pa.paged_attend_int8 if kv_int8 else pa.paged_attend
    warm = ServingEngine(model, ServingConfig(max_seq_len=MAX_SEQ_LEN,
                                              kv_int8=kv_int8))
    warm.warmup()
    warm.submit(trace[0][0][:40], max_new_tokens=8)
    warm.run()
    del warm
    eng = ServingEngine(model, ServingConfig(max_seq_len=MAX_SEQ_LEN,
                                             kv_int8=kv_int8))
    assert eng.paged_active and eng.spec_active \
        and eng.config.prefix_cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.paged_attend.launches = 0
    pa.paged_attend_int8.launches = 0
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in trace]
    outs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = wrapper.launches
    c = eng.counters
    layers = FULL["num_hidden_layers"]
    for r, (_, n) in zip(reqs, trace):
        if len(outs[r.request_id]) != n:
            raise AssertionError(f"request {r.request_id} returned "
                                 f"{len(outs[r.request_id])} of {n} tokens")
        if not ((outs[r.request_id] >= 0)
                & (outs[r.request_id] < FULL["vocab_size"])).all():
            raise AssertionError("token ids out of the vocabulary")
    if c["decode_steps"] <= 0:
        raise AssertionError("no plain decode round ran: the paged kernel "
                             "was never on the path")
    if launches != layers * c["decode_steps"]:
        raise AssertionError(
            f"{wrapper.__name__} launched {launches} times, expected "
            f"layers x decode_steps = {layers} x {c['decode_steps']}")
    other = pa.paged_attend if kv_int8 else pa.paged_attend_int8
    if other.launches:
        raise AssertionError(f"{other.__name__} ran on the wrong pool")
    if c["prefix_hit_tokens"] <= 0:
        raise AssertionError("the shared system prompt never hit the "
                             "prefix cache")
    rounds = c["decode_steps"] + c["verify_steps"]
    tokens = sum(n for _, n in trace)
    log(f"[serve] kv_int8={kv_int8} on {card}: {len(trace)} requests, "
        f"{tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} tokens/s; "
        f"{c['decode_steps']} decode + {c['verify_steps']} verify rounds, "
        f"{c['decode_wall_s'] / rounds * 1e3:.3f} ms per round; "
        f"{c['prefill_chunks']} prefill chunks, "
        f"{c['prefix_hit_tokens']} prefix-hit tokens, "
        f"{c['spec_accepted_tokens']}/{c['spec_proposed_tokens']} drafts "
        f"accepted; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
        f"{wrapper.__name__} launches {launches}")
    return launches


def phase_serve(card):
    t0 = time.perf_counter()
    model = LlamaForCausalLM(LlamaConfig(**FULL), device="cuda",
                             generator=torch.Generator("cuda").manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[serve] 0.44B Llama: {n_params / 1e9:.3f} B parameters, bf16, "
        f"built in {time.perf_counter() - t0:.1f} s")
    trace = _trace()
    return {"paged_attend": _serve_once(model, False, trace, card),
            "paged_attend_int8": _serve_once(model, True, trace, card)}


# -- phase 5 ------------------------------------------------------------------

def phase_identity():
    """tests/test_serving.py::test_engine_paged_token_identical's
    geometry on the card: the engine's tokens (decode through the CUDA
    kernels) equal the port's own greedy generate(), request by
    request."""
    model = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=2),
                             device="cuda",
                             generator=torch.Generator("cuda").manual_seed(0))
    for kv_int8 in (False, True):
        eng = ServingEngine(model, ServingConfig(
            max_lanes=3, block_size=2, num_blocks=12, prefill_chunk=4,
            max_seq_len=20, kv_int8=kv_int8))
        rng = np.random.RandomState(5)
        reqs = []
        for _ in range(6):
            plen, new = int(rng.randint(2, 9)), int(rng.randint(6, 12))
            prompt = rng.randint(0, model.config.vocab_size,
                                 (plen,)).astype(np.int32)
            reqs.append((eng.submit(prompt, max_new_tokens=new), prompt,
                         new))
        outs = eng.run()
        if eng.counters["preemptions"] <= 0 \
                or eng.counters["decode_steps"] <= 0:
            raise AssertionError(f"identity run is vacuous: "
                                 f"{eng.counters}")
        for r, prompt, new in reqs:
            want = generate(model, prompt[None], max_new_tokens=new,
                            kv_int8=kv_int8).cpu().numpy()[0]
            if not np.array_equal(outs[r.request_id], want):
                raise AssertionError(
                    f"kv_int8={kv_int8} request {r.request_id}: engine "
                    f"{outs[r.request_id].tolist()} != generate "
                    f"{want.tolist()}")
        log(f"[identity] kv_int8={kv_int8}: {len(reqs)} requests "
            f"token-identical to generate() through "
            f"{eng.counters['preemptions']} preemptions, "
            f"{eng.counters['decode_steps']} paged decode rounds")


def main():
    t0 = time.perf_counter()
    name, smi = phase_device()
    phase_build()
    rows = phase_kernels()
    launches = phase_serve(name)
    phase_identity()
    src = "paddle_tpu_torch/ops/cuda/csrc/paged_attention.cu"
    replaces = {"paged_attend": "paddle_tpu/ops/pallas/paged_attention.py:51",
                "paged_attend_int8":
                    "paddle_tpu/ops/pallas/paged_attention.py:170"}
    kernels = [dict(name=k, route="cuda", source=src, replaces=replaces[k],
                    launches=launches[k], **rows[k])
               for k in ("paged_attend", "paged_attend_int8")]
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
