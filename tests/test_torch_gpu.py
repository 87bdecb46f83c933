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
import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM, generate
from paddle_tpu_torch.ops.cuda import paged_attention as pa
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
    # 150 KB of shared memory: the launch raises the 48 KB default
    (2, 3, 64, 2, 8, 256, [0, 191]),
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
