"""The port's paged-attention decode and int8 KV quantizer held against
the JAX package.

- The plain versions ``paged_attend_ref``/``paged_attend_int8_ref`` of
  ``paddle_tpu_torch/ops/cuda/paged_attention.py`` against the Pallas
  kernels run in interpret mode, on the geometry of
  ``tests/test_serving.py::test_paged_kernel_parity_vs_attend_lanes``:
  fp32, atol 2e-5 (both sides compute in fp32; the streaming and the
  one-pass softmax differ in summation order only).
- The plain model of the CUDA kernels' split-K arithmetic
  (``_split_partials_ref`` then ``_merge_splits_ref``) against the same
  Pallas kernels at several split sizes, fp32, atol 2e-5, with splits
  left empty past ``pos`` and below a sliding window; and the split rule.
- ``quantize_kv``/``dequantize_kv`` bit-identical to the reference.
- The wrappers' input checks, and their CPU dispatch to the plain
  version.

The CUDA kernels themselves are held against these plain versions on
the card by ``tests/test_torch_gpu.py``.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.quantization import dequantize_kv as jax_dequantize_kv
from paddle_tpu.quantization import quantize_kv as jax_quantize_kv
from paddle_tpu_torch.ops.cuda import paged_attention as pa
from paddle_tpu_torch.quantization import dequantize_kv, quantize_kv

L, M, B, NKV, G, D = 4, 4, 8, 2, 2, 16
POS = [0, 5, B + 3, M * B - 1]


def _inputs(seed=0, permute=False, nkv=NKV, g=G, d=D, b=B, m=M, lanes=L,
            pos=POS):
    rng = np.random.RandomState(seed)
    nh = nkv * g
    q = rng.randn(lanes, nh, d).astype(np.float32)
    kpool = rng.randn(lanes * m + 1, b, nkv, d).astype(np.float32)
    vpool = rng.randn(lanes * m + 1, b, nkv, d).astype(np.float32)
    tables = np.arange(lanes * m, dtype=np.int32) + 1
    if permute:  # blocks of one lane scattered over the pool
        tables = rng.permutation(tables).astype(np.int32)
    tables = tables.reshape(lanes, m)
    return q, kpool, vpool, tables, np.asarray(pos, np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("permute", [False, True])
def test_paged_ref_matches_pallas(window, permute):
    q, kp, vp, tab, pos = _inputs(permute=permute)
    want = np.asarray(jpa.paged_attend(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tab),
        jnp.asarray(pos), window=window, interpret=True))
    got = pa.paged_attend_ref(*_t(q, kp, vp, tab, pos), window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("window", [0, 6])
def test_paged_int8_ref_matches_pallas(window):
    q, kp, vp, tab, pos = _inputs(seed=1)
    kq, ks = jax_quantize_kv(jnp.asarray(kp))
    vq, vs = jax_quantize_kv(jnp.asarray(vp))
    want = np.asarray(jpa.paged_attend_int8(
        jnp.asarray(q), kq, vq, ks, vs, jnp.asarray(tab), jnp.asarray(pos),
        window=window, interpret=True))
    got = pa.paged_attend_int8_ref(
        *_t(q, np.asarray(kq), np.asarray(vq), np.asarray(ks),
            np.asarray(vs), tab, pos), window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def _empty_splits(pos, window, split, n):
    """[L, n] bool: the splits of ``split`` slots that hold no visible
    slot."""
    out = np.zeros((len(pos), n), bool)
    for lane, p in enumerate(pos):
        lo = max(0, p - window + 1) if window else 0
        for i in range(n):
            out[lane, i] = i * split > p or (i + 1) * split - 1 < lo
    return out


def _check_split_model(m, l, acc, out, want, window, split):
    """The merged output against the Pallas kernel's; each split empty
    where it holds no visible slot, with (NEG_INF, 0, 0) that adds
    nothing, and a live split holding at least its max slot's weight 1.
    Returns the empty splits."""
    np.testing.assert_allclose(out.numpy(), want, atol=2e-5, rtol=0)
    empty = torch.from_numpy(_empty_splits(POS, window, split,
                                           m.shape[-1]))[:, None]
    empty = empty.expand(m.shape)
    assert (m[empty] == pa.NEG_INF).all() and (l[empty] == 0).all()
    assert (acc[empty] == 0).all()
    assert (l[~empty] >= 1).all()
    return empty


# split sizes: one pool block, two, three (not dividing the table's 32
# slots) and the whole table; windows: none, one that starts inside a
# split, and 20, which leaves the first 8-slot split of lane 3 (pos 31)
# empty. Lane 0 (pos 0) leaves every split after its first empty.
@pytest.mark.parametrize("split", [B, 2 * B, 3 * B, M * B])
@pytest.mark.parametrize("window", [0, 6, 20])
def test_split_merge_model_matches_pallas(split, window):
    q, kp, vp, tab, pos = _inputs(seed=8, permute=True)
    want = np.asarray(jpa.paged_attend(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tab),
        jnp.asarray(pos), window=window, interpret=True))
    q, kp, vp, tab, pos_t = _t(q, kp, vp, tab, pos)
    m, l, acc = pa._split_partials_ref(q, kp, vp, tab, pos_t, window=window,
                                       split=split)
    assert m.shape == l.shape == (L, NKV * G, -(-M * B // split))
    empty = _check_split_model(m, l, acc,
                               pa._merge_splits_ref(m, l, acc, q.dtype),
                               want, window, split)
    assert empty[0, 0, 1:].all() or split == M * B
    if window == 20 and split == B:
        assert empty[3, 0, 0]


@pytest.mark.parametrize("split", [B, 3 * B])
@pytest.mark.parametrize("window", [0, 20])
def test_split_merge_model_int8_matches_pallas(split, window):
    q, kp, vp, tab, pos = _inputs(seed=9, permute=True)
    kq, ks = jax_quantize_kv(jnp.asarray(kp))
    vq, vs = jax_quantize_kv(jnp.asarray(vp))
    want = np.asarray(jpa.paged_attend_int8(
        jnp.asarray(q), kq, vq, ks, vs, jnp.asarray(tab), jnp.asarray(pos),
        window=window, interpret=True))
    q, kq, vq, ks, vs, tab, pos_t = _t(q, np.asarray(kq), np.asarray(vq),
                                       np.asarray(ks), np.asarray(vs), tab,
                                       pos)
    m, l, acc = pa._split_partials_ref(q, kq, vq, tab, pos_t, window=window,
                                       split=split, kscale=ks, vscale=vs)
    _check_split_model(m, l, acc, pa._merge_splits_ref(m, l, acc, q.dtype),
                       want, window, split)


@pytest.mark.parametrize("case", [
    # (L, nkv, M, B, row bytes, SMs, slots per split)
    (8, 12, 32, 16, 256, 132, 64),     # served geometry, bf16 d 128
    (8, 12, 32, 16, 128, 132, 128),    # int8 d 128
    (8, 12, 32, 16, 512, 132, 32),     # fp32 d 128
    (8, 12, 128, 16, 256, 132, 64),    # the long shape
    (4, 2, 4, 8, 64, 132, 8),          # few blocks: halved to one block
    (3, 4, 10, 2, 32, 132, 2),         # the tiny engine's geometry
    (2, 2, 3, 64, 512, 132, 64),       # a pool block larger than 32 KB
])
def test_split_rule(case):
    *args, want = case
    split = pa._split_slots(*args)
    L, nkv, M_, B_, row_bytes, n_sm = args
    assert split == want and split % B_ == 0 and split <= M_ * B_
    # fills the card, or has split down to one pool block
    assert L * nkv * -(-M_ * B_ // split) >= 2 * n_sm or split == B_
    # the shared memory a split block takes stays within a block's at the
    # largest heads-per-block and head_dim the kernels take, and 32 KB of
    # staged rows at g 1 and d 128 (six blocks fit an SM)
    for elt in (1, 2, 4):
        assert pa._smem_bytes(8, 256, B_, split, elt) <= pa._MAX_SMEM
        assert pa._smem_bytes(1, 128, B_, split, elt) \
            == 32 * 1024 + 4 * (split // B_)


def test_quantize_kv_bit_identical():
    rng = np.random.RandomState(2)
    x = rng.randn(3, 5, 2, 16).astype(np.float32) * 3
    # rows whose scale is exactly 1: x / s lands on .5 ties, which both
    # sides must round half to even
    x[0, 0, 0] = np.linspace(-7.5, 7.5, 16, dtype=np.float32)
    x[0, 0, 0, 0] = 127.0
    x[1, 1, 1] = 0.0  # an all-zero row takes the 1e-12 scale floor
    jq, js = jax_quantize_kv(jnp.asarray(x))
    tq, ts = quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        dequantize_kv(tq, ts, torch.float32).numpy(),
        np.asarray(jax_dequantize_kv(jq, js, jnp.float32)))


def test_wrappers_take_the_plain_version_on_cpu():
    q, kp, vp, tab, pos = _t(*_inputs(seed=3))
    before = (pa.paged_attend.launches, pa.paged_attend_int8.launches)
    torch.testing.assert_close(
        pa.paged_attend(q, kp, vp, tab, pos, window=6),
        pa.paged_attend_ref(q, kp, vp, tab, pos, window=6), rtol=0, atol=0)
    kq, ks = quantize_kv(kp)
    vq, vs = quantize_kv(vp)
    torch.testing.assert_close(
        pa.paged_attend_int8(q, kq, vq, ks, vs, tab, pos),
        pa.paged_attend_int8_ref(q, kq, vq, ks, vs, tab, pos), rtol=0,
        atol=0)
    # the counters count kernel launches only
    assert (pa.paged_attend.launches,
            pa.paged_attend_int8.launches) == before


def _bad_inputs(case):
    q, kp, vp, tab, pos = _t(*_inputs(seed=4))
    if case == "d_not_multiple_of_8":
        q, kp, vp, tab, pos = _t(*_inputs(d=12))
    elif case == "d_over_256":
        q, kp, vp, tab, pos = _t(*_inputs(d=264))
    elif case == "heads_not_grouped":
        q = torch.zeros(L, 3, D)
    elif case == "pool_not_contiguous":
        kp = kp.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "dtype_mismatch":
        q = q.to(torch.bfloat16)
    elif case == "float16_pool":  # a float16 pool beside a bfloat16 one
        q, kp, vp = q.half(), kp.half(), vp.to(torch.bfloat16)
    elif case == "tables_int64":
        tab = tab.long()
    elif case == "pos_wrong_shape":
        pos = pos[:2]
    elif case == "negative_window":
        return (q, kp, vp, tab, pos), -1
    return (q, kp, vp, tab, pos), 0


@pytest.mark.parametrize("case", [
    "d_not_multiple_of_8", "d_over_256", "heads_not_grouped",
    "pool_not_contiguous", "dtype_mismatch", "float16_pool",
    "tables_int64", "pos_wrong_shape", "negative_window"])
def test_paged_attend_rejects(case):
    args, window = _bad_inputs(case)
    with pytest.raises(ValueError):
        pa.paged_attend(*args, window=window)


@pytest.mark.parametrize("case", ["float_pool", "scale_shape", "d_not_16"])
def test_paged_attend_int8_rejects(case):
    q, kp, vp, tab, pos = _t(*_inputs(seed=5))
    kq, ks = quantize_kv(kp)
    vq, vs = quantize_kv(vp)
    if case == "float_pool":
        kq, vq = kp, vp
    elif case == "scale_shape":
        ks = ks[:, :, :1].contiguous()
    elif case == "d_not_16":
        q, kp, vp, tab, pos = _t(*_inputs(d=8))
        kq, ks = quantize_kv(kp)
        vq, vs = quantize_kv(vp)
    with pytest.raises(ValueError):
        pa.paged_attend_int8(q, kq, vq, ks, vs, tab, pos)


# -- float16 ------------------------------------------------------------------
# The Pallas kernels return q's dtype; at float16 both sides compute in
# fp32 and round the output once: within 2 float16 ulps of the larger of
# the two outputs' largest magnitudes.

def _fp16_ulps(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    top = max(np.abs(got).max(), np.abs(want).max())
    return np.abs(got - want).max() / float(np.spacing(np.float16(top)))


@pytest.mark.parametrize("window", [0, 6])
def test_paged_ref_fp16_matches_pallas(window):
    q, kp, vp, tab, pos = _inputs(seed=11, permute=True)
    q, kp, vp = (x.astype(np.float16) for x in (q, kp, vp))
    want = np.asarray(jpa.paged_attend(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tab),
        jnp.asarray(pos), window=window, interpret=True))
    assert want.dtype == np.float16
    args = _t(q, kp, vp, tab, pos)
    got = pa.paged_attend(*args, window=window)  # the CPU's plain route
    assert got.dtype == torch.float16
    assert _fp16_ulps(got.numpy(), want) <= 2
    torch.testing.assert_close(
        got, pa.paged_attend_ref(*args, window=window), rtol=0, atol=0)


@pytest.mark.parametrize("window", [0, 6])
def test_paged_int8_ref_fp16_q_matches_pallas(window):
    q, kp, vp, tab, pos = _inputs(seed=12)
    q = q.astype(np.float16)
    kq, ks = jax_quantize_kv(jnp.asarray(kp))
    vq, vs = jax_quantize_kv(jnp.asarray(vp))
    want = np.asarray(jpa.paged_attend_int8(
        jnp.asarray(q), kq, vq, ks, vs, jnp.asarray(tab), jnp.asarray(pos),
        window=window, interpret=True))
    assert want.dtype == np.float16
    got = pa.paged_attend_int8(
        *_t(q, np.asarray(kq), np.asarray(vq), np.asarray(ks),
            np.asarray(vs), tab, pos), window=window)
    assert got.dtype == torch.float16
    assert _fp16_ulps(got.numpy(), want) <= 2


@pytest.mark.parametrize("split", [B, 3 * B])
def test_split_merge_model_fp16_matches_pallas(split):
    """The split kernel's plain model over float16 pools: fp32 partials,
    the merge's one rounding to float16."""
    q, kp, vp, tab, pos = _inputs(seed=13, permute=True)
    q, kp, vp = (x.astype(np.float16) for x in (q, kp, vp))
    want = np.asarray(jpa.paged_attend(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tab),
        jnp.asarray(pos), window=0, interpret=True))
    q, kp, vp, tab, pos_t = _t(q, kp, vp, tab, pos)
    m, l, acc = pa._split_partials_ref(q, kp, vp, tab, pos_t, window=0,
                                       split=split)
    out = pa._merge_splits_ref(m, l, acc, q.dtype)
    assert out.dtype == torch.float16 and acc.dtype == torch.float32
    assert _fp16_ulps(out.numpy(), want) <= 2


# -- a tensor-parallel rank's heads ---------------------------------------------
# A rank at mp holds q heads [rank * nh / mp, (rank + 1) * nh / mp) and a
# pool of the kv heads those read; local q head i reads pool head
# (i + head_offset) // kv_group. Its output is its slice of the whole
# heads' output (the Pallas kernel on every head).

RANK_CASES = {  # name: (nkv, q heads per kv head, mp)
    "kv3_g4_mp2": (3, 4, 2),  # 12 q over 3 kv: rank 1 reads 1, 1, 2, 2, 2, 2
    "kv1_g4_mp2": (1, 4, 2),
    "kv2_g6_mp4": (2, 6, 4),  # 3 q heads a rank, one rank over both kv heads
}


def _rank_heads(nkv, g, mp, rank):
    """(q head slice, kv head slice, kv_group, head_offset) of ``rank``,
    as ``models/generation.py::_TensorParallel`` lays them out."""
    heads = nkv * g // mp
    q0 = rank * heads
    lo = q0 // g
    hi = (q0 + heads - 1) // g
    return slice(q0, q0 + heads), slice(lo, hi + 1), g, q0 - lo * g


def _rank_cases():
    return [(name, r) for name, (_, _, mp) in RANK_CASES.items()
            for r in range(mp)]


@functools.cache
def _every_head(name, int8):
    """A case's inputs (int8: quantized pools and their scales) and the
    Pallas kernel's output over every head, once per case."""
    nkv, g, _ = RANK_CASES[name]
    q, kp, vp, tab, pos = _inputs(seed=11, permute=True, nkv=nkv, g=g)
    if not int8:
        return (q, kp, vp, tab, pos), np.asarray(jpa.paged_attend(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tab), jnp.asarray(pos), window=6, interpret=True))
    kq, ks = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(kp)))
    vq, vs = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(vp)))
    return (q, kq, vq, ks, vs, tab, pos), np.asarray(jpa.paged_attend_int8(
        *(jnp.asarray(a) for a in (q, kq, vq, ks, vs, tab, pos)), window=6,
        interpret=True))


@pytest.mark.parametrize("name,rank", _rank_cases())
@pytest.mark.parametrize("int8", [False, True])
def test_rank_heads_match_pallas_slice(name, rank, int8):
    """The plain versions and the split-K model on one rank's heads equal
    the rank's slice of the Pallas kernel over every head."""
    nkv, g, mp = RANK_CASES[name]
    qs, kvs, group, off = _rank_heads(nkv, g, mp, rank)
    heads = dict(kv_group=group, head_offset=off)
    arrays, want = _every_head(name, int8)
    want = want[:, qs]
    if int8:
        q, kq, vq, ks, vs, tab, pos = arrays
        local = _t(q[:, qs], kq[:, :, kvs], vq[:, :, kvs], ks[:, :, kvs],
                   vs[:, :, kvs], tab, pos)
        got = pa.paged_attend_int8(*local, window=6, **heads)
        scales = dict(kscale=local[3], vscale=local[4])
        local = local[:3] + local[5:]
    else:
        q, kp, vp, tab, pos = arrays
        local = _t(q[:, qs], kp[:, :, kvs], vp[:, :, kvs], tab, pos)
        got = pa.paged_attend(*local, window=6, **heads)
        scales = {}
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    m, l, acc = pa._split_partials_ref(*local, window=6, split=B, **scales,
                                       **heads)
    assert m.shape == (L, qs.stop - qs.start, M)
    np.testing.assert_allclose(
        pa._merge_splits_ref(m, l, acc, torch.float32).numpy(), want,
        atol=2e-5, rtol=0)


@pytest.mark.parametrize("heads", [(4, 4), (4, -1), (2, 1), (0, 0)])
def test_paged_attend_rejects_a_head_map_past_the_pool(heads):
    """``kv_group`` and ``head_offset`` must map every q head onto a kv
    head of the pool, the offset inside one group."""
    q, kp, vp, tab, pos = _t(*_inputs(seed=12, nkv=2, g=4))
    group, off = heads
    with pytest.raises(ValueError):
        pa.paged_attend(q[:, :6], kp, vp, tab, pos, kv_group=group,
                        head_offset=off)
