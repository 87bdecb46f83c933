// FlashAttention-2 forward and backward kernels for Hopper (sm_90a), with
// a plain C interface for ctypes (built by ops/cuda/_build.py).
//
// Replaces the six Pallas TPU kernels of paddle_tpu/ops/pallas/
// flash_attention.py and head_flash.py:
//   flash_fwd_{kernel,tc}      <- _fwd_kernel     (launched by _flash_fwd)
//   flash_bwd_dq_{kernel,tc}   <- _bwd_dq_kernel  (by _flash_bwd_impl)
//   flash_bwd_dkv_{kernel,tc}  <- _bwd_dkv_kernel (by _flash_bwd_impl)
// through the pt_flash_* entries, and the head-batched
//   _hb_fwd_kernel (by _hb_fwd), _hb_dq_kernel, _hb_dkv_kernel (by
//   _hb_bwd_impl)
// through the pt_hb_* entries, with the same arithmetic: fp32 scores,
// bottom-right causal masking (query row r sees key c iff c <= r + sk -
// sq, and c > r + sk - sq - window when a sliding window is set), masked
// scores set to the finite -1e30 of the reference, an fp32 streaming
// softmax, lse = m + log(max(l, 1e-30)), rows that see no key output
// exactly 0, and the backward recomputes p = exp(s - lse) (0 where lse
// <= -0.5e30) with ds = p * (dO.V^T - delta) * scale.
//
// Variants (template flags KM and DROP of every kernel, so the plain
// path's code is unchanged):
//   - KM: an additive fp32 key row is added to the scores after the
//     scale (after the causal mask), read at km + b * km_b + h * km_h:
//     one row per query head for pt_flash_* ([b * h, 1, sk]), one per
//     batch row for pt_hb_* ([b, 1, sk], km_h = 0). The dK/dV kernels
//     also return its gradient dmask = sum over query rows of ds / scale,
//     per query head (pt_flash_bwd_dkv) or summed over all heads too
//     (pt_hb_bwd_dkv), in registers and without atomics.
//   - DROP: the reference's counter-hash dropout (_keep_mask): a murmur3
//     fmix32 of the global (query head b * H + h, row, col) and two seed
//     words in uint32 arithmetic, keep iff hash >= threshold (computed
//     on the host as min(int(rate * 2^32), 2^32 - 1)). The row sum l keeps
//     the undropped p; only P.V takes p * keep / (1 - rate). The backward
//     scales dp by the same mask before ds and uses the dropped p for dV.
//     The bits are a pure function of those coordinates, so every kernel
//     and every tile shape regenerates the same mask, bit for bit with
//     the TPU kernels and the plain versions.
//
// Layout. q is read as [b, sq, h, d] and k/v as [b, sk, h_kv, d] through
// their (batch, seq, head) strides with a unit last stride, so the
// caller's [b, s, h, d] tensors (views of the fused QKV projection
// included) need no transpose. GQA: q head hq reads kv head hq / (h /
// h_kv). lse and delta are [b * h, sq] fp32.
//
// Design. The TPU grid runs its minor dimension in order and carries the
// softmax state (or the dQ / dK / dV sums) in VMEM scratch from one grid
// step to the next. Here one thread block owns one output tile and loops
// over the other dimension itself:
//   forward, dQ: one block per (64 query rows, q head), looping over the
//     key tiles that intersect the (causal, window) band;
//   dK/dV: one block per (64 keys, kv head), looping over the group's q
//     heads x the query tiles that intersect the band. No atomics: the
//     result is deterministic. The head-batched dK/dV (pt_hb_bwd_dkv)
//     has one block per (64 keys, batch row) that also loops over the kv
//     heads, so its per-batch dmask sums over every query head inside
//     the block: the TPU kernel's in-tile head reduction, on a grid of
//     ceil(sk / 64) x b blocks (512 at b64 s512).
// Tiles are staged in shared memory in the input's type with 16-byte
// global loads. Ragged edges (sq or sk not a multiple of the tile) are
// masked in the kernel, so any sequence length >= 1 works; d is any
// multiple of 8 up to 256. Two families share that plan:
//   - bf16 with d <= 128 (the training step's case) runs on the tensor
//     cores: each warp owns 16 rows and computes its products with
//     mma.sync.m16n8k16 (bf16 operands, fp32 accumulators), keeping
//     scores and the softmax state in registers (namespace tc below);
//   - fp32, and bf16 with d > 128, run on the fp32 CUDA cores: 256
//     threads form a 16 x 16 grid, each owning a micro-tile of scores and
//     of the fp32 output sums, with row maxima and sums reduced over
//     half-warps by shuffles. fp32 keeps full fp32 products, so the
//     card's results match the CPU's plain versions to fp32 rounding.
//
// What bounds it. At the headline shape (b8, s1024, h12, d128, bf16,
// causal) the forward does about 26 GFLOP against about 100 MB moved:
// 260 flop/byte, at the card's bf16 ridge (~295), so the bound is about
// 0.03 ms either way, and the backward kernels (39 and 52 GFLOP) are
// bound by operations. mma.sync reaches only part of the tensor cores'
// rate (wgmma is the full-rate path), and these kernels do not overlap
// loads with compute. Known gaps, left to later work: wgmma, TMA loads
// into a ring of tiles with warp specialisation, a persistent grid, and
// tensor-core paths for fp32 (TF32 would break the fp32 identity with the
// CPU) and d = 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // a 16 x 16 grid of threads
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Row stride of a [rows, DMAX] shared tile, in elements: the row length
// in 32-bit words is odd, so a column read across 16 rows is
// conflict-free.
template <typename T, int DMAX>
__host__ __device__ constexpr int tile_ld() {
  return DMAX + (sizeof(T) == 4 ? 1 : 2);
}

struct Strides {
  long long b, s, h;  // elements; the last dim is contiguous
};

struct Geom {
  int B, H, HKV, SQ, SK, d, causal, window;
  float scale;
  // the variants (read only under the KM / DROP template flags)
  const float* km;  // additive key row of (b, h): km + b * km_b + h * km_h
  float* dm;        // its gradient, addressed the same way
  long long km_b, km_h;
  uint32_t seed0, seed1, thresh;  // dropout: seed words, keep threshold
  float dscale;                   // 1 / (1 - rate), rounded on the host
  // dK/dV: one block per (key tile, batch row) over all kv heads, so the
  // batch row's dmask is summed in the block; set only with such a mask
  int hb;
};

// The dropout hash of one query head: everything but (row, col).
__device__ __forceinline__ uint32_t head_salt(const Geom& g, int bh) {
  return g.seed0 * 0x9E3779B9u + (uint32_t)(bh + 1) * 0x85EBCA6Bu + g.seed1;
}

// Whether element (r, c) of the head with salt `salt` is kept: the
// reference's _keep_mask (global row r, global key c).
__device__ __forceinline__ bool keep(const Geom& g, uint32_t salt, int r,
                                     int c) {
  uint32_t x = (uint32_t)r * 0x27D4EB2Fu + (uint32_t)c * 0x165667B1u + salt;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= g.thresh;
}

__device__ __forceinline__ const float* km_row(const Geom& g, int b, int h) {
  return g.km + b * g.km_b + h * g.km_h;
}

// Copy rows [row0, row0 + R) of one (batch, head) slice into a shared
// [R, LD] tile in 16-byte vectors; rows at or past `rows` become zeros.
template <typename T, int R, int LD>
__device__ __forceinline__ void load_tile(T* sm, const T* __restrict__ g,
                                          long long row_stride, int row0,
                                          int rows, int d) {
  constexpr int kVec = 16 / sizeof(T);
  const int vpr = d / kVec;
  for (int idx = threadIdx.x; idx < R * vpr; idx += kThreads) {
    const int r = idx / vpr;
    const int c = (idx - r * vpr) * kVec;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows)
      raw = *reinterpret_cast<const uint4*>(
          g + (long long)(row0 + r) * row_stride + c);
    const T* e = reinterpret_cast<const T*>(&raw);
    T* dst = sm + r * LD + c;
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[i] = e[i];
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Whether query row r sees key c (both global, c < SK).
__device__ __forceinline__ bool visible(const Geom& g, int r, int c) {
  if (!g.causal) return true;
  const int diag = r + g.SK - g.SQ;
  return c <= diag && (g.window <= 0 || c > diag - g.window);
}

// Key tiles [*kt0, *kt1) that intersect the band of query rows
// [r0, min(r0 + BQ, SQ)).
template <int BQ, int BK>
__device__ __forceinline__ void key_tiles(const Geom& g, int r0, int* kt0,
                                          int* kt1) {
  *kt0 = 0;
  *kt1 = (g.SK + BK - 1) / BK;
  if (!g.causal) return;
  const int offset = g.SK - g.SQ;
  const int rmax = min(r0 + BQ, g.SQ) - 1;
  const int cmax = min(g.SK - 1, rmax + offset);
  *kt1 = cmax < 0 ? 0 : cmax / BK + 1;
  if (g.window > 0) {
    const int cmin = r0 + offset - g.window + 1;
    if (cmin > 0) *kt0 = cmin / BK;
  }
}

// Query tiles [*qt0, *qt1) that intersect the band of keys
// [c0, min(c0 + BK, SK)).
template <int BQ, int BK>
__device__ __forceinline__ void query_tiles(const Geom& g, int c0, int* qt0,
                                            int* qt1) {
  *qt0 = 0;
  *qt1 = (g.SQ + BQ - 1) / BQ;
  if (!g.causal) return;
  const int offset = g.SK - g.SQ;
  const int rmin = max(0, c0 - offset);
  *qt0 = rmin / BQ;
  if (g.window > 0) {
    const int cmax = min(c0 + BK, g.SK) - 1;
    const int rmax = min(g.SQ - 1, cmax - offset + g.window - 1);
    *qt1 = rmax < 0 ? 0 : rmax / BQ + 1;
  }
}

// ---------------------------------------------------------------------------
// Forward: O and lse. grid = (ceil(SQ / BQ), B * H).
template <typename T, int DMAX, int BQ, int BK, bool KM, bool DROP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Geom g, Strides sq_, Strides sk_,
                 Strides sv_, Strides so_) {
  constexpr int LD = tile_ld<T, DMAX>();
  constexpr int LDP = BK + 1;
  constexpr int RM = BQ / 16, CN = BK / 16, DN = DMAX / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // [BQ, LD]
  T* sKV = sQ + BQ * LD;                   // [BK, LD]  K, then V
  float* sP = reinterpret_cast<float*>(sKV + BK * LD);  // [BQ, LDP]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int b = bh / g.H, h = bh - b * g.H;
  const int hk = h / (g.H / g.HKV);
  const int r0 = blockIdx.x * BQ;
  const int d = g.d;
  const T* kg = k + b * sk_.b + hk * sk_.h;
  const T* vg = v + b * sv_.b + hk * sv_.h;
  const float* kmr = KM ? km_row(g, b, h) : nullptr;
  const uint32_t salt = DROP ? head_salt(g, bh) : 0u;
  load_tile<T, BQ, LD>(sQ, q + b * sq_.b + h * sq_.h, sq_.s, r0, g.SQ, d);

  float m[RM], l[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }
  int kt0, kt1;
  key_tiles<BQ, BK>(g, r0, &kt0, &kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int c0 = kt * BK;
    __syncthreads();  // the previous tile is done with sKV and sP
    load_tile<T, BK, LD>(sKV, kg, sk_.s, c0, g.SK, d);
    __syncthreads();
    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
    for (int kk = 0; kk < d; ++kk) {
      float a[RM], bk[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        a[i] = to_f32(sQ[(ty + 16 * i) * LD + kk]) * g.scale;
#pragma unroll
      for (int j = 0; j < CN; ++j) bk[j] = to_f32(sKV[(tx + 16 * j) * LD + kk]);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = r0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int c = c0 + tx + 16 * j;
        // keys past SK do not exist (weight exactly 0); masked keys get
        // the reference's finite -1e30, then the additive key row
        float x = s[i][j];
        if (c >= g.SK) {
          x = -INFINITY;
        } else {
          if (!visible(g, r, c)) x = kNegInf;
          if (KM) x += kmr[c];
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;  // the row sum keeps the undropped p
        float pa = p;
        if (DROP) pa = keep(g, salt, r, c0 + tx + 16 * j) ? p * g.dscale : 0.f;
        sP[(ty + 16 * i) * LDP + tx + 16 * j] = pa;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // sP complete; K no longer read
    load_tile<T, BK, LD>(sKV, vg, sv_.s, c0, g.SK, d);
    __syncthreads();
    for (int c = 0; c < BK; ++c) {
      float p[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) p[i] = sP[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        if (tx + 16 * j < d) {
          const float vv = to_f32(sKV[c * LD + tx + 16 * j]);
#pragma unroll
          for (int i = 0; i < RM; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= g.SQ) continue;
    // m stays at -1e30 iff the row saw no key: it outputs exactly 0
    const bool valid = m[i] > 0.5f * kNegInf;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* orow = o + b * so_.b + (long long)r * so_.s + h * so_.h;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      const int col = tx + 16 * j;
      if (col < d) orow[col] = from_f32<T>(valid ? acc[i][j] / l_safe : 0.f);
    }
    if (tx == 0) lse[(long long)bh * g.SQ + r] = m[i] + logf(l_safe);
  }
}

// Scores and dO.V^T of one (query tile, key tile) pair, turned into p
// and ds = p * (dp - delta) * scale for the thread's micro-tile (query
// rows ty + 16 i, keys tx + 16 j). With DROP, dp is masked and scaled
// before ds, and p comes back dropped (the operand of dV).
template <typename T, int LD, int RM, int CN, bool KM, bool DROP>
__device__ __forceinline__ void probs_and_ds(
    const Geom& g, const T* sQ, const T* sdO, const T* sK, const T* sV,
    int r0, int c0, const float* lse_r, const float* delta_r, int tx, int ty,
    const float* kmr, uint32_t salt, float (&p)[RM][CN],
    float (&ds)[RM][CN]) {
  float s[RM][CN], dp[RM][CN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int kk = 0; kk < g.d; ++kk) {
    float a[RM], ad[RM], bk[CN], bv[CN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      a[i] = to_f32(sQ[(ty + 16 * i) * LD + kk]);
      ad[i] = to_f32(sdO[(ty + 16 * i) * LD + kk]);
    }
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      bk[j] = to_f32(sK[(tx + 16 * j) * LD + kk]);
      bv[j] = to_f32(sV[(tx + 16 * j) * LD + kk]);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        s[i][j] = fmaf(a[i], bk[j], s[i][j]);
        dp[i][j] = fmaf(ad[i], bv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = r0 + ty + 16 * i;
    // rows that saw no key in the forward have lse ~ -1e30: p = 0
    const bool row_ok = lse_r[i] > 0.5f * kNegInf;
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int c = c0 + tx + 16 * j;
      // a masked score is -1e30 and exp(-1e30 - lse) is exactly 0
      const bool live = row_ok && c < g.SK && visible(g, r, c);
      float x = g.scale * s[i][j];
      if (KM && live) x += kmr[c];
      const float pv = live ? expf(x - lse_r[i]) : 0.f;
      float dpv = dp[i][j], pd = pv;
      if (DROP) {
        const float dmk = keep(g, salt, r, c) ? g.dscale : 0.f;
        dpv *= dmk;
        pd = pv * dmk;
      }
      p[i][j] = pd;
      ds[i][j] = pv * (dpv - delta_r[i]) * g.scale;
    }
  }
}

// ---------------------------------------------------------------------------
// dQ. grid = (ceil(SQ / BQ), B * H).
template <typename T, int DMAX, int BQ, int BK, bool KM, bool DROP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Geom g, Strides sq_, Strides sk_, Strides sv_,
                    Strides sdo_, Strides sdq_) {
  constexpr int LD = tile_ld<T, DMAX>();
  constexpr int LDP = BK + 1;
  constexpr int RM = BQ / 16, CN = BK / 16, DN = DMAX / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // [BQ, LD]
  T* sdO = sQ + BQ * LD;                   // [BQ, LD]
  T* sK = sdO + BQ * LD;                   // [BK, LD]
  T* sV = sK + BK * LD;                    // [BK, LD]
  float* sDS = reinterpret_cast<float*>(sV + BK * LD);  // [BQ, LDP]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int b = bh / g.H, h = bh - b * g.H;
  const int hk = h / (g.H / g.HKV);
  const int r0 = blockIdx.x * BQ;
  const int d = g.d;
  const T* kg = k + b * sk_.b + hk * sk_.h;
  const T* vg = v + b * sv_.b + hk * sv_.h;
  const float* kmr = KM ? km_row(g, b, h) : nullptr;
  const uint32_t salt = DROP ? head_salt(g, bh) : 0u;
  load_tile<T, BQ, LD>(sQ, q + b * sq_.b + h * sq_.h, sq_.s, r0, g.SQ, d);
  load_tile<T, BQ, LD>(sdO, dout + b * sdo_.b + h * sdo_.h, sdo_.s, r0,
                       g.SQ, d);
  float lse_r[RM], delta_r[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = r0 + ty + 16 * i;
    lse_r[i] = r < g.SQ ? lse[(long long)bh * g.SQ + r] : kNegInf;
    delta_r[i] = r < g.SQ ? delta[(long long)bh * g.SQ + r] : 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }
  int kt0, kt1;
  key_tiles<BQ, BK>(g, r0, &kt0, &kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int c0 = kt * BK;
    __syncthreads();  // the previous tile is done with sK, sV and sDS
    load_tile<T, BK, LD>(sK, kg, sk_.s, c0, g.SK, d);
    load_tile<T, BK, LD>(sV, vg, sv_.s, c0, g.SK, d);
    __syncthreads();
    float p[RM][CN], ds[RM][CN];
    probs_and_ds<T, LD, RM, CN, KM, DROP>(g, sQ, sdO, sK, sV, r0, c0, lse_r,
                                          delta_r, tx, ty, kmr, salt, p, ds);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j)
        sDS[(ty + 16 * i) * LDP + tx + 16 * j] = ds[i][j];
    __syncthreads();
    for (int c = 0; c < BK; ++c) {
      float a[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = sDS[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        if (tx + 16 * j < d) {
          const float kv = to_f32(sK[c * LD + tx + 16 * j]);
#pragma unroll
          for (int i = 0; i < RM; ++i) acc[i][j] = fmaf(a[i], kv, acc[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= g.SQ) continue;
    T* row = dq + b * sdq_.b + (long long)r * sdq_.s + h * sdq_.h;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      const int col = tx + 16 * j;
      if (col < d) row[col] = from_f32<T>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// dK and dV. grid = (ceil(SK / BK), B * HKV), or (ceil(SK / BK), B) with
// g.hb, where the block also loops over the kv heads. The block sums
// over the h / h_kv query heads of each kv head and their live query
// tiles. With KM it sums dmask = sum_rows ds / scale for its keys too:
// per query head (written after each head), or with g.hb over every
// head of the batch row (written once at the end).
template <typename T, int DMAX, int BQ, int BK, bool KM, bool DROP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, Geom g, Strides sq_, Strides sk_,
                     Strides sv_, Strides sdo_, Strides sdk_, Strides sdv_) {
  constexpr int LD = tile_ld<T, DMAX>();
  constexpr int LDP = BK + 1;
  constexpr int RM = BQ / 16, CN = BK / 16, DN = DMAX / 16;
  constexpr int KR = BK / 16;  // key rows per thread in the dK/dV sums
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);  // [BK, LD]
  T* sV = sK + BK * LD;                    // [BK, LD]
  T* sQ = sV + BK * LD;                    // [BQ, LD]
  T* sdO = sQ + BQ * LD;                   // [BQ, LD]
  float* sP = reinterpret_cast<float*>(sdO + BQ * LD);  // [BQ, LDP]
  float* sDS = sP + BQ * LDP;                           // [BQ, LDP]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = g.hb ? blockIdx.y : blockIdx.y / g.HKV;
  const int hk0 = g.hb ? 0 : blockIdx.y - b * g.HKV;
  const int hk1 = g.hb ? g.HKV : hk0 + 1;
  const int group = g.H / g.HKV;
  const int c0 = blockIdx.x * BK;
  const int d = g.d;
  // this thread's key column of dmask (threads 0..BK-1), summed in
  // registers in a fixed order
  const int mc = c0 + threadIdx.x;
  float dm_acc = 0.f;
  int qt0, qt1;
  query_tiles<BQ, BK>(g, c0, &qt0, &qt1);
  for (int hk = hk0; hk < hk1; ++hk) {
    __syncthreads();  // the previous kv head is done with sK and sV
    load_tile<T, BK, LD>(sK, k + b * sk_.b + hk * sk_.h, sk_.s, c0, g.SK, d);
    load_tile<T, BK, LD>(sV, v + b * sv_.b + hk * sv_.h, sv_.s, c0, g.SK, d);
    float acc_k[KR][DN], acc_v[KR][DN];
#pragma unroll
    for (int i = 0; i < KR; ++i)
#pragma unroll
      for (int j = 0; j < DN; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;
    for (int gi = 0; gi < group; ++gi) {
      const int h = hk * group + gi;
      const long long bh = (long long)b * g.H + h;
      const T* qg = q + b * sq_.b + h * sq_.h;
      const T* dog = dout + b * sdo_.b + h * sdo_.h;
      const float* kmr = KM ? km_row(g, b, h) : nullptr;
      const uint32_t salt = DROP ? head_salt(g, (int)bh) : 0u;
      for (int qt = qt0; qt < qt1; ++qt) {
        const int r0 = qt * BQ;
        __syncthreads();  // the previous tile is done with sQ, sdO, sP, sDS
        load_tile<T, BQ, LD>(sQ, qg, sq_.s, r0, g.SQ, d);
        load_tile<T, BQ, LD>(sdO, dog, sdo_.s, r0, g.SQ, d);
        __syncthreads();
        float lse_r[RM], delta_r[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const int r = r0 + ty + 16 * i;
          lse_r[i] = r < g.SQ ? lse[bh * g.SQ + r] : kNegInf;
          delta_r[i] = r < g.SQ ? delta[bh * g.SQ + r] : 0.f;
        }
        float p[RM][CN], ds[RM][CN];
        probs_and_ds<T, LD, RM, CN, KM, DROP>(g, sQ, sdO, sK, sV, r0, c0,
                                              lse_r, delta_r, tx, ty, kmr,
                                              salt, p, ds);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) {
            sP[(ty + 16 * i) * LDP + tx + 16 * j] = p[i][j];
            sDS[(ty + 16 * i) * LDP + tx + 16 * j] = ds[i][j];
          }
        __syncthreads();
        if (KM && threadIdx.x < BK)
          for (int rr = 0; rr < BQ; ++rr)
            dm_acc += sDS[rr * LDP + threadIdx.x];
        // dV += P^T dO and dK += dS^T Q over this tile's query rows
        for (int rr = 0; rr < BQ; ++rr) {
          float pa[KR], da[KR];
#pragma unroll
          for (int i = 0; i < KR; ++i) {
            pa[i] = sP[rr * LDP + ty + 16 * i];
            da[i] = sDS[rr * LDP + ty + 16 * i];
          }
#pragma unroll
          for (int j = 0; j < DN; ++j) {
            if (tx + 16 * j < d) {
              const float dov = to_f32(sdO[rr * LD + tx + 16 * j]);
              const float qv = to_f32(sQ[rr * LD + tx + 16 * j]);
#pragma unroll
              for (int i = 0; i < KR; ++i) {
                acc_v[i][j] = fmaf(pa[i], dov, acc_v[i][j]);
                acc_k[i][j] = fmaf(da[i], qv, acc_k[i][j]);
              }
            }
          }
        }
      }
      if (KM && !g.hb) {  // this query head's dmask row
        if (threadIdx.x < BK && mc < g.SK)
          g.dm[b * g.km_b + h * g.km_h + mc] = dm_acc / g.scale;
        dm_acc = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < KR; ++i) {
      const int c = c0 + ty + 16 * i;
      if (c >= g.SK) continue;
      T* krow = dk + b * sdk_.b + (long long)c * sdk_.s + hk * sdk_.h;
      T* vrow = dv + b * sdv_.b + (long long)c * sdv_.s + hk * sdv_.h;
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        const int col = tx + 16 * j;
        if (col < d) {
          krow[col] = from_f32<T>(acc_k[i][j]);
          vrow[col] = from_f32<T>(acc_v[i][j]);
        }
      }
    }
  }
  if (KM && g.hb && threadIdx.x < BK && mc < g.SK)  // the batch row's dmask
    g.dm[b * g.km_b + mc] = dm_acc / g.scale;
}

// ---------------------------------------------------------------------------
// Tensor-core kernels: bf16 with d <= 128. The same grids, masks and
// arithmetic as above, but each warp owns 16 rows of the output tile and
// computes its products with mma.sync.m16n8k16 (bf16 operands, fp32
// accumulators). Scores, probabilities and the softmax state stay in
// registers. The forward's P enters P.V as two bf16 terms (hi + lo), so
// O is as exact as fp32 P would make it; in the backward P and dS are
// rounded to bf16 once as operands of the next product, as
// FlashAttention-2 does. Tiles are padded by 8 elements per
// row (16 bytes) so ldmatrix and the 32-bit fragment loads hit distinct
// banks; columns d..DMAX are zero-filled so the contraction over the
// head dimension runs in whole k16 steps.
namespace tc {

typedef __nv_bfloat16 bf16;
constexpr int kWarps = 4;
constexpr int kThreadsTc = 32 * kWarps;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) as a bf16 pair hi plus the bf16 pair lo of what hi rounded
// away: hi + lo carries ~16 bits of each value.
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack(x0 - hf.x, x1 - hf.y);
}

// c += a * b for one 16 x 8 fp32 tile.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (16 x 16) of a row-major shared tile: rows r0.., cols k0..
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* s,
                                       int r0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  a[0] = ld32(s + (r0 + g) * LD + k0 + 2 * t);
  a[1] = ld32(s + (r0 + g + 8) * LD + k0 + 2 * t);
  a[2] = ld32(s + (r0 + g) * LD + k0 + 2 * t + 8);
  a[3] = ld32(s + (r0 + g + 8) * LD + k0 + 2 * t + 8);
}

// B fragment (16 x 8) with B[k][n] = M[n0 + n][k0 + k], M row-major: the
// product contracts over M's columns (Q.K^T, dO.V^T).
template <int LD>
__device__ __forceinline__ void frag_b_rows(uint32_t& b0, uint32_t& b1,
                                            const bf16* m, int n0, int k0,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
  b0 = ld32(m + (n0 + g) * LD + k0 + 2 * t);
  b1 = ld32(m + (n0 + g) * LD + k0 + 2 * t + 8);
}

// B fragments of two 16 x 8 tiles with B[k][n] = M[k0 + k][n0 + n], M
// row-major: the product contracts over M's rows (P.V, dS.K, P^T.dO,
// dS^T.Q). ldmatrix .trans reads the 8 x 8 blocks transposed.
template <int LD>
__device__ __forceinline__ void frag_b_cols(uint32_t (&b)[4], const bf16* m,
                                            int k0, int n0, int lane) {
  const bf16* p = m + (k0 + (lane & 15)) * LD + n0 + (lane >> 4) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(smem_addr(p)));
}

// Rows [row0, row0 + R) of one (batch, head) slice into a shared [R, LD]
// tile in 16-byte vectors; rows past `rows` and columns d..DMAX are 0.
template <int R, int LD, int DMAX>
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* __restrict__ g,
                                          long long row_stride, int row0,
                                          int rows, int d) {
  constexpr int kVpr = DMAX / 8;
  for (int idx = threadIdx.x; idx < R * kVpr; idx += kThreadsTc) {
    const int r = idx / kVpr;
    const int c = (idx - r * kVpr) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows && c < d)
      raw = *reinterpret_cast<const uint4*>(
          g + (long long)(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(sm + r * LD + c) = raw;
  }
}

// Forward. grid = (ceil(SQ / 64), B * H), 4 warps of 16 query rows.
template <int DMAX, bool KM, bool DROP>
__global__ void __launch_bounds__(kThreadsTc)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o,
             float* __restrict__ lse, Geom g, Strides sq_, Strides sk_,
             Strides sv_, Strides so_) {
  constexpr int BQ = 64, BK = 64, LD = DMAX + 8;
  constexpr int KS = DMAX / 16, NT = BK / 8, DT = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BQ, LD]
  bf16* sK = sQ + BQ * LD;                       // [BK, LD]
  bf16* sV = sK + BK * LD;                       // [BK, LD]
  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) * 16;
  const int gq = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / g.H, h = bh - b * g.H;
  const int hk = h / (g.H / g.HKV);
  const int r0 = blockIdx.x * BQ;
  const bf16* kg = k + b * sk_.b + hk * sk_.h;
  const bf16* vg = v + b * sv_.b + hk * sv_.h;
  const float* kmr = KM ? km_row(g, b, h) : nullptr;
  const uint32_t salt = DROP ? head_salt(g, bh) : 0u;
  load_tile<BQ, LD, DMAX>(sQ, q + b * sq_.b + h * sq_.h, sq_.s, r0, g.SQ,
                          g.d);
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows gq, gq + 8
  int kt0, kt1;
  key_tiles<BQ, BK>(g, r0, &kt0, &kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int c0 = kt * BK;
    __syncthreads();
    load_tile<BK, LD, DMAX>(sK, kg, sk_.s, c0, g.SK, g.d);
    load_tile<BK, LD, DMAX>(sV, vg, sv_.s, c0, g.SK, g.d);
    __syncthreads();
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      frag_a<LD>(a, sQ, wr, 16 * ks, lane);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t b0, b1;
        frag_b_rows<LD>(b0, b1, sK, 8 * j, 16 * ks, lane);
        mma(s[j], a, b0, b1);
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + wr + gq + (e >> 1) * 8;
        const int c = c0 + 8 * j + 2 * tq + (e & 1);
        float x = s[j][e] * g.scale;
        if (c >= g.SK) {
          x = -INFINITY;
        } else {
          if (!visible(g, r, c)) x = kNegInf;
          if (KM) x += kmr[c];
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];  // this thread's share of the row sum
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];  // the row sum keeps the undropped p
        if (DROP)
          s[j][e] = keep(g, salt, r0 + wr + gq + (e >> 1) * 8,
                         c0 + 8 * j + 2 * tq + (e & 1))
                        ? s[j][e] * g.dscale
                        : 0.f;
      }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    // O += P.V with P as hi + lo bf16 terms, so O keeps ~16 bits of P
    // (the reference multiplies in fp32; one bf16 rounding of P would
    // cost O up to 2^-9 of its size)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t bb[4];
        frag_b_cols<LD>(bb, sV, 16 * kk, 8 * j, lane);
        mma(acc[j], hi, bb[0], bb[1]);
        mma(acc[j], lo, bb[0], bb[1]);
        mma(acc[j + 1], hi, bb[2], bb[3]);
        mma(acc[j + 1], lo, bb[2], bb[3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = r0 + wr + gq + 8 * i;
    if (r >= g.SQ) continue;
    const bool valid = m[i] > 0.5f * kNegInf;
    const float l_safe = fmaxf(l[i], 1e-30f);
    bf16* orow = o + b * so_.b + (long long)r * so_.s + h * so_.h;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int col = 8 * j + 2 * tq;
      if (col < g.d)
        *reinterpret_cast<uint32_t*>(orow + col) =
            valid ? pack(acc[j][2 * i] / l_safe, acc[j][2 * i + 1] / l_safe)
                  : 0u;
    }
    if (tq == 0) lse[(long long)bh * g.SQ + r] = m[i] + logf(l_safe);
  }
}

// p and ds of a warp's 16 x (8 * NT) tile from raw scores s and dO.V^T
// products dp, in place: s becomes p, dp becomes ds. Row i of the tile
// is (row0 + gq + 8 * (e >> 1)), column (col0 + 8 * j + 2 * tq + (e & 1)).
// kRowsAreQueries: rows index queries (dQ kernel); otherwise rows index
// keys and columns queries (dK/dV kernel). lse and delta are looked up
// per query through `stat`. With KM the key row kmr is added to the
// scaled scores; with DROP, dp is masked and scaled before ds and s
// becomes the dropped p (the operand of dV).
template <int NT, bool kRowsAreQueries, bool KM, bool DROP, typename Stat>
__device__ __forceinline__ void probs_ds(const Geom& g, float (&s)[NT][4],
                                         float (&dp)[NT][4], int row0,
                                         int col0, int gq, int tq,
                                         const float* kmr, uint32_t salt,
                                         Stat stat) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = row0 + gq + (e >> 1) * 8;
      const int cc = col0 + 8 * j + 2 * tq + (e & 1);
      const int qr = kRowsAreQueries ? rr : cc;
      const int kc = kRowsAreQueries ? cc : rr;
      float lse_q, delta_q;
      stat(kRowsAreQueries ? (e >> 1) : 8 * j + 2 * tq + (e & 1), &lse_q,
           &delta_q);
      const bool live = lse_q > 0.5f * kNegInf && kc < g.SK && qr < g.SQ &&
                        visible(g, qr, kc);
      float x = g.scale * s[j][e];
      if (KM && live) x += kmr[kc];
      const float p = live ? expf(x - lse_q) : 0.f;
      float dpv = dp[j][e], pd = p;
      if (DROP) {  // dp masked and scaled before ds; dV takes the dropped p
        const float dmk = keep(g, salt, qr, kc) ? g.dscale : 0.f;
        dpv *= dmk;
        pd = p * dmk;
      }
      s[j][e] = pd;
      dp[j][e] = p * (dpv - delta_q) * g.scale;
    }
}

// dQ. grid = (ceil(SQ / 64), B * H), 4 warps of 16 query rows.
template <int DMAX, bool KM, bool DROP>
__global__ void __launch_bounds__(kThreadsTc)
flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq,
                Geom g, Strides sq_, Strides sk_, Strides sv_, Strides sdo_,
                Strides sdq_) {
  constexpr int BQ = 64, BK = 64, LD = DMAX + 8;
  constexpr int KS = DMAX / 16, NT = BK / 8, DT = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BQ, LD]
  bf16* sdO = sQ + BQ * LD;                      // [BQ, LD]
  bf16* sK = sdO + BQ * LD;                      // [BK, LD]
  bf16* sV = sK + BK * LD;                       // [BK, LD]
  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) * 16;
  const int gq = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / g.H, h = bh - b * g.H;
  const int hk = h / (g.H / g.HKV);
  const int r0 = blockIdx.x * BQ;
  const bf16* kg = k + b * sk_.b + hk * sk_.h;
  const bf16* vg = v + b * sv_.b + hk * sv_.h;
  const float* kmr = KM ? km_row(g, b, h) : nullptr;
  const uint32_t salt = DROP ? head_salt(g, bh) : 0u;
  load_tile<BQ, LD, DMAX>(sQ, q + b * sq_.b + h * sq_.h, sq_.s, r0, g.SQ,
                          g.d);
  load_tile<BQ, LD, DMAX>(sdO, dout + b * sdo_.b + h * sdo_.h, sdo_.s, r0,
                          g.SQ, g.d);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + wr + gq + 8 * i;
    lse_r[i] = r < g.SQ ? lse[(long long)bh * g.SQ + r] : kNegInf;
    delta_r[i] = r < g.SQ ? delta[(long long)bh * g.SQ + r] : 0.f;
  }
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  int kt0, kt1;
  key_tiles<BQ, BK>(g, r0, &kt0, &kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int c0 = kt * BK;
    __syncthreads();
    load_tile<BK, LD, DMAX>(sK, kg, sk_.s, c0, g.SK, g.d);
    load_tile<BK, LD, DMAX>(sV, vg, sv_.s, c0, g.SK, g.d);
    __syncthreads();
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t aq[4], ad[4];
      frag_a<LD>(aq, sQ, wr, 16 * ks, lane);
      frag_a<LD>(ad, sdO, wr, 16 * ks, lane);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t b0, b1;
        frag_b_rows<LD>(b0, b1, sK, 8 * j, 16 * ks, lane);
        mma(s[j], aq, b0, b1);
        frag_b_rows<LD>(b0, b1, sV, 8 * j, 16 * ks, lane);
        mma(dp[j], ad, b0, b1);
      }
    }
    probs_ds<NT, true, KM, DROP>(g, s, dp, r0 + wr, c0, gq, tq, kmr, salt,
                                 [&](int i, float* ls, float* dl) {
                                   *ls = lse_r[i];
                                   *dl = delta_r[i];
                                 });
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack(dp[2 * kk][0], dp[2 * kk][1]),
                             pack(dp[2 * kk][2], dp[2 * kk][3]),
                             pack(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                             pack(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t bb[4];
        frag_b_cols<LD>(bb, sK, 16 * kk, 8 * j, lane);
        mma(acc[j], a, bb[0], bb[1]);
        mma(acc[j + 1], a, bb[2], bb[3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + wr + gq + 8 * i;
    if (r >= g.SQ) continue;
    bf16* row = dq + b * sdq_.b + (long long)r * sdq_.s + h * sdq_.h;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int col = 8 * j + 2 * tq;
      if (col < g.d)
        *reinterpret_cast<uint32_t*>(row + col) =
            pack(acc[j][2 * i], acc[j][2 * i + 1]);
    }
  }
}

// dK and dV. grid = (ceil(SK / 64), B * HKV), 4 warps of 16 keys; the
// block sweeps its group's q heads x 32-row query tiles. With g.hb the
// grid is (ceil(SK / 64), B) and the block also loops over the kv heads.
// With KM each thread sums ds over the query columns of its two keys in
// registers; the four lanes of a key row are reduced by shuffles when a
// dmask row is written (per query head, or with g.hb once per batch row).
template <int DMAX, bool KM, bool DROP>
__global__ void __launch_bounds__(kThreadsTc)
flash_bwd_dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, Geom g, Strides sq_, Strides sk_,
                 Strides sv_, Strides sdo_, Strides sdk_, Strides sdv_) {
  constexpr int BQ = 32, BK = 64, LD = DMAX + 8;
  constexpr int KS = DMAX / 16, NT = BQ / 8, DT = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [BK, LD]
  bf16* sV = sK + BK * LD;                       // [BK, LD]
  bf16* sQ = sV + BK * LD;                       // [BQ, LD]
  bf16* sdO = sQ + BQ * LD;                      // [BQ, LD]
  float* sLse = reinterpret_cast<float*>(sdO + BQ * LD);  // [BQ]
  float* sDelta = sLse + BQ;                               // [BQ]
  const int lane = threadIdx.x & 31, wk = (threadIdx.x >> 5) * 16;
  const int gq = lane >> 2, tq = lane & 3;
  const int b = g.hb ? blockIdx.y : blockIdx.y / g.HKV;
  const int hk0 = g.hb ? 0 : blockIdx.y - b * g.HKV;
  const int hk1 = g.hb ? g.HKV : hk0 + 1;
  const int group = g.H / g.HKV;
  const int c0 = blockIdx.x * BK;
  float dm[2] = {0.f, 0.f};  // keys c0 + wk + gq and + 8: this lane's share
  // a dmask row (all lanes take part in the shuffles)
  auto write_dm = [&](long long row) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float x = dm[i];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      const int c = c0 + wk + gq + 8 * i;
      if (tq == 0 && c < g.SK) g.dm[row + c] = x / g.scale;
      dm[i] = 0.f;
    }
  };
  int qt0, qt1;
  query_tiles<BQ, BK>(g, c0, &qt0, &qt1);
  for (int hk = hk0; hk < hk1; ++hk) {
    __syncthreads();  // the previous kv head is done with sK and sV
    load_tile<BK, LD, DMAX>(sK, k + b * sk_.b + hk * sk_.h, sk_.s, c0, g.SK,
                            g.d);
    load_tile<BK, LD, DMAX>(sV, v + b * sv_.b + hk * sv_.h, sv_.s, c0, g.SK,
                            g.d);
    float acc_k[DT][4], acc_v[DT][4];
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;
    for (int gi = 0; gi < group; ++gi) {
      const int h = hk * group + gi;
      const long long bh = (long long)b * g.H + h;
      const bf16* qg = q + b * sq_.b + h * sq_.h;
      const bf16* dog = dout + b * sdo_.b + h * sdo_.h;
      const float* kmr = KM ? km_row(g, b, h) : nullptr;
      const uint32_t salt = DROP ? head_salt(g, (int)bh) : 0u;
      for (int qt = qt0; qt < qt1; ++qt) {
        const int r0 = qt * BQ;
        __syncthreads();
        load_tile<BQ, LD, DMAX>(sQ, qg, sq_.s, r0, g.SQ, g.d);
        load_tile<BQ, LD, DMAX>(sdO, dog, sdo_.s, r0, g.SQ, g.d);
        if (threadIdx.x < BQ) {
          const int r = r0 + threadIdx.x;
          sLse[threadIdx.x] = r < g.SQ ? lse[bh * g.SQ + r] : kNegInf;
          sDelta[threadIdx.x] = r < g.SQ ? delta[bh * g.SQ + r] : 0.f;
        }
        __syncthreads();
        // S^T = K.Q^T and dP^T = V.dO^T: rows are this warp's 16 keys
        float s[NT][4], dp[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t ak[4], av[4];
          frag_a<LD>(ak, sK, wk, 16 * ks, lane);
          frag_a<LD>(av, sV, wk, 16 * ks, lane);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            uint32_t b0, b1;
            frag_b_rows<LD>(b0, b1, sQ, 8 * j, 16 * ks, lane);
            mma(s[j], ak, b0, b1);
            frag_b_rows<LD>(b0, b1, sdO, 8 * j, 16 * ks, lane);
            mma(dp[j], av, b0, b1);
          }
        }
        probs_ds<NT, false, KM, DROP>(g, s, dp, c0 + wk, r0, gq, tq, kmr,
                                      salt,
                                      [&](int i, float* ls, float* dl) {
                                        *ls = sLse[i];
                                        *dl = sDelta[i];
                                      });
        if (KM) {
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) dm[e >> 1] += dp[j][e];
        }
        // dV += P^T.dO and dK += dS^T.Q over this tile's query rows
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          const uint32_t ap[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                                  pack(s[2 * kk][2], s[2 * kk][3]),
                                  pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                  pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
          const uint32_t ad[4] = {pack(dp[2 * kk][0], dp[2 * kk][1]),
                                  pack(dp[2 * kk][2], dp[2 * kk][3]),
                                  pack(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                                  pack(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
          for (int j = 0; j < DT; j += 2) {
            uint32_t bb[4];
            frag_b_cols<LD>(bb, sdO, 16 * kk, 8 * j, lane);
            mma(acc_v[j], ap, bb[0], bb[1]);
            mma(acc_v[j + 1], ap, bb[2], bb[3]);
            frag_b_cols<LD>(bb, sQ, 16 * kk, 8 * j, lane);
            mma(acc_k[j], ad, bb[0], bb[1]);
            mma(acc_k[j + 1], ad, bb[2], bb[3]);
          }
        }
      }
      if (KM && !g.hb) write_dm(b * g.km_b + h * g.km_h);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = c0 + wk + gq + 8 * i;
      if (c >= g.SK) continue;
      bf16* krow = dk + b * sdk_.b + (long long)c * sdk_.s + hk * sdk_.h;
      bf16* vrow = dv + b * sdv_.b + (long long)c * sdv_.s + hk * sdv_.h;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const int col = 8 * j + 2 * tq;
        if (col < g.d) {
          *reinterpret_cast<uint32_t*>(krow + col) =
              pack(acc_k[j][2 * i], acc_k[j][2 * i + 1]);
          *reinterpret_cast<uint32_t*>(vrow + col) =
              pack(acc_v[j][2 * i], acc_v[j][2 * i + 1]);
        }
      }
    }
  }
  if (KM && g.hb) write_dm(b * g.km_b);
}


// Shared-memory bytes of the tensor-core kernels.
template <int DMAX>
struct Smem {
  static constexpr size_t row = (DMAX + 8) * sizeof(bf16);
  static constexpr size_t fwd = 3 * 64 * row;
  static constexpr size_t dq = 4 * 64 * row;
  static constexpr size_t dkv = 2 * 64 * row + 2 * 32 * row + 2 * 32 * 4;
};

}  // namespace tc

// ---------------------------------------------------------------------------
// Host side: shared-memory sizes, launches and the dispatch on dtype and
// head_dim.

template <typename T, int DMAX, int BQ, int BK>
struct Cfg {
  static constexpr size_t q_tile = (size_t)BQ * tile_ld<T, DMAX>() * sizeof(T);
  static constexpr size_t k_tile = (size_t)BK * tile_ld<T, DMAX>() * sizeof(T);
  static constexpr size_t probs = (size_t)BQ * (BK + 1) * sizeof(float);
  static constexpr size_t fwd = q_tile + k_tile + probs;
  static constexpr size_t dq = 2 * q_tile + 2 * k_tile + probs;
  static constexpr size_t dkv = 2 * q_tile + 2 * k_tile + 2 * probs;
};

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

template <typename T, int DMAX, int BQ, int BK, bool KM, bool DROP>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, const Geom& g, const long long* st,
                cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, DMAX, BQ, BK, KM, DROP>;
  const size_t smem = Cfg<T, DMAX, BQ, BK>::fwd;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((g.SQ + BQ - 1) / BQ, g.B * g.H), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, g,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3));
  return cudaGetLastError();
}

template <typename T, int DMAX, int BQ, int BK, bool KM, bool DROP>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, const Geom& g, const long long* st,
                   cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T, DMAX, BQ, BK, KM, DROP>;
  const size_t smem = Cfg<T, DMAX, BQ, BK>::dq;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((g.SQ + BQ - 1) / BQ, g.B * g.H), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, g, strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
      strides_at(st, 4));
  return cudaGetLastError();
}

// dK/dV grid: one block per (key tile, kv head), or per (key tile, batch
// row) for the head-batched entry.
dim3 dkv_grid(const Geom& g, int bk) {
  return dim3((g.SK + bk - 1) / bk, g.hb ? g.B : g.B * g.HKV);
}

template <typename T, int DMAX, int BQ, int BK, bool KM, bool DROP>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, const Geom& g, const long long* st,
                    cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<T, DMAX, BQ, BK, KM, DROP>;
  const size_t smem = Cfg<T, DMAX, BQ, BK>::dkv;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dkv_grid(g, BK), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, g,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), strides_at(st, 4), strides_at(st, 5));
  return cudaGetLastError();
}

template <int DMAX, bool KM, bool DROP>
cudaError_t fwd_tc(const void* q, const void* k, const void* v, void* o,
                   void* lse, const Geom& g, const long long* st,
                   cudaStream_t stream) {
  auto kernel = tc::flash_fwd_tc<DMAX, KM, DROP>;
  const size_t smem = tc::Smem<DMAX>::fwd;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((g.SQ + 63) / 64, g.B * g.H), tc::kThreadsTc, smem,
           stream>>>(
      (const tc::bf16*)q, (const tc::bf16*)k, (const tc::bf16*)v,
      (tc::bf16*)o, (float*)lse, g, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3));
  return cudaGetLastError();
}

template <int DMAX, bool KM, bool DROP>
cudaError_t bwd_dq_tc(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, const Geom& g, const long long* st,
                      cudaStream_t stream) {
  auto kernel = tc::flash_bwd_dq_tc<DMAX, KM, DROP>;
  const size_t smem = tc::Smem<DMAX>::dq;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((g.SQ + 63) / 64, g.B * g.H), tc::kThreadsTc, smem,
           stream>>>(
      (const tc::bf16*)q, (const tc::bf16*)k, (const tc::bf16*)v,
      (const tc::bf16*)dout, (const float*)lse, (const float*)delta,
      (tc::bf16*)dq, g, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), strides_at(st, 4));
  return cudaGetLastError();
}

template <int DMAX, bool KM, bool DROP>
cudaError_t bwd_dkv_tc(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, const Geom& g, const long long* st,
                       cudaStream_t stream) {
  auto kernel = tc::flash_bwd_dkv_tc<DMAX, KM, DROP>;
  const size_t smem = tc::Smem<DMAX>::dkv;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dkv_grid(g, 64), tc::kThreadsTc, smem, stream>>>(
      (const tc::bf16*)q, (const tc::bf16*)k, (const tc::bf16*)v,
      (const tc::bf16*)dout, (const float*)lse, (const float*)delta,
      (tc::bf16*)dk, (tc::bf16*)dv, g, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), strides_at(st, 4),
      strides_at(st, 5));
  return cudaGetLastError();
}

// geom = {B, H, HKV, SQ, SK, d, causal, window}; km: the additive key
// rows (or null), one per query head (hb = 0) or per batch row (hb = 1);
// dm: their gradient (dK/dV entries, with km); drop: {seed0, seed1,
// threshold} (or null: no dropout), dscale = 1 / (1 - rate).
Geom make_geom(const int* geom, float scale, const void* km, void* dm,
               const unsigned* drop, float dscale, int hb) {
  Geom g{geom[0], geom[1], geom[2], geom[3], geom[4],
         geom[5], geom[6], geom[7], scale};
  g.km = (const float*)km;
  g.dm = (float*)dm;
  g.km_b = hb ? g.SK : (long long)g.H * g.SK;
  g.km_h = hb ? 0 : g.SK;
  g.seed0 = drop ? drop[0] : 0u;
  g.seed1 = drop ? drop[1] : 0u;
  g.thresh = drop ? drop[2] : 0u;
  g.dscale = dscale;
  // without a mask there is no dmask to reduce over heads: a head-batched
  // call keeps kernel 3's larger per-(key tile, kv head) grid
  g.hb = hb && km;
  return g;
}

// dtype codes shared with ops/cuda/flash_attention.py
enum { kFloat32 = 0, kBFloat16 = 1 };

// bf16 with d <= 128 takes the tensor-core kernels; fp32 (any d) and
// bf16 with d > 128 the fp32-FMA kernels, with 64 x 64 tiles up to DMAX
// 128 and 32 x 32 at DMAX 256 so that fp32 backward tiles fit in shared
// memory.
#define PT_FLASH_FAMILY(FN, KM, DROP, ...)                              \
  do {                                                                  \
    if (dtype == kBFloat16) {                                           \
      if (g.d <= 64) return FN##_tc<64, KM, DROP>(__VA_ARGS__);         \
      if (g.d <= 128) return FN##_tc<128, KM, DROP>(__VA_ARGS__);       \
      return FN<__nv_bfloat16, 256, 32, 32, KM, DROP>(__VA_ARGS__);      \
    }                                                                   \
    if (dtype == kFloat32) {                                            \
      if (g.d <= 64) return FN<float, 64, 64, 64, KM, DROP>(__VA_ARGS__); \
      if (g.d <= 128)                                                   \
        return FN<float, 128, 64, 64, KM, DROP>(__VA_ARGS__);            \
      return FN<float, 256, 32, 32, KM, DROP>(__VA_ARGS__);              \
    }                                                                   \
    return cudaErrorInvalidValue;                                       \
  } while (0)

// ... and the variant: key mask (g.km set) and dropout (drop given).
#define PT_FLASH_DISPATCH(FN, ...)                                      \
  do {                                                                  \
    if (g.d % 8 || g.d > 256 || g.H % g.HKV) return cudaErrorInvalidValue; \
    if (g.km && drop) PT_FLASH_FAMILY(FN, true, true, __VA_ARGS__);     \
    if (g.km) PT_FLASH_FAMILY(FN, true, false, __VA_ARGS__);            \
    if (drop) PT_FLASH_FAMILY(FN, false, true, __VA_ARGS__);            \
    PT_FLASH_FAMILY(FN, false, false, __VA_ARGS__);                     \
  } while (0)

int fwd_entry(const void* q, const void* k, const void* v, void* o,
              void* lse, const void* km, const int* geom, float scale,
              const long long* strides, const unsigned* drop, float dscale,
              int dtype, void* stream, int hb) {
  const Geom g = make_geom(geom, scale, km, nullptr, drop, dscale, hb);
  PT_FLASH_DISPATCH(fwd, q, k, v, o, lse, g, strides, (cudaStream_t)stream);
}

int bwd_dq_entry(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, const void* km, const int* geom, float scale,
                 const long long* strides, const unsigned* drop, float dscale,
                 int dtype, void* stream, int hb) {
  const Geom g = make_geom(geom, scale, km, nullptr, drop, dscale, hb);
  PT_FLASH_DISPATCH(bwd_dq, q, k, v, dout, lse, delta, dq, g, strides,
                    (cudaStream_t)stream);
}

int bwd_dkv_entry(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, const void* km, void* dm,
                  const int* geom, float scale, const long long* strides,
                  const unsigned* drop, float dscale, int dtype, void* stream,
                  int hb) {
  const Geom g = make_geom(geom, scale, km, dm, drop, dscale, hb);
  PT_FLASH_DISPATCH(bwd_dkv, q, k, v, dout, lse, delta, dk, dv, g, strides,
                    (cudaStream_t)stream);
}

}  // namespace

// Strides: the (batch, seq, head) element strides of each [b, s, h, d]
// tensor argument in order, 3 per tensor. lse and delta are [B * H, SQ]
// fp32; km and dm contiguous fp32 rows of SK.

// q, k, v, o strides. km: [B * H, 1, SK] or null.
extern "C" int pt_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, const void* km,
                            const int* geom, float scale,
                            const long long* strides, const unsigned* drop,
                            float dscale, int dtype, void* stream) {
  return fwd_entry(q, k, v, o, lse, km, geom, scale, strides, drop, dscale,
                   dtype, stream, 0);
}

// q, k, v, dout, dq strides.
extern "C" int pt_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, const void* km,
                               const int* geom, float scale,
                               const long long* strides,
                               const unsigned* drop, float dscale, int dtype,
                               void* stream) {
  return bwd_dq_entry(q, k, v, dout, lse, delta, dq, km, geom, scale,
                      strides, drop, dscale, dtype, stream, 0);
}

// q, k, v, dout, dk, dv strides. dm: [B * H, 1, SK] (with km).
extern "C" int pt_flash_bwd_dkv(const void* q, const void* k,
                                const void* v, const void* dout,
                                const void* lse, const void* delta,
                                void* dk, void* dv, const void* km, void* dm,
                                const int* geom, float scale,
                                const long long* strides,
                                const unsigned* drop, float dscale,
                                int dtype, void* stream) {
  return bwd_dkv_entry(q, k, v, dout, lse, delta, dk, dv, km, dm, geom,
                       scale, strides, drop, dscale, dtype, stream, 0);
}

// The head-batched entries (head_flash.py): as above with km [B, 1, SK]
// one row per batch row, and dm [B, 1, SK] summed over every head.
extern "C" int pt_hb_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, const void* km,
                         const int* geom, float scale,
                         const long long* strides, const unsigned* drop,
                         float dscale, int dtype, void* stream) {
  return fwd_entry(q, k, v, o, lse, km, geom, scale, strides, drop, dscale,
                   dtype, stream, 1);
}

extern "C" int pt_hb_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, const void* km,
                            const int* geom, float scale,
                            const long long* strides, const unsigned* drop,
                            float dscale, int dtype, void* stream) {
  return bwd_dq_entry(q, k, v, dout, lse, delta, dq, km, geom, scale,
                      strides, drop, dscale, dtype, stream, 1);
}

extern "C" int pt_hb_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv,
                             const void* km, void* dm, const int* geom,
                             float scale, const long long* strides,
                             const unsigned* drop, float dscale, int dtype,
                             void* stream) {
  return bwd_dkv_entry(q, k, v, dout, lse, delta, dk, dv, km, dm, geom,
                       scale, strides, drop, dscale, dtype, stream, 1);
}
