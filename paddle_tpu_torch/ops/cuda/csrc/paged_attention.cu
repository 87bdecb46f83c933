// Paged-attention decode kernels for Hopper (sm_90a), with a plain C
// interface for ctypes (built by ops/cuda/_build.py).
//
// Replaces the Pallas TPU kernels `_paged_kernel` (paged_attend) and
// `_paged_kernel_int8` (paged_attend_int8) of
// paddle_tpu/ops/pallas/paged_attention.py. Each serving lane has one
// pending query token per head; it attends over the K/V its block table
// points at, slots 0..pos[lane] (and only slots > pos - window when a
// sliding window is set), with an fp32 streaming softmax; int8 pools
// dequantize each row as int8 * its fp32 scale.
//
// What bounds it. Decode attention reads each visible K/V slot once and
// does about 4 flops per element read, far below the card's ridge: it is
// bound by bytes, 2 * sum(visible slots) * nkv * d * sizeof(elt) per call
// (plus the int8 scales), over 3.35 TB/s. The card reaches that rate only
// with MB of loads in flight, spread over all 132 SMs.
//
// Design: split-K (flash-decoding), two launches a call.
//   1. split: grid (lane, kv head x head chunk, split). A split is a span
//      of `split` slots, a whole number of pool blocks. A block whose span
//      lies wholly past pos, or wholly below the window, returns at once
//      (its pos, table entries and q are loaded together, before the
//      test); the others read only visible slots. A pool row of d
//      elements is read as 16-byte vectors by a group of lanes (16 lanes
//      for bf16 at d 128, 8 for int8); each warp takes every 4th group of
//      rows, and each lane group issues the copies of kU rows of K and V
//      before it uses any. The copies go to shared memory by cp.async, so
//      the data in flight holds no registers (at g 1 a thread takes 56
//      for bf16, 96 for int8): 5 to 6 blocks of 32 KB in flight fit an
//      SM. (Loading the rows into registers instead read 3-4 % faster at
//      the served geometry and 5-6 % slower at 2048 slots; committing K
//      and V as two groups, to score K while V lands, read 4-15 % slower
//      for int8 at 2048 slots.) Each thread reads back only the vectors it
//      copied, so the slot loop needs no barrier. q sits in registers as
//      fp32; a score is the lanes' partial dot products summed by
//      shuffles inside the group, and one K row serves all the block's
//      query heads (kGT of the kv head's g). int8 rows become fp32 by a
//      byte permute and dequantize in registers with the row's scale,
//      loaded once. Each lane group keeps its own running max, sum and
//      [kGT, d] accumulator; after the slot loop the groups merge by
//      shuffles, the warps through shared memory, and the block writes
//      its partial (m, l, acc) in fp32 to a workspace the wrapper
//      allocates.
//   2. merge: one block per (lane, head) combines the live splits in split
//      order, divides by max(l, 1e-30) and casts to q's dtype. It is a
//      programmatic dependent launch: it is scheduled while the split
//      grid's last blocks finish and waits for their writes.
// Splits that hold no visible slot are neither written nor read: their
// (m, l, acc) would be (-1e30, 0, 0) and add nothing. Every sum runs in a
// fixed order (no atomics), so two calls on the same inputs give the same
// bits.
//
// The split rule (ops/cuda/paged_attention.py::_split_slots): about 32 KB
// of K+V per split (64 slots of bf16 at d 128, 128 of int8, 32 of fp32):
// one step of the slot loop, so a block's copies all go out together and
// its fixed cost (pos, q, table entries, the partial it writes: ~2 % of
// its reads) stays small; halved while the grid would have fewer than
// two blocks per SM over the whole table. At the served geometry (8
// lanes, 12 kv heads, 512 slots) that is 768 blocks, of which the ~400
// over visible slots all fit the card at once. The host does not read
// pos, so the grid covers the table and the dead blocks exit. (On the
// H100, tools/torch_paged_sweep.py: splits of 16 KB read 10-33 % slower
// at both of chip_smoke.py's shapes; 64 and 128 KB within 6 % of 32 KB.)
//
// A rank of a tensor-parallel decode passes its own q heads (nh of them)
// and a pool of the kv heads they read: local q head i reads pool head
// (i + qoff) / g, g the model's q heads per kv head. With qoff 0 and
// nh = nkv * g that is one card's layout; otherwise (mp does not divide
// the kv heads) a block's kGT heads of a group may lie partly outside
// the rank's range: those are neither loaded nor written, and a block
// with none in range returns at once.
//
// Left to later work: TMA (one bulk copy per pool block instead of
// 16-byte copies), a ring that overlaps one step's copies with the last
// step's arithmetic for spans longer than one step, and a persistent
// grid that skips dead splits without launching them; tensor cores buy
// nothing at 4 flops per byte.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

// One call's geometry and buffers; both kernels take it by value.
struct Params {
  const void* q;        // [L, nh, d]
  const void* kpool;    // [num_blocks, B, nkv, d]
  const void* vpool;
  const float* kscale;  // [num_blocks, B, nkv], int8 pools only
  const float* vscale;
  const int* tables;    // [L, M]
  const int* pos;       // [L]
  void* out;            // [L, nh, d]
  float* part_acc;      // [L, nh, n_split, d] fp32 partial accumulators
  float* part_ml;       // [L, nh, n_split, 2] fp32 partial max and sum
  int L, nh, nkv, g, d, B, M, window;
  int qoff;             // q head i reads kv head (i + qoff) / g
  int split, n_split;   // slots per split (a multiple of B), splits
  int chunks;           // head chunks per kv head: ceil(g / kGT)
  int group, nvec;      // lanes per pool row (a power of two), 16-byte
                        // vectors per row
  float scale;
};

template <typename T>
struct Elems;  // elements in one 16-byte vector
template <>
struct Elems<float> { static constexpr int n = 4; };
template <>
struct Elems<__nv_bfloat16> { static constexpr int n = 8; };
template <>
struct Elems<__half> { static constexpr int n = 8; };
template <>
struct Elems<int8_t> { static constexpr int n = 16; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

// The elements of one 16-byte vector as fp32 (little-endian: element 0
// in the low bits of .x).
template <typename T>
__device__ __forceinline__ void unpack(const uint4& r, float* f);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& r, float* f) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& r,
                                                      float* f) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void unpack<__half>(const uint4& r, float* f) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
// int8: (x + 128) goes into the low byte of 2^23's mantissa by a byte
// permute, and 2^23 + 128 comes off again — exact, and cheaper than the
// card's int-to-float conversions.
template <>
__device__ __forceinline__ void unpack<int8_t>(const uint4& r, float* f) {
  const uint32_t w[4] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u,
                         r.z ^ 0x80808080u, r.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[4 * i + b] =
          __uint_as_float(__byte_perm(w[i], 0x4b000000u, 0x7440 | b)) -
          8388736.f;
}

// The slots visible from pos p: [*lo, *hi], empty when *hi < *lo (slots
// past the table's M * B are never visible).
__device__ __forceinline__ void visible_range(const Params& P, int p,
                                              int* lo, int* hi) {
  *lo = P.window > 0 ? max(0, p - P.window + 1) : 0;
  *hi = min(p, P.M * P.B - 1);
}

// Programmatic dependent launch (sm_90): the merge grid may be launched
// while the split grid's last blocks finish; it waits for the split
// grid's writes before it reads them.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;");
}
__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// 16 bytes from global to shared memory without passing through
// registers; zeros (nothing read) where !live.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(live ? 16 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

// Rows a lane group stages before it uses one, from the fp32 registers
// q (and acc) take per lane (its scores take as many more).
__host__ __device__ constexpr int rows_ahead(int f) {
  return f <= 16 ? 8 : (f <= 32 ? 4 : 2);
}

// Shared memory of one split block: each thread's staged K and V vectors
// (kU x kVPL x 16 bytes each), which the warps' partial accumulators, max
// and sum reuse after the slot loop, then the split's table entries
// (ops/cuda/paged_attention.py::_smem_bytes repeats this count).
inline size_t smem_bytes(int gt, int vpl, int ahead, int d, int split,
                         int B) {
  const size_t stage = (size_t)2 * ahead * vpl * kThreads * 16;
  const size_t merge =
      sizeof(float) * ((size_t)kWarps * gt * d + 2 * kWarps * gt);
  return (stage > merge ? stage : merge) + sizeof(int) * (size_t)(split / B);
}

// Launch 1. grid = (L, nkv * chunks, n_split), block = kThreads. kVPL
// 16-byte vectors of a row per lane (2 only for fp32 at d > 128), kGT
// query heads per block.
template <typename TQ, typename TKV, bool kQuant, int kVPL, int kGT>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const Params P) {
  constexpr int kE = Elems<TKV>::n;
  constexpr int kC = kVPL * kE;  // columns of a row one lane holds
  constexpr int kF = kGT * kC;   // fp32 registers of q, and of acc
  constexpr int kU = rows_ahead(kF);  // rows a lane group stages at once
  constexpr int kStage = 2 * kU * kVPL * kThreads;  // uint4s
  extern __shared__ float4 smem4[];
  uint4* sKV = reinterpret_cast<uint4*>(smem4);  // [2][kU][kVPL][kThreads]
  // after the slot loop: [kWarps][kGT][d] accumulators, max and sum
  float* sAcc = reinterpret_cast<float*>(smem4);
  float* sM = sAcc + kWarps * kGT * P.d;
  float* sL = sM + kWarps * kGT;
  int* sTab = reinterpret_cast<int*>(
      smem4 + (kStage > kWarps * kGT * (P.d + 2) / 4
                   ? kStage
                   : (kWarps * kGT * (P.d + 2) + 3) / 4));

  const int ln = blockIdx.x;
  const int kh = blockIdx.y / P.chunks;
  const int h0 = (blockIdx.y % P.chunks) * kGT;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int wid = tid / 32;
  const int wl = tid % 32;
  const int G = P.group;
  const int gl = wl % G;   // lane in its row group
  const int rg = wl / G;   // row group in the warp
  const int rpw = 32 / G;  // rows a warp reads per load
  const int B = P.B, d = P.d, nkv = P.nkv, g = P.g;
  const int nh = P.nh;
  // the local q head of this block's head 0: kh * g + h0 - qoff; heads
  // outside [0, nh) belong to another rank
  const int qh0 = kh * g + h0 - P.qoff;
  if (qh0 + kGT <= 0 || qh0 >= nh) return;  // none of this rank's

  // pos, the split's table entries and q do not depend on each other:
  // their loads go out together
  const int p = P.pos[ln];
  const int jb = split * (P.split / B);  // the split's first table entry
  for (int j = tid; j < P.split / B && jb + j < P.M; j += kThreads)
    sTab[j] = P.tables[(size_t)ln * P.M + jb + j];
  // this lane's columns of the block's query heads, fp32
  const TQ* q = static_cast<const TQ*>(P.q) + (size_t)ln * nh * d;
  float qr[kGT][kC];
#pragma unroll
  for (int h = 0; h < kGT; ++h)
#pragma unroll
    for (int v = 0; v < kVPL; ++v) {
      const int vi = gl + v * G;
      const int qh = qh0 + h;
      const bool live =
          h0 + h < g && qh >= 0 && qh < nh && vi < P.nvec;
#pragma unroll
      for (int e = 0; e < kE; ++e)
        qr[h][v * kE + e] =
            live ? to_f32(q[(size_t)qh * d + vi * kE + e]) : 0.f;
    }
  int lo, hi;
  visible_range(P, p, &lo, &hi);
  const int s0 = max(split * P.split, lo);
  const int s1 = min(split * P.split + P.split - 1, hi);
  if (s1 < s0) return;  // nothing visible: the merge skips this split
  float m[kGT], l[kGT], acc[kGT][kC];
#pragma unroll
  for (int h = 0; h < kGT; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[h][c] = 0.f;
  }
  __syncthreads();  // sTab is written

  const TKV* kpool = static_cast<const TKV*>(P.kpool);
  const TKV* vpool = static_cast<const TKV*>(P.vpool);
  const int stride = kWarps * rpw;  // slots between a group's rows u, u + 1
  const int stride_t = stride / B, stride_s = stride % B;
  const int per_step = kU * stride;
  for (int base = s0; base <= s1; base += per_step) {
    // stage every row of the step before using any: the copies land in
    // shared memory, each thread reads back only its own
    float ksc[kU], vsc[kU];
    bool ok[kU];
    const int r0 = base + wid * rpw + rg;  // this group's row u = 0
    int jt = r0 / B - jb, js = r0 % B;     // its table entry, slot in block
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      ok[u] = r0 + u * stride <= s1;
      size_t row = 0;  // pool row of slot r0 + u * stride for kv head kh
      if (ok[u]) row = ((size_t)sTab[jt] * B + js) * nkv + kh;
      jt += stride_t;  // the next row's table entry and slot
      js += stride_s;
      if (js >= B) {
        js -= B;
        ++jt;
      }
      const uint4* kv4 = reinterpret_cast<const uint4*>(kpool + row * d);
      const uint4* vv4 = reinterpret_cast<const uint4*>(vpool + row * d);
#pragma unroll
      for (int v = 0; v < kVPL; ++v) {
        const int vi = gl + v * G;
        const bool live = ok[u] && vi < P.nvec;
        cp_async16(sKV + (u * kVPL + v) * kThreads + tid, kv4 + vi, live);
        cp_async16(sKV + ((kU + u) * kVPL + v) * kThreads + tid, vv4 + vi,
                   live);
      }
      if constexpr (kQuant) {
        ksc[u] = ok[u] ? __ldg(P.kscale + row) : 0.f;
        vsc[u] = ok[u] ? __ldg(P.vscale + row) : 0.f;
      }
    }
    cp_async_wait_all();
    // scores: each lane's partial dot products, summed over its group
    float s[kU][kGT];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float kf[kC];
#pragma unroll
      for (int v = 0; v < kVPL; ++v)
        unpack<TKV>(sKV[(u * kVPL + v) * kThreads + tid], kf + v * kE);
      if constexpr (kQuant) {
#pragma unroll
        for (int c = 0; c < kC; ++c) kf[c] *= ksc[u];
      }
#pragma unroll
      for (int h = 0; h < kGT; ++h) {
        float a = 0.f;
#pragma unroll
        for (int c = 0; c < kC; ++c) a = fmaf(qr[h][c], kf[c], a);
        s[u][h] = a;
      }
    }
    for (int o = G >> 1; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int h = 0; h < kGT; ++h)
          s[u][h] += __shfl_xor_sync(kFull, s[u][h], o);
    // the group's online softmax over its rows of the step
#pragma unroll
    for (int h = 0; h < kGT; ++h) {
      float mx = m[h];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        s[u][h] *= P.scale;
        if (ok[u]) mx = fmaxf(mx, s[u][h]);
      }
      const float alpha = expf(m[h] - mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        s[u][h] = ok[u] ? expf(s[u][h] - mx) : 0.f;  // now p
        sum += s[u][h];
      }
      l[h] = alpha * l[h] + sum;
      m[h] = mx;
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[h][c] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float vf[kC];
#pragma unroll
      for (int v = 0; v < kVPL; ++v)
        unpack<TKV>(sKV[((kU + u) * kVPL + v) * kThreads + tid],
                    vf + v * kE);
      if constexpr (kQuant) {
#pragma unroll
        for (int c = 0; c < kC; ++c) vf[c] *= vsc[u];
      }
#pragma unroll
      for (int h = 0; h < kGT; ++h)
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[h][c] = fmaf(s[u][h], vf[c], acc[h][c]);
    }
  }

  launch_dependents();  // this block reads no more pool rows
  // merge the warp's row groups (a group without rows has m = -1e30,
  // l = 0, acc = 0 and gets weight 0 or adds zeros)
  for (int o = 16; o >= G; o >>= 1)
#pragma unroll
    for (int h = 0; h < kGT; ++h) {
      const float mo = __shfl_xor_sync(kFull, m[h], o);
      const float lo = __shfl_xor_sync(kFull, l[h], o);
      const float mn = fmaxf(m[h], mo);
      const float a = expf(m[h] - mn);
      const float b = expf(mo - mn);
      l[h] = a * l[h] + b * lo;
      m[h] = mn;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float x = __shfl_xor_sync(kFull, acc[h][c], o);
        acc[h][c] = a * acc[h][c] + b * x;
      }
    }
  __syncthreads();  // every thread is done with its staged rows
  if (rg == 0) {
#pragma unroll
    for (int h = 0; h < kGT; ++h) {
#pragma unroll
      for (int v = 0; v < kVPL; ++v) {
        const int vi = gl + v * G;
        if (vi < P.nvec) {
          float4* dst = reinterpret_cast<float4*>(
              sAcc + (wid * kGT + h) * d + vi * kE);
#pragma unroll
          for (int e = 0; e < kE / 4; ++e)
            dst[e] = make_float4(acc[h][v * kE + 4 * e],
                                 acc[h][v * kE + 4 * e + 1],
                                 acc[h][v * kE + 4 * e + 2],
                                 acc[h][v * kE + 4 * e + 3]);
        }
      }
      if (gl == 0) {
        sM[wid * kGT + h] = m[h];
        sL[wid * kGT + h] = l[h];
      }
    }
  }
  __syncthreads();
  // the block's partial: its warps merged in warp order
  for (int i = tid; i < kGT * d; i += kThreads) {
    const int h = i / d;
    const int c = i % d;
    if (h0 + h >= g || qh0 + h >= nh) break;
    if (qh0 + h < 0) continue;  // another rank's head
    float mb = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, sM[w * kGT + h]);
    float a = 0.f, lb = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sM[w * kGT + h] - mb);
      a += f * sAcc[(w * kGT + h) * d + c];
      lb += f * sL[w * kGT + h];
    }
    const size_t at = ((size_t)ln * nh + qh0 + h) * P.n_split + split;
    P.part_acc[at * d + c] = a;
    if (c == 0) {
      P.part_ml[2 * at] = mb;
      P.part_ml[2 * at + 1] = lb;
    }
  }
}

// Launch 2. grid = (L, nh), block = kThreads, 2 * n_split floats of
// shared memory: one (lane, head)'s live splits in split order.
template <typename TQ>
__global__ void __launch_bounds__(kThreads)
paged_merge_kernel(const Params P) {
  extern __shared__ float4 smem4[];
  float* sW = reinterpret_cast<float*>(smem4);  // [n] max, then weight
  float* sL = sW + P.n_split;                    // [n] sum
  const int tid = threadIdx.x;
  const size_t row = (size_t)blockIdx.x * P.nh + blockIdx.y;
  // the splits the split kernel wrote: those that hold a visible slot
  int lo, hi, i0 = 0, n = 0;
  visible_range(P, P.pos[blockIdx.x], &lo, &hi);
  if (lo <= hi) {
    i0 = lo / P.split;
    n = hi / P.split - i0 + 1;
  }
  wait_for_primary();
  const float* ml = P.part_ml + 2 * (row * P.n_split + i0);
  const float* acc = P.part_acc + (row * P.n_split + i0) * P.d;
  for (int i = tid; i < n; i += kThreads) {
    sW[i] = ml[2 * i];
    sL[i] = ml[2 * i + 1];
  }
  __syncthreads();
  float mx = kNegInf;
  for (int i = 0; i < n; ++i) mx = fmaxf(mx, sW[i]);
  __syncthreads();  // every thread has read the maxima
  for (int i = tid; i < n; i += kThreads) sW[i] = expf(sW[i] - mx);
  __syncthreads();
  float l = 0.f;
  for (int i = 0; i < n; ++i) l += sW[i] * sL[i];
  TQ* out = static_cast<TQ*>(P.out) + row * P.d;
  constexpr int kAhead = 16;  // splits' loads in flight per thread
  for (int c = tid; c < P.d; c += kThreads) {
    float a = 0.f;
    for (int b = 0; b < n; b += kAhead) {
      float x[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k)
        x[k] = b + k < n ? acc[(size_t)(b + k) * P.d + c] : 0.f;
#pragma unroll
      for (int k = 0; k < kAhead; ++k)
        if (b + k < n) a += sW[b + k] * x[k];
    }
    out[c] = from_f32<TQ>(a / fmaxf(l, 1e-30f));
  }
}

template <typename TQ, typename TKV, bool kQuant, int kVPL, int kGT>
cudaError_t run(const Params& P, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem =
      smem_bytes(kGT, kVPL, rows_ahead(kGT * kVPL * Elems<TKV>::n), P.d,
                 P.split, P.B);
  auto kernel = paged_split_kernel<TQ, TKV, kQuant, kVPL, kGT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(P.L, P.nkv * P.chunks, P.n_split), kThreads, smem, s>>>(P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the merge as a programmatic dependent launch of the split grid
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P.L, P.nh);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 2 * sizeof(float) * P.n_split;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_merge_kernel<TQ>, P);
}

inline int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// The row layout (vectors a lane holds, lanes a row) and the query heads
// per block from the dtype, g and d; then the template that fits.
template <typename TQ, typename TKV, bool kQuant>
cudaError_t launch(Params P, void* stream) {
  P.nvec = P.d * (int)sizeof(TKV) / 16;
  const int vpl = P.nvec > 32 ? 2 : 1;
  P.group = pow2_ceil((P.nvec + vpl - 1) / vpl);
  // at most 64 fp32 registers for q (and as many for acc), 8 heads
  const int cols = vpl * Elems<TKV>::n;
  const int cap = cols <= 8 ? 8 : 4;
  const int gt = pow2_ceil(P.g) < cap ? pow2_ceil(P.g) : cap;
  P.chunks = (P.g + gt - 1) / gt;
  if (vpl == 2) {
    if constexpr (std::is_same<TKV, float>::value) {
      switch (gt) {
        case 1: return run<TQ, TKV, kQuant, 2, 1>(P, stream);
        case 2: return run<TQ, TKV, kQuant, 2, 2>(P, stream);
        case 4: return run<TQ, TKV, kQuant, 2, 4>(P, stream);
        case 8: return run<TQ, TKV, kQuant, 2, 8>(P, stream);
      }
    }
    return cudaErrorInvalidValue;
  }
  switch (gt) {
    case 1: return run<TQ, TKV, kQuant, 1, 1>(P, stream);
    case 2: return run<TQ, TKV, kQuant, 1, 2>(P, stream);
    case 4: return run<TQ, TKV, kQuant, 1, 4>(P, stream);
  }
  if constexpr (Elems<TKV>::n <= 8)
    if (gt == 8) return run<TQ, TKV, kQuant, 1, 8>(P, stream);
  return cudaErrorInvalidValue;
}

Params make_params(const void* q, const void* kpool, const void* vpool,
                   const void* kscale, const void* vscale,
                   const void* tables, const void* pos, void* out,
                   void* work, int L, int nh, int nkv, int g, int qoff,
                   int d, int B, int M, int window, int split, int n_split,
                   float scale) {
  Params P{};
  P.q = q;
  P.kpool = kpool;
  P.vpool = vpool;
  P.kscale = static_cast<const float*>(kscale);
  P.vscale = static_cast<const float*>(vscale);
  P.tables = static_cast<const int*>(tables);
  P.pos = static_cast<const int*>(pos);
  P.out = out;
  // work: [L, nh, n_split, d] accumulators, then [L, nh, n_split, 2]
  P.part_acc = static_cast<float*>(work);
  P.part_ml = P.part_acc + (size_t)L * nh * n_split * d;
  P.L = L;
  P.nh = nh;
  P.nkv = nkv;
  P.g = g;
  P.qoff = qoff;
  P.d = d;
  P.B = B;
  P.M = M;
  P.window = window;
  P.split = split;
  P.n_split = n_split;
  P.scale = scale;
  return P;
}

}  // namespace

// dtype codes shared with ops/cuda/paged_attention.py
enum { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };

// q and the pools share one dtype: float32, bfloat16 or float16 (the
// 16-bit pools 8 elements a 16-byte load). work holds
// L * nh * n_split * (d + 2) floats. q holds nh heads; head i reads kv
// head (i + qoff) / g of the pools' nkv.
extern "C" int pt_paged_attend(const void* q, const void* kpool,
                               const void* vpool, const void* tables,
                               const void* pos, void* out, void* work, int L,
                               int nh, int nkv, int g, int qoff, int d,
                               int B, int M, int window, int split,
                               int n_split, float scale, int dtype,
                               void* stream) {
  const Params P =
      make_params(q, kpool, vpool, nullptr, nullptr, tables, pos, out, work,
                  L, nh, nkv, g, qoff, d, B, M, window, split, n_split,
                  scale);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(P, stream);
  if (dtype == kFloat16) return launch<__half, __half, false>(P, stream);
  if (dtype == kFloat32) return launch<float, float, false>(P, stream);
  return cudaErrorInvalidValue;
}

// int8 pools with fp32 scales; q (and out) float32, bfloat16 or float16.
extern "C" int pt_paged_attend_int8(const void* q, const void* kpool,
                                    const void* vpool, const void* kscale,
                                    const void* vscale, const void* tables,
                                    const void* pos, void* out, void* work,
                                    int L, int nh, int nkv, int g, int qoff,
                                    int d, int B, int M, int window,
                                    int split, int n_split, float scale,
                                    int q_dtype, void* stream) {
  const Params P =
      make_params(q, kpool, vpool, kscale, vscale, tables, pos, out, work, L,
                  nh, nkv, g, qoff, d, B, M, window, split, n_split, scale);
  if (q_dtype == kBFloat16)
    return launch<__nv_bfloat16, int8_t, true>(P, stream);
  if (q_dtype == kFloat16) return launch<__half, int8_t, true>(P, stream);
  if (q_dtype == kFloat32) return launch<float, int8_t, true>(P, stream);
  return cudaErrorInvalidValue;
}
