// Paged-attention decode kernels for Hopper (sm_90a), with a plain C
// interface for ctypes (built by ops/cuda/_build.py).
//
// Replaces the Pallas TPU kernels `_paged_kernel` (paged_attend) and
// `_paged_kernel_int8` (paged_attend_int8) of
// paddle_tpu/ops/pallas/paged_attention.py. Each serving lane has one
// pending query token per head; it attends over the K/V its block table
// points at, slots 0..pos[lane] (and only slots > pos - window when a
// sliding window is set), with an fp32 streaming softmax.
//
// Design. The TPU grid (lanes, table slots) runs in order and carries
// the softmax state in VMEM scratch from step to step. Here one thread
// block owns one (lane, kv_head) pair and its g grouped query heads, and
// a loop inside the block walks only that lane's live blocks
// (nb = pos / B + 1; blocks wholly below a sliding window are skipped),
// loading each table entry itself. Each step stages the [B, d] K and V
// tiles in shared memory as fp32 with 16-byte loads (the int8 variant
// multiplies by its per-slot fp32 scale as it loads), computes the g x B
// scores with one warp reduction each, updates the running max, sum and
// [g, d] accumulator in fp32, and the block finally divides by
// max(sum, 1e-30) and casts to the query's dtype.
//
// What bounds it. Decode attention reads each live K/V slot once and
// does 4 flops per element read, far below the card's 295 flop/byte
// ridge: it is bound by bytes, 2 * sum(pos + 1) * nkv * d * sizeof(elt)
// per call (plus the scales), over 3.35 TB/s. Reading only live blocks
// is what this design does about it; the dense gather it replaces reads
// every table slot. Known gaps, left to later work: one block per
// (lane, kv_head) gives 8 x 12 = 96 blocks at the served geometry, under
// the 132 SMs, and a single lane's long context is not split across
// blocks (split-K / flash-decoding); loads are not double-buffered and
// do not use TMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared-memory floats one block uses (see the carve-up in the kernel;
// ops/cuda/paged_attention.py::_smem_bytes repeats this count).
inline size_t smem_floats(int g, int d, int B) {
  return 2 * (size_t)g * d + 2 * (size_t)B * d + (size_t)g * B + 3 * g;
}

// q [L, nh, d]; kpool/vpool [num_blocks, B, nkv, d] (one layer);
// kscale/vscale [num_blocks, B, nkv] fp32 when kQuant; tables [L, M] and
// pos [L] int32; out [L, nh, d]. grid = (L, nkv), block = kThreads.
template <typename TQ, typename TKV, bool kQuant>
__global__ void __launch_bounds__(kThreads)
paged_attend_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kpool,
                    const TKV* __restrict__ vpool,
                    const float* __restrict__ kscale,
                    const float* __restrict__ vscale,
                    const int* __restrict__ tables,
                    const int* __restrict__ pos, TQ* __restrict__ out,
                    int nkv, int g, int d, int B, int M, int window,
                    float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;            // [g, d]  this kv head's queries
  float* sK = sQ + g * d;      // [B, d]  K tile
  float* sV = sK + B * d;      // [B, d]  V tile
  float* sAcc = sV + B * d;    // [g, d]  running sum of p * V
  float* sS = sAcc + g * d;    // [g, B]  scores, then probabilities
  float* sM = sS + g * B;      // [g]     running max
  float* sL = sM + g;          // [g]     running sum of p
  float* sAlpha = sL + g;      // [g]     this step's rescale factor

  const int lane = blockIdx.x;
  const int kh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wl = tid % 32;
  const int nh = nkv * g;
  const int p = pos[lane];

  // the g query heads of kv head kh are rows kh*g .. kh*g+g-1 of q
  const size_t qbase = ((size_t)lane * nh + (size_t)kh * g) * d;
  for (int i = tid; i < g * d; i += kThreads) {
    sQ[i] = to_f32(q[qbase + i]);
    sAcc[i] = 0.f;
  }
  for (int h = tid; h < g; h += kThreads) {
    sM[h] = kNegInf;
    sL[h] = 0.f;
  }

  int nb = p < 0 ? 0 : p / B + 1;  // live blocks: slots 0..p
  if (nb > M) nb = M;
  int j0 = 0;  // blocks wholly below the window carry zero weight
  if (window > 0 && p - window + 1 > 0) j0 = (p - window + 1) / B;

  constexpr int kVec = 16 / sizeof(TKV);  // elements per 16-byte load
  const int vec_per_row = d / kVec;
  const int n_vec = B * vec_per_row;
  const size_t slot_stride = (size_t)nkv * d;
  const int* trow = tables + (size_t)lane * M;

  for (int j = j0; j < nb; ++j) {
    const int blk = trow[j];
    __syncthreads();  // the previous step is done with sK, sV and sS
    const size_t base = ((size_t)blk * B * nkv + kh) * d;
    for (int v = tid; v < n_vec; v += kThreads) {
      const int t = v / vec_per_row;
      const int c = (v % vec_per_row) * kVec;
      const size_t off = base + (size_t)t * slot_stride + c;
      const uint4 kraw = *reinterpret_cast<const uint4*>(kpool + off);
      const uint4 vraw = *reinterpret_cast<const uint4*>(vpool + off);
      const TKV* ke = reinterpret_cast<const TKV*>(&kraw);
      const TKV* ve = reinterpret_cast<const TKV*>(&vraw);
      float* kd = sK + t * d + c;
      float* vd = sV + t * d + c;
      if constexpr (kQuant) {
        const size_t soff = ((size_t)blk * B + t) * nkv + kh;
        const float ks = kscale[soff];
        const float vs = vscale[soff];
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          kd[e] = to_f32(ke[e]) * ks;
          vd[e] = to_f32(ve[e]) * vs;
        }
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          kd[e] = to_f32(ke[e]);
          vd[e] = to_f32(ve[e]);
        }
      }
    }
    __syncthreads();
    // scores: one warp per (head, slot) pair, lanes stride over d
    for (int pr = warp; pr < g * B; pr += kWarps) {
      const int h = pr / B;
      const int t = pr % B;
      float acc = 0.f;
      for (int i = wl; i < d; i += 32) acc += sQ[h * d + i] * sK[t * d + i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (wl == 0) {
        const int slot = j * B + t;
        bool vis = slot <= p;
        if (window > 0) vis = vis && slot > p - window;
        sS[h * B + t] = vis ? acc * scale : kNegInf;
      }
    }
    __syncthreads();
    // online softmax: new max, probabilities, rescale, running sum
    for (int h = tid; h < g; h += kThreads) {
      float* s = sS + h * B;
      float mx = sM[h];
      for (int t = 0; t < B; ++t) mx = fmaxf(mx, s[t]);
      float sum = 0.f;
      for (int t = 0; t < B; ++t) {
        const float e = expf(s[t] - mx);
        s[t] = e;
        sum += e;
      }
      const float alpha = expf(sM[h] - mx);
      sL[h] = alpha * sL[h] + sum;
      sM[h] = mx;
      sAlpha[h] = alpha;
    }
    __syncthreads();
    for (int i = tid; i < g * d; i += kThreads) {
      const int h = i / d;
      const int c = i % d;
      const float* s = sS + h * B;
      float a = 0.f;
      for (int t = 0; t < B; ++t) a += s[t] * sV[t * d + c];
      sAcc[i] = sAlpha[h] * sAcc[i] + a;
    }
  }
  __syncthreads();
  for (int i = tid; i < g * d; i += kThreads)
    out[qbase + i] = from_f32<TQ>(sAcc[i] / fmaxf(sL[i / d], 1e-30f));
}

template <typename TQ, typename TKV, bool kQuant>
cudaError_t launch(const void* q, const void* kpool, const void* vpool,
                   const void* kscale, const void* vscale,
                   const void* tables, const void* pos, void* out, int L,
                   int nkv, int g, int d, int B, int M, int window,
                   float scale, void* stream) {
  auto kernel = paged_attend_kernel<TQ, TKV, kQuant>;
  const size_t smem = smem_floats(g, d, B) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(L, nkv), kThreads, smem, (cudaStream_t)stream>>>(
      (const TQ*)q, (const TKV*)kpool, (const TKV*)vpool,
      (const float*)kscale, (const float*)vscale, (const int*)tables,
      (const int*)pos, (TQ*)out, nkv, g, d, B, M, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype codes shared with ops/cuda/paged_attention.py
enum { kFloat32 = 0, kBFloat16 = 1 };

// q and the pools share one dtype: float32 or bfloat16.
extern "C" int pt_paged_attend(const void* q, const void* kpool,
                               const void* vpool, const void* tables,
                               const void* pos, void* out, int L, int nkv,
                               int g, int d, int B, int M, int window,
                               float scale, int dtype, void* stream) {
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(
        q, kpool, vpool, nullptr, nullptr, tables, pos, out, L, nkv, g, d,
        B, M, window, scale, stream);
  if (dtype == kFloat32)
    return launch<float, float, false>(q, kpool, vpool, nullptr, nullptr,
                                       tables, pos, out, L, nkv, g, d, B,
                                       M, window, scale, stream);
  return cudaErrorInvalidValue;
}

// int8 pools with fp32 scales; q (and out) float32 or bfloat16.
extern "C" int pt_paged_attend_int8(const void* q, const void* kpool,
                                    const void* vpool, const void* kscale,
                                    const void* vscale, const void* tables,
                                    const void* pos, void* out, int L,
                                    int nkv, int g, int d, int B, int M,
                                    int window, float scale, int q_dtype,
                                    void* stream) {
  if (q_dtype == kBFloat16)
    return launch<__nv_bfloat16, int8_t, true>(
        q, kpool, vpool, kscale, vscale, tables, pos, out, L, nkv, g, d, B,
        M, window, scale, stream);
  if (q_dtype == kFloat32)
    return launch<float, int8_t, true>(q, kpool, vpool, kscale, vscale,
                                       tables, pos, out, L, nkv, g, d, B, M,
                                       window, scale, stream);
  return cudaErrorInvalidValue;
}
