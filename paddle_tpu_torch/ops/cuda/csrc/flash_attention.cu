// Flash attention forward and backward kernels for Hopper (sm_90a), with
// a plain C interface for ctypes (built by ops/cuda/_build.py).
//
// Replaces the six Pallas TPU kernels of paddle_tpu/ops/pallas/
// flash_attention.py and head_flash.py:
//   flash_fwd_{kernel,wgmma}         <- _fwd_kernel (launched by _flash_fwd)
//   flash_bwd_dq_{kernel,wgmma}      <- _bwd_dq_kernel (by _flash_bwd_impl)
//   flash_bwd_dkv_{kernel,tc,wgmma}  <- _bwd_dkv_kernel (by _flash_bwd_impl)
// through the pt_flash_* entries (pt_flash_bwd_dq_delta: dQ that also
// computes delta = rowsum(dO * O), which _flash_bwd_impl computes
// outside its kernels), and the head-batched
//   _hb_fwd_kernel (by _hb_fwd), _hb_dq_kernel, _hb_dkv_kernel (by
//   _hb_bwd_impl)
// through the pt_hb_* entries (pt_hb_bwd_dq_delta: dQ that also computes
// delta, the sum _hb_bwd_impl makes), with the same arithmetic: fp32 scores,
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
//     one row per query head, in registers and without atomics;
//     pt_hb_bwd_dkv writes those rows into a [b * h, 1, sk] scratch and a
//     second pass (dmask_head_sum) sums them over heads in head order.
//   - DROP: the reference's counter-hash dropout (_keep_mask): a murmur3
//     fmix32 of the global (query head b * H + h, row, col) and two seed
//     words in uint32 arithmetic, keep iff hash >= threshold (computed
//     on the host as min(int(rate * 2^32), 2^32 - 1)). The row sum l keeps
//     the undropped p; only P.V takes p * keep / (1 - rate). The backward
//     scales dp by the same mask before ds and uses the dropped p for dV.
//     The bits are a pure function of those coordinates, so every kernel
//     and every tile shape regenerates the same mask, bit for bit with
//     the TPU kernels and the plain versions.
//   - TM, the tile mode (pt_flash_tile_* entries): an fp32 mask that
//     broadcasts to [b, h, sq, sk], read through its batch, head and
//     query-row strides (0 over a broadcast dim; Geom::km_q), is added to
//     each score before the causal mask, as the reference's composite
//     adds it (no TPU kernel takes such a mask). A row whose lse is at or
//     below -0.5e30 is fully masked: its scores are all the reference's
//     -1e30, whose softmax is uniform, so the backward takes p = 1 / SK
//     on every key (lse cannot carry log(SK) at -1e30) and ds = 0 where
//     the causal mask hides the key. dK/dV writes ds / scale per element
//     into dm ([B * H, SQ, SK]) when dm is given. bf16 and fp16 at d <=
//     128 run the wgmma kernels; fp32 and d > 128 the FMA kernels, which
//     visit every tile; no window. The wgmma kernels skip what is
//     exactly zero: a class pass (tile_classes_kernel,
//     pt_flash_tile_classes) reads the mask once and writes one byte per
//     64 x 64 cell of each (mask batch, mask head) slice, DEAD (every
//     value at or below -0.5e30), ZERO (every value 0) or MIXED, and one
//     flag per 64-row cell row: set where a row that sees a key has no
//     value above -0.5e30 among the keys it sees (a fully masked row).
//     The autograd Function runs it once, with the forward, and hands the
//     table to dQ and dK/dV. The forward (flash_fwd_tile_wgmma) and dQ
//     take 128 query rows (a cell row a consumer warpgroup) and 64-key
//     tiles (a cell); their producer warp (tile_row_producer) decides
//     each warpgroup's mode per tile from the table: it skips a DEAD
//     cell, and the forward a tile past its rows' causal band, unless its
//     rows hold a fully masked row (the forward: the flag; dQ: the rows'
//     lse, whose DEAD cells then have a ds that is not 0); dK/dV's
//     producer (tile_dkv_producer) skips DEAD cells and the query tiles
//     before the causal band of its keys under the same exception (a
//     fully masked row's p reaches hidden keys). Producer and consumers
//     read one decision (block-uniform: the mode written beside each
//     stage); the producer loads only the tiles some warpgroup visits,
//     and stages each MIXED cell's fp32 mask (the forward also a DEAD one
//     a fully masked row visits) in shared memory by cp.async (16-byte
//     copies where the slice and its row stride allow, else 4-byte ones),
//     padded so that the consumers' reads in the accumulator's layout are
//     free of bank conflicts; a ZERO cell adds nothing. The forward's
//     grid is persistent (one block an SM, each walking its share of the
//     128-row items, the next item's Q and tiles loaded under the current
//     one's), since an item holds 2-4 tiles. The backward's full-row rule
//     runs in a pass of its own, only for a tile that holds such a row.
//     dQ computes delta itself (pt_flash_tile_bwd_dq_delta), as kernel 2
//     does; dK/dV runs kernel 6's wgmma kernel. At d 128 the rings hold 2
//     stages (3 at d 64), so that the mask tiles fit in shared memory.
//
// Layout. q is read as [b, sq, h, d] and k/v as [b, sk, h_kv, d] through
// their (batch, seq, head) strides with a unit last stride, so the
// caller's [b, s, h, d] tensors (views of the fused QKV projection
// included) need no transpose. GQA: q head hq reads kv head hq / (h /
// h_kv). lse and delta are [b * h, sq] fp32.
//
// Design. The TPU grid runs its minor dimension in order and carries the
// softmax state (or the dQ / dK / dV sums) in VMEM scratch from one grid
// step to the next. Here one thread block owns an output tile and loops
// over the other dimension itself: the forward and dQ over the key tiles
// that intersect the (causal, window) band, dK/dV over its kv head's
// group of q heads x the query tiles of the band (one block per (key
// tile, kv head) for every call, head-batched too). No atomics anywhere:
// every result is deterministic. Ragged edges are masked in the kernels,
// so any sequence length >= 1 works; d is any multiple of 8 up to 256.
// Element types. Every kernel takes its 16-bit element type T as a
// template parameter, bf16 or fp16 (__half): this source builds bf16 and
// fp32, and flash_attention_fp16.cu builds it again with PT_FLASH_FP16,
// every family and variant at fp16 (kLowCode below). What follows says
// bf16 for either.
// Three families:
//   - wgmma (namespace wg; bf16, d <= 128): the forward in every variant
//     (kernel 1; kernel 4 is flash_fwd_wgmma<64, true, true> on the BERT
//     path), dQ in every variant (kernel 2 through the entry that computes
//     delta on the Llama path; kernel 5 is flash_bwd_dq_wgmma<64, true,
//     true, true> through pt_hb_bwd_dq_delta on the BERT path), and dK/dV
//     at d <= 64 (kernel 6, and kernel 3 there), without key row or
//     dropout at d <= 128 (kernel 3 on the Llama path) and in the tile
//     mode at d <= 128. Warp-
//     specialised blocks of two consumer warpgroups and a producer: the
//     producer keeps TMA loads (4-D tensor maps over the strided [b, s,
//     h, d] tensors, 128-byte swizzle, zero fill past every edge) in
//     flight through a ring of shared tiles signalled by mbarriers; the
//     consumers multiply with wgmma.mma_async, the score-like products
//     from two shared operands and the value-like product with the
//     probabilities (or dS) from registers (the accumulator repacked as
//     the A operand, rounded to bf16 once) against an MN-major shared
//     operand. The plain forward has one producer warp; its key-row and
//     dropout variants and the backward kernels a producer warpgroup
//     that gives its registers to the consumers with setmaxnreg (24 / 240
//     a thread; 40 / 232 for dK/dV at d <= 64 and the tile mode's dQ), so
//     the dK and dV accumulators and the S^T and dP^T tiles (~200 registers a thread at
//     d 128), or the score tile beside the key row and the dropout hash's
//     terms, stay in registers. The forward takes
//     one block per 128-row query tile, the heaviest causal tiles first,
//     128 keys a step, scores in the log2 domain (ex2), and masks with
//     per-row key limits only on the tiles that cross the diagonal, the
//     window or the last key. dQ does the same per 128 query rows with Q
//     and dO resident and 64-key K/V tiles in a 3-stage ring; its fused
//     entry also sums delta for its rows from the resident dO and O, and
//     writes it for dK/dV. With a key row the forward and dQ skip key
//     tiles (128 and 64 keys) that are wholly padding: the producer warp
//     copies each tile's key row beside K by cp.async, scans the row once
//     (padded_tiles) under the first tile's load and announces the tiles
//     it loads to the consumers through the ring (key_tile_producer).
//     Both backward kernels start their blocks in
//     groups of 16 heads (grouped_block), the heaviest tiles first inside
//     a group, so that a group's shared operands stay in L2. dK/dV takes
//     128 keys a block (64 a warpgroup), the first key tiles first, and
//     64-row query tiles in a 3-stage ring (Q, dO, lse and delta), and a
//     warpgroup whose 64 keys are wholly padding for a query head skips
//     that head (padded_tile: exact zeros, as the reference gives);
//   - mma.sync (namespace tc; bf16, m16n8k16 .bf16 or .f16): the key-row
//     and dropout variants of dK/dV at 64 < d <= 128 (no model path runs
//     them). 64-key tiles, each
//     warp owning 16 keys with mma.sync.m16n8k16, tiles staged by
//     synchronous 16-byte loads;
//   - fp32 FMA (fp32 any d, bf16 with d > 128): a 16 x 16 thread grid,
//     each thread owning a micro-tile of scores and fp32 sums; fp32 keeps
//     full fp32 products, so the card's results match the CPU's plain
//     versions to fp32 rounding.
//
// What bounds it. At the Llama shape (b8, s1024, h12, d128, bf16, causal)
// the forward does 25.8 GFLOP of visible pairs against about 100 MB
// moved, at the card's bf16 ridge, so its bound is about 0.03 ms either
// way; dK/dV is bound by operations (0.052 ms), dQ with delta by bytes
// (it also reads O: 0.045 ms). At BERT's shape (b64, s512, h12, d64,
// padded, dropout) all three are bound by bytes once padding pairs are
// left out (0.049, 0.064 with delta, 0.079 ms); there the kernels spend
// their time on the per-element softmax and dropout hash (d 64 halves the
// products per element) and on each block's own Q, dO and O traffic,
// which one block per SM cannot overlap with another block's tiles. In
// the tile mode at the Transformer decoder's shape (b64, s256, h8, d64,
// dropout, the causal mask) the backward is bound by bytes (0.03 ms
// each), but a block holds only 2-4 tiles, so its fixed cost (the K/V or
// Q/dO loads before its first tile, the producer's reads of the table and
// the lse, the stores after its last) weighs as much as its tiles. The
// wgmma kernels reach the tensor cores' full rate per instruction; what
// they still lack: the overlap of the softmax with the products across
// tiles inside a warpgroup (two score accumulators in flight,
// FlashAttention-3's intra-warpgroup pipelining; the backward overlaps
// only p with dP's product), a TMA store of the outputs, and a
// persistent grid that would overlap one tile's epilogue and prologue
// with the next tile's work. Known gaps, left to later work: the key-row
// and dropout dK/dV at 64 < d <= 128 on wgmma, and tensor-core paths for
// fp32 (TF32 would break the fp32 identity with the CPU) and d = 256.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

// The build compiles this source in parts, one nvcc process each
// (ops/cuda/_build.py, PARTS), and links them into one library:
// -DPT_PART=n keeps part n's entries (0 the forwards, 1 dQ, 2 dK/dV, 3
// the tile mode's dK/dV), so each process instantiates only their
// kernels. Without PT_PART every entry is built.
#ifdef PT_PART
#define PT_IN_PART(n) (PT_PART == (n))
#else
#define PT_IN_PART(n) 1
#endif

namespace {

constexpr int kThreads = 256;      // a 16 x 16 grid of threads
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

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

// Two fp32 values rounded to T (bf16 or fp16) and packed in one word, lo
// in the low half: an A operand pair of wgmma or mma.sync, or two outputs.
template <typename T>
__device__ __forceinline__ uint32_t pack(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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
  float* dm;        // its gradient, one row per query head at
                    // dm + (b * H + h) * SK
  long long km_b, km_h;
  // the tile mode (TM): the mask's query-row stride, so that score (r, c)
  // of (b, h) adds km[b * km_b + h * km_h + r * km_q + c] (a stride is 0
  // over a broadcast dim); dm (or null) then takes ds / scale per
  // element, [B * H, SQ, SK]
  long long km_q;
  // the tile mode's class table (tile_classes; read by the wgmma
  // kernels): the class of cell (rt, ct) of (b, h) at tcls + b * tc_b + h
  // * tc_h + rt * ceil(SK / 64) + ct (a stride is 0 over a broadcast dim),
  // and (the forward) cell row rt's full-row flag at tfull + b * tf_b + h
  // * tf_h + rt
  const uint8_t* tcls;
  const uint8_t* tfull;
  long long tc_b, tc_h, tf_b, tf_h;
  uint32_t seed0, seed1, thresh;  // dropout: seed words, keep threshold
  // the hash's global coordinates: the global query-head count and this
  // launch's first batch row and first head in the global batch and heads
  uint32_t hg, b0, h0;
  float dscale;                   // 1 / (1 - rate), rounded on the host
  int blocks;  // the tile forward's grid (read on the host; 0: one an SM)
};

// An additive key-row value at or below this is padding: exp(score + row
// - lse) of such a key is exactly 0 in fp32 in any query row that also
// sees a live key (BERT's padding is -1e4, -9984 in bf16).
constexpr float kPadLevel = -1e3f;

// Whether query head h's work on keys [c0, c0 + BK) is exactly zero, so
// that a dK/dV block may skip it: every key of the tile is padding in
// h's key row, and every query row that sees the tile also sees a live
// key (there is one in the row, non-causal and without a window; causal
// without a window, one before c0). Block-uniform; every thread calls it.
template <int BK>
__device__ __forceinline__ bool padded_tile(const Geom& g, const float* kmr,
                                            int c0) {
  if (g.window > 0) return false;
  const int hi = g.causal ? min(c0, g.SK) : g.SK;
  int tile_live = 0, seen_live = 0;
  for (int c = threadIdx.x; c < g.SK; c += blockDim.x) {
    const bool live = kmr[c] > kPadLevel;
    if (c >= c0 && c < c0 + BK) tile_live |= live;
    else if (c < hi) seen_live |= live;
  }
  return !__syncthreads_or(tile_live) && __syncthreads_or(seen_live);
}

// padded_tile's rule for every key tile [t BK, t BK + BK) of the key row
// kmr with t < 64 at once, by one warp: bit t set means tile t may be
// skipped. Each lane ORs the live bits of its keys' tiles (independent
// loads, so they overlap) and the warp ORs the lanes'; then non-causal
// skips every dead tile if the row has a live key, and causal every dead
// tile above the first live one. Past tile 63 nothing is skipped.
template <int BK>
__device__ __forceinline__ uint64_t padded_tiles(const Geom& g,
                                                 const float* kmr) {
  if (g.window > 0) return 0;
  uint64_t mine = 0;
  bool any = false;
#pragma unroll 4
  for (int c = threadIdx.x & 31; c < g.SK; c += 32)
    if (kmr[c] > kPadLevel) {
      any = true;
      if (c / BK < 64) mine |= 1ull << (c / BK);
    }
  const uint64_t live =
      __reduce_or_sync(0xffffffffu, (uint32_t)mine) |
      (uint64_t)__reduce_or_sync(0xffffffffu, (uint32_t)(mine >> 32)) << 32;
  if (!__any_sync(0xffffffffu, any)) return 0;
  const int nt = (g.SK + BK - 1) / BK;
  uint64_t skip = ~live & (nt >= 64 ? ~0ull : (1ull << nt) - 1);
  if (g.causal) skip &= ~(((live & (0ull - live)) << 1) - 1);
  return skip;
}

// The dropout hash of one query head: everything but (row, col). The
// launch's head bh = b * H + h is hashed at its global place (b0 + b) * hg
// + h0 + h, so a rank holding a dp chunk of the batch or an mp chunk of
// the heads draws the elements one launch over the whole tensor draws
// (at b0 = h0 = 0 and hg = H it is bh).
__device__ __forceinline__ uint32_t head_salt(const Geom& g, int bh) {
  const int b = bh / g.H;
  const uint32_t head =
      (g.b0 + (uint32_t)b) * g.hg + g.h0 + (uint32_t)(bh - b * g.H);
  return g.seed0 * 0x9E3779B9u + (head + 1u) * 0x85EBCA6Bu + g.seed1;
}

// The hash's row and column multipliers: the sum it mixes is r * kRowMul
// + c * kColMul + salt (uint32), so a tile's loop adds a row term and a
// column term it computed once.
constexpr uint32_t kRowMul = 0x27D4EB2Fu, kColMul = 0x165667B1u;

// Whether the element whose hash sum is x is kept (murmur3's fmix32).
__device__ __forceinline__ bool keep_sum(uint32_t x, uint32_t thresh) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= thresh;
}

// Whether element (r, c) of the head with salt `salt` is kept: the
// reference's _keep_mask (global row r, global key c).
__device__ __forceinline__ bool keep(const Geom& g, uint32_t salt, int r,
                                     int c) {
  return keep_sum((uint32_t)r * kRowMul + (uint32_t)c * kColMul + salt,
                  g.thresh);
}

__device__ __forceinline__ const float* km_row(const Geom& g, int b, int h) {
  return g.km + b * g.km_b + h * g.km_h;
}

// The tile mode's mask value of query row r (0 past SQ) and key c < SK
// in the (b, h) slice kmt = km_row(g, b, h).
__device__ __forceinline__ float tile_mask(const Geom& g, const float* kmt,
                                           int r, int c) {
  return r < g.SQ ? kmt[(long long)r * g.km_q + c] : 0.f;
}

// Whether query row r sees any key (bottom-right causal; the tile mode
// takes no window).
__device__ __forceinline__ bool row_sees(const Geom& g, int r) {
  return !g.causal || r + g.SK - g.SQ >= 0;
}

// The tile mode's p of every key of a fully masked row (lse <= -0.5e30:
// each score is the reference's -1e30, so its softmax is uniform over the
// SK keys), and 0 for a row that sees no key or lies past SQ.
__device__ __forceinline__ float full_row_p(const Geom& g, int r) {
  return r < g.SQ && row_sees(g, r) ? 1.f / g.SK : 0.f;
}

// Whether query row r, whose lse is l, is fully masked in the tile mode:
// it lies before SQ, sees a key and its lse is at or below -0.5e30 (its p
// is 1 / SK on every key, full_row_p).
__device__ __forceinline__ bool full_row(const Geom& g, float l, int r) {
  return r < g.SQ && row_sees(g, r) && !(l > 0.5f * kNegInf);
}

// The tile mode's cells: 64 x 64 (query rows x keys) of a (mask batch,
// mask head) slice, classed by tile_classes as kTileMixed, kTileZero
// (every value exactly 0) or kTileDead (every value at or below -0.5e30);
// cells past SQ or SK count by their in-range part. The backward kernels
// give each consumer warpgroup one of these modes per stage, or
// kTileSkip, with the flag kTileFull where its rows hold a fully masked
// row (the only case in which a DEAD cell is visited). The classes are
// shared with ops/cuda/flash_attention.py.
constexpr int kCell = 64;
constexpr int kTileMixed = 0, kTileZero = 1, kTileDead = 2, kTileSkip = 3;
constexpr int kTileFull = 4;

__device__ __forceinline__ const uint8_t* cell_row(const Geom& g, int b,
                                                   int h) {
  return g.tcls + b * g.tc_b + h * g.tc_h;
}

// The class pass (pt_flash_tile_classes). It replaces no TPU kernel: the
// Pallas kernels skip dead tiles by their causal block index, and this
// table lets the tile mode's wgmma kernels skip the cells an arbitrary
// mask leaves dead. grid = (ceil(SQ / 64), mb * mh): one block per cell
// row of a (mask batch, mask head) slice (kb, kh 0 over a broadcast dim:
// one slice) reads the row's in-range values once through the mask's
// strides (thread t: column t % 64 of rows t / 64 + 4 i of every cell)
// and writes each cell's class to out[mb, mh, ceil(SQ / 64), ceil(SK /
// 64)] and the row's full-row flag to full[mb, mh, ceil(SQ / 64)]: 1
// where some row of the 64 that sees a key (bottom-right causal when
// causal is set) has no value above -0.5e30 among the keys it sees (a
// fully masked row: the forward visits every key tile for it). A thread
// loads a cell's 16 values before it tests any (so that the loads
// overlap, where a load behind each test waited for the one before) and
// keeps a DEAD and a ZERO bit per cell for 32 cells at a time, and the
// block ANDs the bits once per 32 cells; each row's live bit is a plain
// store of 1 into shared memory. So the table is deterministic without atomics or a
// zeroed output, and one launch writes both. Bound by bytes (and, with
// few slices, by the latency of its loads).
__global__ void __launch_bounds__(256)
tile_classes_kernel(const float* __restrict__ km, long long kb, long long kh,
                    long long kq, int mh, int SQ, int SK, int causal,
                    uint8_t* __restrict__ out, uint8_t* __restrict__ full) {
  __shared__ int live[kCell];            // row r sees a value above -0.5e30
  __shared__ uint32_t sdead[8], szero[8];  // each warp's cell bits
  const int rt = blockIdx.x, z = blockIdx.y, nct = (SK + kCell - 1) / kCell;
  const int bm = z / mh, hm = z - bm * mh, r0 = rt * kCell;
  const float* base = km + bm * kb + hm * kh + (long long)r0 * kq;
  const int nr = min(kCell, SQ - r0), c = threadIdx.x & (kCell - 1);
  const int rq = threadIdx.x / kCell, off = SK - SQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < kCell) live[threadIdx.x] = 0;
  int mine = 0;  // bit i: row rq + 4 i sees a live value in this column
  for (int ct0 = 0; ct0 < nct; ct0 += 32) {
    const int n = min(32, nct - ct0);
    uint32_t dead = 0, zero = 0;  // bit j: cell ct0 + j
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
      // the cell's 16 values of this thread, loaded before any is used
      // (clamped into range, so that no load waits on a branch)
      const int col = (ct0 + j) * kCell + c, cc = min(col, SK - 1);
      float x[kCell / 4];
#pragma unroll
      for (int i = 0; i < kCell / 4; ++i)
        x[i] = base[min(rq + 4 * i, nr - 1) * kq + cc];
      int d = 1, zr = 1;
#pragma unroll
      for (int i = 0; i < kCell / 4; ++i) {
        const int r = rq + 4 * i;
        if (r < nr && col < SK) {
          d &= x[i] <= 0.5f * kNegInf;
          zr &= x[i] == 0.f;
          if (x[i] > 0.5f * kNegInf && (!causal || col <= r0 + r + off))
            mine |= 1 << i;
        }
      }
      dead |= (uint32_t)d << j;
      zero |= (uint32_t)zr << j;
    }
    dead = __reduce_and_sync(0xffffffffu, dead);
    zero = __reduce_and_sync(0xffffffffu, zero);
    if (lane == 0) {
      sdead[warp] = dead;
      szero[warp] = zero;
    }
    __syncthreads();
    if (threadIdx.x < n) {
      dead = zero = ~0u;
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        dead &= sdead[w];
        zero &= szero[w];
      }
      const int j = threadIdx.x;
      out[((long long)z * gridDim.x + rt) * nct + ct0 + j] =
          (dead >> j) & 1 ? kTileDead : (zero >> j) & 1 ? kTileZero
                                                        : kTileMixed;
    }
    __syncthreads();  // sdead, szero free for the next 32 cells
  }
#pragma unroll
  for (int i = 0; i < kCell / 4; ++i)
    if ((mine >> i) & 1) live[rq + 4 * i] = 1;
  __syncthreads();
  if (threadIdx.x < 32) {
    bool f = false;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = threadIdx.x + 32 * h;
      f |= r < nr && (!causal || r0 + r + off >= 0) && !live[r];
    }
    f = __any_sync(0xffffffffu, f);
    if (threadIdx.x == 0) full[(long long)z * gridDim.x + rt] = f;
  }
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
// Forward: O and lse. grid = (ceil(SQ / BQ), B * H). TM: the tile
// mode's mask is added to each visible score, every key tile is visited
// (a fully masked row averages V over all SK keys, as the reference's
// softmax of equal -1e30 scores does) and a row outputs 0 only when it
// sees no key.
template <typename T, int DMAX, int BQ, int BK, bool KM, bool DROP,
          bool TM = false>
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
  const float* kmr = KM || TM ? km_row(g, b, h) : nullptr;
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
  if (TM) kt0 = 0, kt1 = (g.SK + BK - 1) / BK;
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
        } else if (TM) {
          x = visible(g, r, c) ? x + tile_mask(g, kmr, r, c) : kNegInf;
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
    const bool valid = TM ? row_sees(g, r) : m[i] > 0.5f * kNegInf;
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
// before ds, and p comes back dropped (the operand of dV). TM: kmr is the
// (b, h) slice of the tile mode's mask; a fully masked row takes
// full_row_p, and ds is 0 where the row does not see the key.
template <typename T, int LD, int RM, int CN, bool KM, bool DROP,
          bool TM = false>
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
      float pv = live ? expf(x - lse_r[i]) : 0.f;
      bool seen = true;  // TM: whether the row sees the key
      if (TM) {
        seen = r < g.SQ && c < g.SK && visible(g, r, c);
        pv = !row_ok ? (c < g.SK ? full_row_p(g, r) : 0.f)
             : seen  ? expf(x + tile_mask(g, kmr, r, c) - lse_r[i])
                     : 0.f;
      }
      float dpv = dp[i][j], pd = pv;
      if (DROP) {
        const float dmk = keep(g, salt, r, c) ? g.dscale : 0.f;
        dpv *= dmk;
        pd = pv * dmk;
      }
      p[i][j] = pd;
      ds[i][j] = seen ? pv * (dpv - delta_r[i]) * g.scale : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// dQ. grid = (ceil(SQ / BQ), B * H). TM: every key tile.
template <typename T, int DMAX, int BQ, int BK, bool KM, bool DROP,
          bool TM = false>
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
  const float* kmr = KM || TM ? km_row(g, b, h) : nullptr;
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
  if (TM) kt0 = 0, kt1 = (g.SK + BK - 1) / BK;
  for (int kt = kt0; kt < kt1; ++kt) {
    const int c0 = kt * BK;
    __syncthreads();  // the previous tile is done with sK, sV and sDS
    load_tile<T, BK, LD>(sK, kg, sk_.s, c0, g.SK, d);
    load_tile<T, BK, LD>(sV, vg, sv_.s, c0, g.SK, d);
    __syncthreads();
    float p[RM][CN], ds[RM][CN];
    probs_and_ds<T, LD, RM, CN, KM, DROP, TM>(g, sQ, sdO, sK, sV, r0, c0,
                                              lse_r, delta_r, tx, ty, kmr,
                                              salt, p, ds);
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
// dK and dV. grid = (ceil(SK / BK), B * HKV). The block sums over the
// h / h_kv query heads of its kv head and their live query tiles. With
// KM it also writes dmask = sum_rows ds / scale for its keys, one row
// per query head at dm + (b * H + h) * SK. TM: every query tile, and
// ds / scale per element into dm when it is given.
template <typename T, int DMAX, int BQ, int BK, bool KM, bool DROP,
          bool TM = false>
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
  const int b = blockIdx.y / g.HKV;
  const int hk = blockIdx.y - b * g.HKV;
  const int group = g.H / g.HKV;
  const int c0 = blockIdx.x * BK;
  const int d = g.d;
  // this thread's key column of dmask (threads 0..BK-1), summed in
  // registers in a fixed order
  const int mc = c0 + threadIdx.x;
  float dm_acc = 0.f;
  int qt0, qt1;
  query_tiles<BQ, BK>(g, c0, &qt0, &qt1);
  if (TM) qt0 = 0, qt1 = (g.SQ + BQ - 1) / BQ;
  {
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
      const float* kmr = KM || TM ? km_row(g, b, h) : nullptr;
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
        probs_and_ds<T, LD, RM, CN, KM, DROP, TM>(g, sQ, sdO, sK, sV, r0,
                                                  c0, lse_r, delta_r, tx, ty,
                                                  kmr, salt, p, ds);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) {
            sP[(ty + 16 * i) * LDP + tx + 16 * j] = p[i][j];
            sDS[(ty + 16 * i) * LDP + tx + 16 * j] = ds[i][j];
            const int r = r0 + ty + 16 * i, c = c0 + tx + 16 * j;
            if (TM && g.dm && r < g.SQ && c < g.SK)
              g.dm[(bh * g.SQ + r) * g.SK + c] = ds[i][j] / g.scale;
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
      if (KM) {  // this query head's dmask row
        if (threadIdx.x < BK && mc < g.SK)
          g.dm[bh * g.SK + mc] = dm_acc / g.scale;
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
}

// ---------------------------------------------------------------------------
// mma.sync kernel: dK/dV with a key row or dropout at 64 < d <= 128
// (bf16 or fp16: T). The same grid, masks and arithmetic as above, but
// each warp owns 16 keys of the output tile and computes its products
// with mma.sync.m16n8k16 (T operands, fp32 accumulators); P and dS are
// rounded to T once as operands of the next product, as
// FlashAttention-2 does. Tiles are padded by 8 elements per row (16
// bytes) so ldmatrix and the 32-bit fragment loads hit distinct banks;
// columns d..DMAX are zero-filled so the contraction over the head
// dimension runs in whole k16 steps.
namespace tc {

constexpr int kWarps = 4;
constexpr int kThreadsTc = 32 * kWarps;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two 16-bit elements (bf16 or fp16) as one word.
template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a * b for one 16 x 8 fp32 tile of T (bf16 or fp16) operands.
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same_v<T, __half>)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (16 x 16) of a row-major shared tile: rows r0.., cols k0..
template <int LD, typename T>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const T* s,
                                       int r0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  a[0] = ld32(s + (r0 + g) * LD + k0 + 2 * t);
  a[1] = ld32(s + (r0 + g + 8) * LD + k0 + 2 * t);
  a[2] = ld32(s + (r0 + g) * LD + k0 + 2 * t + 8);
  a[3] = ld32(s + (r0 + g + 8) * LD + k0 + 2 * t + 8);
}

// B fragment (16 x 8) with B[k][n] = M[n0 + n][k0 + k], M row-major: the
// product contracts over M's columns (Q.K^T, dO.V^T).
template <int LD, typename T>
__device__ __forceinline__ void frag_b_rows(uint32_t& b0, uint32_t& b1,
                                            const T* m, int n0, int k0,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
  b0 = ld32(m + (n0 + g) * LD + k0 + 2 * t);
  b1 = ld32(m + (n0 + g) * LD + k0 + 2 * t + 8);
}

// B fragments of two 16 x 8 tiles with B[k][n] = M[k0 + k][n0 + n], M
// row-major: the product contracts over M's rows (P.V, dS.K, P^T.dO,
// dS^T.Q). ldmatrix .trans reads the 8 x 8 blocks transposed.
template <int LD, typename T>
__device__ __forceinline__ void frag_b_cols(uint32_t (&b)[4], const T* m,
                                            int k0, int n0, int lane) {
  const T* p = m + (k0 + (lane & 15)) * LD + n0 + (lane >> 4) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(smem_addr(p)));
}

// Rows [row0, row0 + R) of one (batch, head) slice into a shared [R, LD]
// tile in 16-byte vectors; rows past `rows` and columns d..DMAX are 0.
template <int R, int LD, int DMAX, typename T>
__device__ __forceinline__ void load_tile(T* sm, const T* __restrict__ g,
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

// p and ds of a warp's 16 x (8 * NT) tile from raw scores s^T and dO.V^T
// products dp^T, in place: s becomes p, dp becomes ds. Row i of the tile
// is key (row0 + gq + 8 * (e >> 1)), column query (col0 + 8 * j + 2 * tq +
// (e & 1)); lse and delta are looked up per query through `stat`. With
// KM the key row kmr is added to the scaled scores; with DROP, dp is
// masked and scaled before ds and s becomes the dropped p (the operand of
// dV).
template <int NT, bool KM, bool DROP, typename Stat>
__device__ __forceinline__ void probs_ds(const Geom& g, float (&s)[NT][4],
                                         float (&dp)[NT][4], int row0,
                                         int col0, int gq, int tq,
                                         const float* kmr, uint32_t salt,
                                         Stat stat) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kc = row0 + gq + (e >> 1) * 8;
      const int qr = col0 + 8 * j + 2 * tq + (e & 1);
      float lse_q, delta_q;
      stat(8 * j + 2 * tq + (e & 1), &lse_q, &delta_q);
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

// dK and dV. grid = (ceil(SK / 64), B * HKV), 4 warps of 16 keys; the
// block sweeps its group's q heads x 32-row query tiles. With KM each
// thread sums ds over the query columns of its two keys in registers;
// the four lanes of a key row are reduced by shuffles when the query
// head's dmask row is written, and a query head whose work on the tile
// is exactly zero (padded_tile) is skipped.
template <int DMAX, bool KM, bool DROP, typename T>
__global__ void __launch_bounds__(kThreadsTc)
flash_bwd_dkv_tc(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, Geom g, Strides sq_, Strides sk_,
                 Strides sv_, Strides sdo_, Strides sdk_, Strides sdv_) {
  constexpr int BQ = 32, BK = 64, LD = DMAX + 8;
  constexpr int KS = DMAX / 16, NT = BQ / 8, DT = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);  // [BK, LD]
  T* sV = sK + BK * LD;                    // [BK, LD]
  T* sQ = sV + BK * LD;                    // [BQ, LD]
  T* sdO = sQ + BQ * LD;                   // [BQ, LD]
  float* sLse = reinterpret_cast<float*>(sdO + BQ * LD);  // [BQ]
  float* sDelta = sLse + BQ;                               // [BQ]
  const int lane = threadIdx.x & 31, wk = (threadIdx.x >> 5) * 16;
  const int gq = lane >> 2, tq = lane & 3;
  const int b = blockIdx.y / g.HKV;
  const int hk = blockIdx.y - b * g.HKV;
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
  {
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
      const T* qg = q + b * sq_.b + h * sq_.h;
      const T* dog = dout + b * sdo_.b + h * sdo_.h;
      const float* kmr = KM ? km_row(g, b, h) : nullptr;
      const uint32_t salt = DROP ? head_salt(g, (int)bh) : 0u;
      const bool skip = KM && padded_tile<BK>(g, kmr, c0);
      for (int qt = skip ? qt1 : qt0; qt < qt1; ++qt) {
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
            mma<T>(s[j], ak, b0, b1);
            frag_b_rows<LD>(b0, b1, sdO, 8 * j, 16 * ks, lane);
            mma<T>(dp[j], av, b0, b1);
          }
        }
        probs_ds<NT, KM, DROP>(g, s, dp, c0 + wk, r0, gq, tq, kmr, salt,
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
          const uint32_t ap[4] = {
              pack<T>(s[2 * kk][0], s[2 * kk][1]),
              pack<T>(s[2 * kk][2], s[2 * kk][3]),
              pack<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
              pack<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
          const uint32_t ad[4] = {
              pack<T>(dp[2 * kk][0], dp[2 * kk][1]),
              pack<T>(dp[2 * kk][2], dp[2 * kk][3]),
              pack<T>(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
              pack<T>(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
          for (int j = 0; j < DT; j += 2) {
            uint32_t bb[4];
            frag_b_cols<LD>(bb, sdO, 16 * kk, 8 * j, lane);
            mma<T>(acc_v[j], ap, bb[0], bb[1]);
            mma<T>(acc_v[j + 1], ap, bb[2], bb[3]);
            frag_b_cols<LD>(bb, sQ, 16 * kk, 8 * j, lane);
            mma<T>(acc_k[j], ad, bb[0], bb[1]);
            mma<T>(acc_k[j + 1], ad, bb[2], bb[3]);
          }
        }
      }
      if (KM) write_dm(bh * g.SK);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = c0 + wk + gq + 8 * i;
      if (c >= g.SK) continue;
      T* krow = dk + b * sdk_.b + (long long)c * sdk_.s + hk * sdk_.h;
      T* vrow = dv + b * sdv_.b + (long long)c * sdv_.s + hk * sdv_.h;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const int col = 8 * j + 2 * tq;
        if (col < g.d) {
          *reinterpret_cast<uint32_t*>(krow + col) =
              pack<T>(acc_k[j][2 * i], acc_k[j][2 * i + 1]);
          *reinterpret_cast<uint32_t*>(vrow + col) =
              pack<T>(acc_v[j][2 * i], acc_v[j][2 * i + 1]);
        }
      }
    }
  }
}


// Shared-memory bytes of the mma.sync kernel (2-byte elements).
template <int DMAX>
struct Smem {
  static constexpr size_t row = (DMAX + 8) * 2;
  static constexpr size_t dkv = 2 * 64 * row + 2 * 32 * row + 2 * 32 * 4;
};

}  // namespace tc

// ---------------------------------------------------------------------------
// wgmma kernels: bf16 (or fp16: T), d <= 128, warp-specialised. Two consumer
// warpgroups (threads 0-255, 64 rows each) compute with wgmma from
// 128-byte-swizzled shared tiles; one producer warp (threads 256-287, the
// first of a producer warpgroup where the consumers take its registers)
// keeps TMA loads in flight through a ring of STAGES tiles, signalled by
// mbarriers (full: the tile has landed; empty: all 256 consumer threads
// are done with it). Layouts and descriptors: hopper.cuh.
namespace wg {

using namespace hopper;
typedef __nv_bfloat16 bf16;
constexpr int kConsumers = 256;
constexpr int kThreadsWg = kConsumers + 32;
// The backward kernels' and the variant forwards' warp-specialised
// blocks: two consumer warpgroups (threads 0-255) and a producer
// warpgroup (256-383) whose first warp issues the TMA loads. setmaxnreg
// moves registers from the producer (kRegsProducer a thread) to the
// consumers (kRegsConsumer), whose accumulators and score tiles need
// about 200 a thread at d 128 (ptxas caps a 384-thread block at 168
// otherwise, and a 288-thread one too).
constexpr int kThreadsWs = kConsumers + 128;
constexpr int kRegsProducer = 24, kRegsConsumer = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A compile-time flag passed to a generic lambda (its ::value).
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 1024-byte aligned base of the dynamic shared memory (the 128-byte
// swizzle repeats every 1024 bytes, and the descriptors assume it).
__device__ __forceinline__ char* aligned_smem() {
  extern __shared__ __align__(16) unsigned char smem_wg[];
  const uintptr_t p = reinterpret_cast<uintptr_t>(smem_wg);
  return reinterpret_cast<char*>((p + 1023) & ~uintptr_t(1023));
}

// An [R, DMAX] tile of rows [row0, row0 + R) of head `head` of batch row
// `b`, one TMA box per 64 columns; rows past the sequence and columns
// past d arrive as zeros.
template <int R, int DMAX>
__device__ __forceinline__ void load_tile(char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int head, int row0,
                                          int b) {
#pragma unroll
  for (int a = 0; a < DMAX / 64; ++a)
    tma_load_4d(dst + a * R * 128, map, bar, 64 * a, head, row0, b);
}

// The producer warp's copy of key tile [c0, c0 + BK) of the key row kmr
// into the stage's shared row (zeros past SK), by cp.async, 4 bytes a
// key: a row may start at any float. Each lane then arrives on the
// stage's full barrier once its copies land, so the producer moves on
// without waiting for them.
template <int BK>
__device__ __forceinline__ void copy_key_row(float* skm, const float* kmr,
                                             int c0, int SK, uint64_t* bar) {
  for (int c = threadIdx.x & 31; c < BK; c += 32)
    cp_async4(skm + c, kmr + min(c0 + c, SK - 1), c0 + c < SK);
  cp_async_arrive(bar);
}

// The producer warp of a kernel with a key row (KM): it visits the
// block's key tiles [kt0, kt1), first to last without causal masking
// (right padding leaves the live tiles first), else last to first, and
// for each tile waits for a free stage s, copies the tile's key row into
// the stage's row (copy_key_row), writes the tile's index to the stage's
// slot skt[s] and (lane 0) loads K and V (load_kv(s, kt), which arrives on
// full[s]). The first tile is loaded before the key row is scanned
// (padded_tiles), so that the scan runs under its load; a later tile the
// scan finds wholly padding is neither loaded nor announced. A stage
// whose slot holds -1 ends the tiles. full[s] counts 33 arrivals: the
// lanes' copies, and lane 0's load.
template <int BK, int ST, typename LoadKV>
__device__ __forceinline__ void key_tile_producer(
    const Geom& g, const float* kmr, int kt0, int kt1, float* skm, int* skt,
    uint64_t* full, uint64_t* empty, LoadKV load_kv) {
  const int lane = threadIdx.x & 31;
  uint64_t skip = 0;
  int i = 0;
  for (int n = 0; n < kt1 - kt0; ++n) {
    const int kt = g.causal ? kt1 - 1 - n : kt0 + n;
    if (n > 0 && kt < 64 && ((skip >> kt) & 1)) continue;
    const int s = i % ST;
    mbar_wait(empty + s, ((i / ST) & 1) ^ 1);
    copy_key_row<BK>(skm + s * BK, kmr, kt * BK, g.SK, full + s);
    if (lane == 0) {
      skt[s] = kt;
      load_kv(s, kt);
    }
    if (n == 0) skip = padded_tiles<BK>(g, kmr);
    ++i;
  }
  const int s = i % ST;
  mbar_wait(empty + s, ((i / ST) & 1) ^ 1);
  if (lane == 0) {
    skt[s] = -1;
    mbar_arrive(full + s);
  }
  mbar_arrive(full + s);
}

// The tile mode: one warp's copy of the mask cell rows [row0, row0 + 64) x
// keys [c0, c0 + 64) of the (b, h) slice kmt (query-row stride kq, unit
// key stride) into a shared [64, LDM] fp32 tile by cp.async, 16 bytes a
// copy where the slice starts 16-byte aligned and kq is a multiple of 4
// (vec), else 4 (a row may then start at any float); values past SQ or SK
// arrive as zeros. A lane keeps its columns and steps its row, so that a
// copy costs the producer few instructions beside the consumers' on its
// scheduler.
template <int LDM>
__device__ __forceinline__ void copy_mask(float* dst, const float* kmt,
                                          long long kq, int row0, int c0,
                                          int SQ, int SK, bool vec) {
  const int lane = threadIdx.x & 31;
  if (vec) {  // lane: 4 columns, rows lane / 16, + 2, ...
    const int c = (lane & 15) * 4, r = lane >> 4, col = c0 + c;
    const int n = 4 * min(4, max(0, SK - col));
    const float* src = kmt + (long long)(row0 + r) * kq + (n ? col : 0);
    dst += r * LDM + c;
#pragma unroll 8
    for (int row = row0 + r; row < row0 + kCell; row += 2) {
      cp_async16(dst, row < SQ && n ? src : kmt, row < SQ ? n : 0);
      dst += 2 * LDM;
      src += 2 * kq;
    }
  } else {  // lane: columns lane and lane + 32, every row
    for (int r = 0; r < kCell; ++r) {
      const int row = row0 + r;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = c0 + lane + 32 * h;
        const bool ok = row < SQ && col < SK;
        cp_async4(dst + r * LDM + lane + 32 * h,
                  ok ? kmt + row * kq + col : kmt, ok);
      }
    }
  }
}

// Whether the mask slice kmt takes copy_mask's 16-byte copies.
__device__ __forceinline__ bool mask_vec(const Geom& g, const float* kmt) {
  return !(reinterpret_cast<uintptr_t>(kmt) & 15) && !(g.km_q & 3);
}

// The tile mode's producer warp of a block of 128 query rows: dQ's, and
// the forward's (FWD). The rows are two cells of the class table, one
// per consumer warpgroup. A warpgroup's mode for key tile kt is its
// cell's class, but it skips (kTileSkip) a DEAD cell, and in the forward
// a tile past the causal band of its rows, unless its 64 rows hold a
// fully masked row (bit w of full_rows(): in dQ from the rows' lse, whose
// p is 1 / SK on every key, so its ds on a dead cell is not 0; in the
// forward from the class pass's flag, since such a row averages V over
// every key, hidden ones included). dQ's tiles [kt0, kt1) are the
// block's causal band (past it every ds is 0, a fully masked row's too);
// the forward's are all. A tile both warpgroups skip is neither loaded
// nor announced. The tiles run from kt1 - 1 down to kt0. For each tile it
// loads, it waits for a free stage s, copies the mask of each cell whose
// values the warpgroup adds (MIXED, and in the forward a DEAD cell that a
// fully masked row visits) into the stage's [128, LDM] tile (rows of
// warpgroup w from row 64 w), writes kt to skt[s] and the modes to
// smode[2 s + w], and (lane 0) loads K and V (load_kv). A stage whose
// slot holds -1 ends the tiles. full[s] counts 33 arrivals: the lanes'
// copies, and lane 0's load. The classes of 32 tiles at a time are read
// one a lane and passed round by shuffles; the first classes are read
// before full_rows() reads its own, so that the block waits for one read
// before its first load. i counts the ring's stages used before this
// call; the count after the end stage is returned.
template <int ST, int LDM, bool FWD, typename FullRows, typename LoadKV>
__device__ __forceinline__ int tile_row_producer(
    const Geom& g, int b, int h, int r0, int kt0, int kt1,
    FullRows full_rows, float* smask, int* skt, uint8_t* smode,
    uint64_t* full, uint64_t* empty, LoadKV load_kv, int i) {
  const int lane = threadIdx.x & 31;
  const int nct = (g.SK + kCell - 1) / kCell;
  const uint8_t* cls = cell_row(g, b, h) + (long long)(r0 / kCell) * nct;
  // warpgroup 1's rows start before SQ
  const bool second = r0 + kCell < g.SQ;
  int cl0, cl1;  // the classes of tile kt1 - 1 - n0 - lane
  auto classes = [&](int n0) {
    const int ktl = kt1 - 1 - n0 - lane;
    cl0 = ktl >= kt0 ? cls[ktl] : kTileDead;
    cl1 = ktl >= kt0 && second ? cls[nct + ktl] : kTileDead;
  };
  classes(0);
  const int fr = full_rows();
  int band[2];  // FWD: the last key tile warpgroup w's rows see
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const int last = min(r0 + kCell * w + kCell, g.SQ) - 1 + g.SK - g.SQ;
    band[w] = !FWD || !g.causal ? INT_MAX : last < 0 ? -1 : last / kCell;
  }
  const float* kmt = km_row(g, b, h);
  const bool vec = mask_vec(g, kmt);
  for (int n0 = 0; n0 < kt1 - kt0; n0 += 32) {
    if (n0 > 0) classes(n0);
    for (int n = n0; n < kt1 - kt0 && n < n0 + 32; ++n) {
      const int kt = kt1 - 1 - n;
      int m[2] = {__shfl_sync(0xffffffffu, cl0, n - n0),
                  __shfl_sync(0xffffffffu, cl1, n - n0)};
#pragma unroll
      for (int w = 0; w < 2; ++w)
        m[w] = (fr >> w) & 1                        ? m[w] | kTileFull
               : m[w] == kTileDead || kt > band[w] ? kTileSkip
                                                   : m[w];
      if (m[0] == kTileSkip && m[1] == kTileSkip) continue;
      const int s = i % ST;
      mbar_wait(empty + s, ((i / ST) & 1) ^ 1);
#pragma unroll
      for (int w = 0; w < 2; ++w)
        if ((m[w] & 3) == kTileMixed ||
            (FWD && m[w] == (kTileDead | kTileFull)))
          copy_mask<LDM>(smask + (s * 2 + w) * kCell * LDM, kmt, g.km_q,
                         r0 + kCell * w, kt * kCell, g.SQ, g.SK, vec);
      cp_async_arrive(full + s);
      if (lane == 0) {
        skt[s] = kt;
        smode[2 * s] = (uint8_t)m[0];
        smode[2 * s + 1] = (uint8_t)m[1];
        load_kv(s, kt);
      }
      ++i;
    }
  }
  const int s = i % ST;
  mbar_wait(empty + s, ((i / ST) & 1) ^ 1);
  if (lane == 0) {
    skt[s] = -1;
    mbar_arrive(full + s);
  }
  mbar_arrive(full + s);
  return i + 1;
}

// The tile mode's producer warp of dK/dV. Its items are (query head gi of
// the block's group, 64-row query tile qt), gi major; the block's 128 keys
// are two cells of the class table, one per consumer warpgroup. A
// warpgroup's mode for an item is its cell's class, but it skips
// (kTileSkip) a cell that is DEAD or lies before the causal band of its
// keys (no row of the tile sees one), unless the tile holds a fully masked
// row (full_row: its p is 1 / SK on every key, hidden keys included, so
// its dV there is not 0), and keys wholly past SK; an item both skip is
// neither loaded nor announced. Per item it reads the tile's lse and
// delta first (so that the reads overlap the wait for a stage), then
// waits for a free stage s, writes them to the stage's stats, copies each
// MIXED cell's mask into the stage's [64, LDM] tile (warpgroup w's keys
// from column 64 w), writes gi * ceil(SQ / 64) + qt to sitem[s] and the
// modes to smode[2 s + w], and (lane 0) loads Q and dO (load_q). A stage
// whose slot holds -1 ends the items. full[s] counts 64 arrivals: each
// lane's copies (cp.async) and stats writes (an arrive; lane 0's load
// stands for its one).
template <int BQ, int ST, int LDM, typename LoadQ>
__device__ __forceinline__ void tile_dkv_producer(
    const Geom& g, int b, int hk, int c0, const float* lse,
    const float* delta, float* stats, float* smask, int* sitem,
    uint8_t* smode, uint64_t* full, uint64_t* empty, LoadQ load_q) {
  static_assert(BQ == 64, "a query tile is one cell's rows");
  const int lane = threadIdx.x & 31;
  const int group = g.H / g.HKV, nqt = (g.SQ + BQ - 1) / BQ;
  const int items = group * nqt;
  const int nct = (g.SK + kCell - 1) / kCell, ct0 = c0 / kCell;
  int band[2];  // the first query tile that sees warpgroup w's keys
#pragma unroll
  for (int w = 0; w < 2; ++w)
    band[w] = g.causal ? max(0, c0 + kCell * w - (g.SK - g.SQ)) / BQ : 0;
  // an item's reads: its rows' lse and delta (rows r0 + lane and + 32)
  // and its two cells' classes, made one item ahead of their use
  struct Reads {
    float la, lb, da, db;
    int m0, m1;
  };
  auto read = [&](int it) {
    const int gi = it / nqt, qt = it - gi * nqt, h = hk * group + gi;
    const long long bh = (long long)b * g.H + h;
    const int ra = qt * BQ + lane, rb = ra + 32;
    const uint8_t* cls = cell_row(g, b, h) + (long long)qt * nct + ct0;
    Reads x;
    x.la = ra < g.SQ ? lse[bh * g.SQ + ra] : kNegInf;
    x.lb = rb < g.SQ ? lse[bh * g.SQ + rb] : kNegInf;
    x.da = ra < g.SQ ? delta[bh * g.SQ + ra] : 0.f;
    x.db = rb < g.SQ ? delta[bh * g.SQ + rb] : 0.f;
    x.m0 = cls[0];
    x.m1 = ct0 + 1 < nct ? cls[1] : kTileSkip;
    return x;
  };
  Reads next = read(0);
  int i = 0;
  for (int it = 0; it < items; ++it) {
    const Reads x = next;
    if (it + 1 < items) next = read(it + 1);
    const int gi = it / nqt, qt = it - gi * nqt, h = hk * group + gi;
    const int r0 = qt * BQ;
    const bool fr = __any_sync(0xffffffffu, full_row(g, x.la, r0 + lane) |
                                                full_row(g, x.lb, r0 + lane + 32));
    int m[2] = {x.m0, x.m1};
#pragma unroll
    for (int w = 0; w < 2; ++w)
      if (!fr && (m[w] == kTileDead || qt < band[w])) m[w] = kTileSkip;
      else if (fr && m[w] != kTileSkip) m[w] |= kTileFull;
    if (m[0] == kTileSkip && m[1] == kTileSkip) continue;
    const int s = i % ST;
    mbar_wait(empty + s, ((i / ST) & 1) ^ 1);
    float* sl = stats + s * 2 * BQ;
    sl[lane] = x.la;
    sl[lane + 32] = x.lb;
    sl[BQ + lane] = x.da;
    sl[BQ + lane + 32] = x.db;
    const float* kmt = km_row(g, b, h);
    const bool vec = mask_vec(g, kmt);
#pragma unroll
    for (int w = 0; w < 2; ++w)
      if ((m[w] & 3) == kTileMixed)
        copy_mask<LDM>(smask + s * BQ * LDM + kCell * w, kmt, g.km_q, r0,
                       c0 + kCell * w, g.SQ, g.SK, vec);
    cp_async_arrive(full + s);
    if (lane == 0) {
      sitem[s] = it;
      smode[2 * s] = (uint8_t)m[0];
      smode[2 * s + 1] = (uint8_t)m[1];
      load_q(s, h, r0);
    } else {
      mbar_arrive(full + s);
    }
    ++i;
  }
  const int s = i % ST;
  mbar_wait(empty + s, ((i / ST) & 1) ^ 1);
  if (lane == 0) sitem[s] = -1;
  mbar_arrive(full + s);
  mbar_arrive(full + s);
}

// Forward tiles: 128 query rows (64 per consumer warpgroup) x 128 keys.
// With a key row (KM) each stage also holds its key tile's row (fp32)
// and the tile's index (the plain layout is unchanged).
template <int DMAX, bool KM = false>
struct FwdCfg {
  static constexpr int BQ = 128, BK = 128, STAGES = 2;
  static constexpr int Q_BYTES = BQ * DMAX * 2;
  static constexpr int KV_BYTES = BK * DMAX * 2;
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + STAGES * KV_BYTES;
  // barriers: full_q, full_k[STAGES], full_v[STAGES], empty[STAGES]
  static constexpr int BAR_BYTES = 8 * (1 + 3 * STAGES);
  static constexpr int OFF_KM = (OFF_BAR + BAR_BYTES + 15) / 16 * 16;
  static constexpr int OFF_KT = OFF_KM + STAGES * BK * 4;
  static constexpr size_t SMEM =
      KM ? OFF_KT + STAGES * 4 + 1024 : OFF_BAR + BAR_BYTES + 1024;
};

// Forward (kernel 1, and kernel 4: with KM and DROP). grid = B * H *
// ceil(SQ / 128) blocks, one per output tile, block t taking tile t of
// the list that puts the heaviest causal tiles (the last query rows)
// first. Key tiles run from the last to the first, so the tiles that need
// the causal or ragged mask come first and a block-uniform test skips the
// mask on the rest. KM: the key row's value (copied beside K, scaled to
// log2 units as it is read) is added to the scaled scores, and the
// 128-key tiles that are wholly padding are neither loaded nor visited
// (key_tile_producer, which also announces the tiles, first to last
// without causal masking): their p is exactly 0 and m starts at -1e30,
// so O and lse keep the bits that visiting them gives. DROP: the row sum
// l keeps the undropped fp32 p; only the A operand of P.V takes p * keep
// * dscale, rounded to bf16 once, with the hash's row terms computed once
// per row and its column terms once per tile. The variants run a producer
// warpgroup that gives its registers to the consumers (kThreadsWs
// threads: the key-row values and the hash terms beside the score tile
// spill at 168 a thread). The tile mode runs flash_fwd_tile_wgmma.
template <int DMAX, bool KM, bool DROP, typename T = bf16>
__global__ void __launch_bounds__(KM || DROP ? kThreadsWs : kThreadsWg, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                T* __restrict__ o, float* __restrict__ lse, Geom g,
                Strides so_) {
  using C = FwdCfg<DMAX, KM>;
  constexpr int BQ = C::BQ, BK = C::BK, ST = C::STAGES;
  char* sm = aligned_smem();
  char* sQ = sm;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* full_q = bars;
  uint64_t* full_k = bars + 1;
  uint64_t* full_v = bars + 1 + ST;
  uint64_t* empty = bars + 1 + 2 * ST;
  const int bhs = g.B * g.H;
  const int bh = blockIdx.x % bhs;
  const int b = bh / g.H, h = bh - b * g.H;
  const int hk = h / (g.H / g.HKV);
  const int r0 = ((g.SQ + BQ - 1) / BQ - 1 - blockIdx.x / bhs) * BQ;
  int kt0, kt1;
  key_tiles<BQ, BK>(g, r0, &kt0, &kt1);
  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < ST; ++s) {
      // KM: and the producer warp's 32 lanes, once their copies of the
      // tile's key row land
      mbar_init(full_k + s, KM ? 33 : 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();
  int* skt = reinterpret_cast<int*>(sm + C::OFF_KT);  // KM: tile indices
  auto load_kv = [&](int s, int kt) {
    mbar_expect_tx(full_k + s, C::KV_BYTES);
    load_tile<BK, DMAX>(sm + C::OFF_K + s * C::KV_BYTES, &tm_k, full_k + s,
                        hk, kt * BK, b);
    mbar_expect_tx(full_v + s, C::KV_BYTES);
    load_tile<BK, DMAX>(sm + C::OFF_V + s * C::KV_BYTES, &tm_v, full_v + s,
                        hk, kt * BK, b);
  };

  if (threadIdx.x >= kConsumers) {  // the producer warp(group)
    if constexpr (KM || DROP) regs_dec<kRegsProducer>();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(full_q, C::Q_BYTES);
      load_tile<BQ, DMAX>(sQ, &tm_q, full_q, h, r0, b);
    }
    if constexpr (KM) {  // its first warp
      if (threadIdx.x < kConsumers + 32)
        key_tile_producer<BK, ST>(
            g, km_row(g, b, h), kt0, kt1,
            reinterpret_cast<float*>(sm + C::OFF_KM), skt, full_k, empty,
            load_kv);
    } else if (threadIdx.x == kConsumers) {
      for (int i = 0, kt = kt1 - 1; kt >= kt0; --kt, ++i) {
        const int s = i % ST;
        mbar_wait(empty + s, ((i / ST) & 1) ^ 1);
        load_kv(s, kt);
      }
    }
    return;
  }

  // consumers: warpgroup wq owns tile rows 64 wq .. 64 wq + 63; this
  // thread rows rw and rw + 8 of them
  if constexpr (KM || DROP) regs_inc<kRegsConsumer>();
  const int wq = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int rw = 64 * wq + 16 * ((threadIdx.x >> 5) & 3) + gq;
  const float sl2 = g.scale * kLog2e;  // scores in the log2 domain
  const int offset = g.SK - g.SQ;
  const int rmax = min(r0 + BQ, g.SQ) - 1;
  // the keys row r0 + rw + 8 r sees: [lo[r], hi[r]) (bottom-right causal
  // diagonal, window), and keys past SK do not exist
  int lo[2], hi[2];
  uint32_t hrow[2];  // DROP: the hash's row terms, salt included
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int diag = r0 + rw + 8 * r + offset;
    lo[r] = g.causal && g.window > 0 ? diag - g.window + 1 : INT_MIN;
    hi[r] = g.causal ? diag + 1 : INT_MAX;
    if constexpr (DROP)
      hrow[r] = (uint32_t)(r0 + rw + 8 * r) * kRowMul + head_salt(g, bh);
  }
  float acc[DMAX / 2];
#pragma unroll
  for (int j = 0; j < DMAX / 2; ++j) acc[j] = 0.f;
  const float m0 = kNegInf;
  float m[2] = {m0, m0}, l[2] = {0.f, 0.f};
  mbar_wait(full_q, 0);
  // the key tiles from the last to the first; KM: as the producer announces
  for (int i = 0, kt = kt1 - 1; KM || kt >= kt0; --kt, ++i) {
    const int s = i % ST;
    const uint32_t ph = (i / ST) & 1;
    if constexpr (KM) {
      mbar_wait(full_k + s, ph);
      kt = skt[s];
      if (kt < 0) break;
    }
    const int c0 = kt * BK;
    const char* sK = sm + C::OFF_K + s * C::KV_BYTES;
    const char* sV = sm + C::OFF_V + s * C::KV_BYTES;
    // KM: the tile's key row from this thread's first column, 2 tq
    const float* skm =
        reinterpret_cast<const float*>(sm + C::OFF_KM) + s * BK + 2 * tq;
    mbar_wait(full_k + s, ph);
    float sc[BK / 2];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < DMAX / 16; ++ks)
      wgmma_ss<BK, T>(sc, desc_kmajor<BQ>(sQ, 64 * wq, ks),
                   desc_kmajor<BK>(sK, 0, ks), ks);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    // a mask is needed where the tile crosses the causal diagonal, the
    // window's lower edge or the last key
    const bool masked =
        c0 + BK > g.SK ||
        (g.causal && (c0 + BK - 1 > r0 + offset ||
                      (g.window > 0 && c0 <= rmax + offset - g.window)));
    float mx[2] = {m0, m0};
    if (masked) {
      // keys past SK weigh exactly 0; keys the row does not see get the
      // reference's finite -1e30
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + 8 * j + 2 * tq + (e & 1), r = e >> 1;
          float x = KM ? fmaf(sc[4 * j + e], sl2,
                              skm[8 * j + (e & 1)] * kLog2e)
                       : sc[4 * j + e] * sl2;
          x = c < lo[r] || c >= hi[r] ? kNegInf : x;
          x = c >= g.SK ? -INFINITY : x;
          sc[4 * j + e] = x;
          mx[r] = fmaxf(mx[r], x);
        }
    } else {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        float2 kv = make_float2(0.f, 0.f);
        if constexpr (KM) kv = *reinterpret_cast<const float2*>(skm + 8 * j);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (KM)
            sc[4 * j + e] = fmaf(sc[4 * j + e], sl2,
                                 (e & 1 ? kv.y : kv.x) * kLog2e);
          else
            sc[4 * j + e] *= sl2;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];  // this thread's share of the row sum
    }
    // P rounded to bf16 once as the A operand of P.V; the row sum keeps
    // the fp32 p (undropped)
    const uint32_t hcol = DROP ? (uint32_t)(c0 + 2 * tq) * kColMul : 0u;
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = ex2(sc[4 * j + e] - m[e >> 1]);
        l[e >> 1] += p[e];
        if constexpr (DROP)
          p[e] = keep_sum(hrow[e >> 1] + hcol +
                              (uint32_t)(8 * j + (e & 1)) * kColMul,
                          g.thresh)
                     ? p[e] * g.dscale
                     : 0.f;
      }
      pa[j >> 1][2 * (j & 1)] = pack<T>(p[0], p[1]);
      pa[j >> 1][2 * (j & 1) + 1] = pack<T>(p[2], p[3]);
    }
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }
    mbar_wait(full_v + s, ph);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<DMAX, T>(acc, pa[kk], desc_mnmajor<BK>(sV, kk), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    mbar_arrive(empty + s);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r0 + rw + 8 * r;
    if (row >= g.SQ) continue;
    // m stays at -1e30 iff the row saw no key: it outputs exactly 0
    const bool valid = m[r] > 0.5f * kNegInf;
    const float l_safe = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / l_safe;
    T* orow = o + b * so_.b + (long long)row * so_.s + h * so_.h;
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
      const int col = 8 * j + 2 * tq;
      if (col < g.d)
        *reinterpret_cast<uint32_t*>(orow + col) =
            valid ? pack<T>(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv)
                  : 0u;
    }
    if (tq == 0)
      lse[(long long)bh * g.SQ + row] =
          (valid ? m[r] * kLn2 : kNegInf) + logf(l_safe);
  }
}


// The tile mode's forward tiles: 128 query rows (64 per consumer
// warpgroup: one cell row each) x 64 keys (one cell) in a ring of 3
// stages at d 64 and 2 at d 128, each holding K, V, the [128, LDM] fp32
// mask tile (LDM as DqCfg's: the consumers' float2 reads in the
// accumulator's layout fall in distinct banks), the tile's index and the
// two warpgroups' modes; Q in two slots, so that the producer loads the
// next item's Q while the consumers finish the current one.
template <int DMAX>
struct FwdTileCfg {
  static constexpr int BQ = 128, BK = 64, STAGES = DMAX > 64 ? 2 : 3;
  // the producer's class and copy loops need 40 registers
  static constexpr int REGS_PRODUCER = 40, REGS_CONSUMER = 232;
  static constexpr int LDM = BK + 8;
  static constexpr int Q_BYTES = BQ * DMAX * 2;
  static constexpr int KV_BYTES = BK * DMAX * 2;
  static constexpr int OFF_K = 2 * Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_MASK = OFF_V + STAGES * KV_BYTES;
  static constexpr int OFF_BAR = OFF_MASK + STAGES * BQ * LDM * 4;
  // barriers: full_q[2], empty_q[2], full[STAGES] (K, V and the mask
  // tile: an end stage completes its phase too, so K's and V's phases
  // stay in step across items), empty[STAGES]
  static constexpr int OFF_KT = OFF_BAR + 8 * (4 + 2 * STAGES);
  static constexpr int OFF_MODE = OFF_KT + STAGES * 4;
  static constexpr size_t SMEM = OFF_MODE + 2 * STAGES + 1024;
};

// The tile mode's forward (kernel 1 with a tile mask). Its items are the
// (query head, 128-row query tile) pairs, the heaviest (the last rows)
// first; block t takes items t, t + gridDim.x, ... (grid: one block an
// SM, so that one item's first loads and the class reads run under the
// previous item's tiles and its O and lse stores under the next one's).
// The producer warp loads each item's Q into the free one of two slots,
// then announces its key tiles from the last to the first with each
// warpgroup's mode (tile_row_producer<FWD>: a warpgroup skips a DEAD cell
// and a tile past its rows' causal band unless the class pass flags its
// cell row as holding a fully masked row), loading K and V only for the
// tiles some warpgroup visits and staging the mask of the cells whose
// values it adds. Per tile, each consumer warpgroup that visits it
// computes S = Q.K^T for its 64 rows (wgmma), adds the staged mask values
// in log2 units (a ZERO cell adds nothing: fmaf(s, sl2, 0) rounds as s *
// sl2 does), gives a key the row does not see the reference's -1e30 in
// the same units (so a fully masked row averages V over all SK keys) and
// a key past SK -inf, and runs kernel 1's streaming softmax and P.V
// (wgmma, P from registers, rounded to bf16 once; DROP as kernel 1's).
// Skipping is exact: a row with a live key has a finite m, and a skipped
// DEAD or hidden key's ex2(-1e30 log2e - m) is exactly 0, so O and lse
// keep the bits that visiting every tile in the same order gives. A row
// that sees no key outputs exactly 0 with lse -1e30. m starts at
// -FLT_MAX, so that a first tile whose values are all -inf gives no NaN.
template <int DMAX, bool DROP, typename T = bf16>
__global__ void __launch_bounds__(kThreadsWs, 1)
flash_fwd_tile_wgmma(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     T* __restrict__ o, float* __restrict__ lse, Geom g,
                     Strides so_) {
  using C = FwdTileCfg<DMAX>;
  constexpr int BQ = C::BQ, BK = C::BK, ST = C::STAGES;
  static_assert(BK == kCell && BQ == 2 * kCell, "a warpgroup's tile is a cell");
  char* sm = aligned_smem();
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* full_q = bars;
  uint64_t* empty_q = bars + 2;
  uint64_t* full = bars + 4;
  uint64_t* empty = bars + 4 + ST;
  float* smask = reinterpret_cast<float*>(sm + C::OFF_MASK);
  int* skt = reinterpret_cast<int*>(sm + C::OFF_KT);
  uint8_t* smode = reinterpret_cast<uint8_t*>(sm + C::OFF_MODE);
  const int bhs = g.B * g.H, nqt = (g.SQ + BQ - 1) / BQ;
  const int items = bhs * nqt;
  if (threadIdx.x == 0) {
    for (int q = 0; q < 2; ++q) {
      mbar_init(full_q + q, 1);
      mbar_init(empty_q + q, kConsumers);
    }
    for (int s = 0; s < ST; ++s) {
      // the K and V load, and the producer warp's 32 lanes once their
      // mask copies land
      mbar_init(full + s, 33);
      mbar_init(empty + s, kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup
    regs_dec<C::REGS_PRODUCER>();
    if (threadIdx.x < kConsumers + 32) {  // its first warp
      const int lane = threadIdx.x & 31;
      const int nkt = (g.SK + BK - 1) / BK;
      int i = 0, n = 0;
      for (int t = blockIdx.x; t < items; t += gridDim.x, ++n) {
        const int bh = t % bhs, b = bh / g.H, h = bh - b * g.H;
        const int hk = h / (g.H / g.HKV), r0 = (nqt - 1 - t / bhs) * BQ;
        const int slot = n & 1;
        mbar_wait(empty_q + slot, ((n >> 1) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full_q + slot, C::Q_BYTES);
          load_tile<BQ, DMAX>(sm + slot * C::Q_BYTES, &tm_q, full_q + slot,
                              h, r0, b);
        }
        auto load_kv = [&](int s, int kt) {
          mbar_expect_tx(full + s, 2 * C::KV_BYTES);
          load_tile<BK, DMAX>(sm + C::OFF_K + s * C::KV_BYTES, &tm_k,
                              full + s, hk, kt * BK, b);
          load_tile<BK, DMAX>(sm + C::OFF_V + s * C::KV_BYTES, &tm_v,
                              full + s, hk, kt * BK, b);
        };
        // bit w: cell row r0 / 64 + w holds a fully masked row
        const uint8_t* fl = g.tfull + b * g.tf_b + h * g.tf_h + r0 / kCell;
        auto full_rows = [&]() {
          return (int)fl[0] | (r0 + kCell < g.SQ ? (int)fl[1] << 1 : 0);
        };
        i = tile_row_producer<ST, C::LDM, true>(g, b, h, r0, 0, nkt,
                                                full_rows, smask, skt, smode,
                                                full, empty, load_kv, i);
      }
    }
    return;
  }

  // consumers: warpgroup wq owns tile rows 64 wq .. 64 wq + 63; this
  // thread rows rw and rw + 8 of them
  regs_inc<C::REGS_CONSUMER>();
  const int wq = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int rw = 64 * wq + 16 * ((threadIdx.x >> 5) & 3) + gq;
  const float sl2 = g.scale * kLog2e;   // scores in the log2 domain
  const float neg2 = kNegInf * kLog2e;  // -1e30 in log2 units
  const int offset = g.SK - g.SQ;
  int i = 0, n = 0;
  for (int t = blockIdx.x; t < items; t += gridDim.x, ++n) {
    const int bh = t % bhs, b = bh / g.H, h = bh - b * g.H;
    const int r0 = (nqt - 1 - t / bhs) * BQ;
    const int slot = n & 1;
    const char* sQ = sm + slot * C::Q_BYTES;
    // the keys row r0 + rw + 8 r sees end at hi[r] (bottom-right causal
    // diagonal; the tile mode has no window), and keys past SK do not
    // exist
    int hi[2];
    uint32_t hrow[2];  // DROP: the hash's row terms, salt included
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      hi[r] = g.causal ? r0 + rw + 8 * r + offset + 1 : INT_MAX;
      if constexpr (DROP)
        hrow[r] = (uint32_t)(r0 + rw + 8 * r) * kRowMul + head_salt(g, bh);
    }
    float acc[DMAX / 2];
#pragma unroll
    for (int j = 0; j < DMAX / 2; ++j) acc[j] = 0.f;
    float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f};
    mbar_wait(full_q + slot, (n >> 1) & 1);
    // the key tiles as the producer announces them
    for (;; ++i) {
      const int s = i % ST;
      mbar_wait(full + s, (i / ST) & 1);
      const int kt = skt[s];
      const int mode = smode[2 * s + wq] & 3;
      if (kt < 0 || mode == kTileSkip) {
        mbar_arrive(empty + s);
        if (kt < 0) {
          ++i;
          break;
        }
        continue;
      }
      const int c0 = kt * BK;
      const char* sK = sm + C::OFF_K + s * C::KV_BYTES;
      const char* sV = sm + C::OFF_V + s * C::KV_BYTES;
      // the stage's mask tile from this thread's row rw and column 2 tq
      const float* skm = smask + s * BQ * C::LDM + rw * C::LDM + 2 * tq;
      float sc[BK / 2];
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < DMAX / 16; ++ks)
        wgmma_ss<BK, T>(sc, desc_kmajor<BQ>(sQ, 64 * wq, ks),
                        desc_kmajor<BK>(sK, 0, ks), ks);
      wg_commit();
      wg_wait<0>();
      fence_regs(sc);
      // the causal and ragged tests only where the warpgroup's rows cross
      // the diagonal or the tile the last key
      const bool edge =
          c0 + BK > g.SK || (g.causal && c0 + BK - 1 > r0 + 64 * wq + offset);
      float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        float2 mv[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
        if (mode != kTileZero) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
            mv[r] = *reinterpret_cast<const float2*>(skm + 8 * r * C::LDM +
                                                     8 * j);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + 8 * j + 2 * tq + (e & 1), r = e >> 1;
          float x = fmaf(sc[4 * j + e], sl2,
                         (e & 1 ? mv[r].y : mv[r].x) * kLog2e);
          if (edge) {
            x = c >= hi[r] ? neg2 : x;
            x = c >= g.SK ? -INFINITY : x;
          }
          sc[4 * j + e] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];  // this thread's share of the row sum
      }
      // P rounded to bf16 once as the A operand of P.V; the row sum keeps
      // the fp32 p (undropped)
      const uint32_t hcol = DROP ? (uint32_t)(c0 + 2 * tq) * kColMul : 0u;
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = ex2(sc[4 * j + e] - m[e >> 1]);
          l[e >> 1] += p[e];
          if constexpr (DROP)
            p[e] = keep_sum(hrow[e >> 1] + hcol +
                                (uint32_t)(8 * j + (e & 1)) * kColMul,
                            g.thresh)
                       ? p[e] * g.dscale
                       : 0.f;
        }
        pa[j >> 1][2 * (j & 1)] = pack<T>(p[0], p[1]);
        pa[j >> 1][2 * (j & 1) + 1] = pack<T>(p[2], p[3]);
      }
#pragma unroll
      for (int j = 0; j < DMAX / 8; ++j) {
        acc[4 * j] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<DMAX, T>(acc, pa[kk], desc_mnmajor<BK>(sV, kk), 1);
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(empty + s);
    }
    mbar_arrive(empty_q + slot);  // every product that reads Q is done
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = r0 + rw + 8 * r;
      if (row >= g.SQ) continue;
      const bool valid = row_sees(g, row);
      const float l_safe = fmaxf(l[r], 1e-30f);
      const float inv = 1.f / l_safe;
      T* orow = o + b * so_.b + (long long)row * so_.s + h * so_.h;
#pragma unroll
      for (int j = 0; j < DMAX / 8; ++j) {
        const int col = 8 * j + 2 * tq;
        if (col < g.d)
          *reinterpret_cast<uint32_t*>(orow + col) =
              valid ? pack<T>(acc[4 * j + 2 * r] * inv,
                              acc[4 * j + 2 * r + 1] * inv)
                    : 0u;
      }
      if (tq == 0)
        lse[(long long)bh * g.SQ + row] =
            (valid ? m[r] * kLn2 : kNegInf) + logf(l_safe);
    }
  }
}

// The backward kernels start their blocks in groups of kGroupSlices
// slices (kv heads, or query heads, of the batch rows): block t belongs
// to group t / (kGroupSlices x tiles), and inside the group runs slice t %
// kGroupSlices's tile (t / kGroupSlices) % tiles. Blocks start in t's
// order, so the groups run one after another and inside a group every
// slice's tile 0 starts, then every slice's tile 1, and so on: the tiles
// run in the kernel's order (heaviest first) while the slices in flight
// stay few enough for the operands they share to stay in L2. Blocks past
// the last slice exit at once.
constexpr int kGroupSlices = 16;

int grouped_blocks(int slices, int tiles) {
  return (slices + kGroupSlices - 1) / kGroupSlices * kGroupSlices * tiles;
}

__device__ __forceinline__ void grouped_block(int tiles, int* slice,
                                              int* tile) {
  const int per_group = kGroupSlices * tiles;
  const int grp = blockIdx.x / per_group;
  const int w = blockIdx.x - grp * per_group;
  *slice = grp * kGroupSlices + w % kGroupSlices;
  *tile = w / kGroupSlices;
}

// dK/dV tiles: 128 keys a block (64 per consumer warpgroup), query tiles
// of 64 rows in a ring of STAGES (Q, dO, lse, delta). In the tile mode
// (TM) each stage also holds its [64, LDM] fp32 mask tile (query rows
// down, the block's 128 keys across), the item and the two warpgroups'
// modes, in a ring of 2 at d 128 so that the mask tiles fit.
template <int DMAX, bool TM = false>
struct DkvCfg {
  static constexpr int BK = 128, BQ = 64, STAGES = TM && DMAX > 64 ? 2 : 3,
                       MAX_GROUP = 64;
  // the d 128 consumers need 240 registers; at d 64 the producer's
  // stats loop and skip bits (the tile mode's item loop) need 40 (each
  // split spills nothing)
  static constexpr int REGS_PRODUCER = DMAX > 64 ? kRegsProducer : 40;
  static constexpr int REGS_CONSUMER = DMAX > 64 ? kRegsConsumer : 232;
  // the mask tile's row: 128 keys and 4 floats of padding, so that the
  // consumers' reads down a key column in the S^T layout (a warp: 8 keys
  // x 4 row pairs) fall in distinct banks
  static constexpr int LDM = BK + 4;
  static constexpr int KV_BYTES = BK * DMAX * 2;
  static constexpr int Q_BYTES = BQ * DMAX * 2;
  static constexpr int OFF_V = KV_BYTES;
  static constexpr int OFF_RING = 2 * KV_BYTES;  // Q, dO of stage s
  static constexpr int OFF_STATS = OFF_RING + STAGES * 2 * Q_BYTES;
  static constexpr int OFF_BAR = OFF_STATS + STAGES * 2 * BQ * 4;
  // barriers: full_kv, full[STAGES], empty[STAGES]; then the skip bits
  static constexpr int OFF_SKIP = OFF_BAR + 8 * (1 + 2 * STAGES);
  // TM: the mask tiles, then the items and the modes
  static constexpr int OFF_MASK = (OFF_SKIP + MAX_GROUP + 15) / 16 * 16;
  static constexpr int OFF_ITEM = OFF_MASK + (TM ? STAGES * BQ * LDM * 4 : 0);
  static constexpr int OFF_MODE = OFF_ITEM + STAGES * 4;
  static constexpr size_t SMEM =
      TM ? OFF_MODE + 2 * STAGES + 1024 : OFF_SKIP + MAX_GROUP + 1024;
};

// dK and dV (kernel 3, and kernel 6 at d <= 64). grid = grouped_blocks(B
// * HKV, ceil(SK / 128)): one block per (kv head, 128 keys), within each
// group of kv heads the first key tiles (under causal masking the
// heaviest: they see the most query tiles) first, while the group's Q
// and dO stay in L2 for its key tiles.
// Each block loops over its group's query heads x the query tiles of the
// band. Per item, each consumer warpgroup computes for its 64 keys S^T =
// K.Q^T and dP^T = V.dO^T (wgmma, both operands from shared memory, two
// commit groups so that p is computed while dP^T is still in flight), p
// and ds in registers with the keys as rows, then dV += P^T.dO and dK +=
// dS^T.Q (wgmma, P^T and dS^T from registers, rounded to bf16 once, dO
// and Q MN-major). With KM, dmask rows are written per query head; a
// warpgroup whose 64 keys are wholly padding for a head (padded_tile)
// skips that head's work and writes its exact zeros, and a head that
// both skip is not loaded. TM (the tile mode): the producer announces the
// items and each warpgroup's mode for them (tile_dkv_producer), every
// query tile of each head considered; a skipped cell's p and ds are
// exactly 0, a ZERO cell's scores add nothing, a MIXED cell's add the
// mask values that the producer staged in shared memory, read down this
// thread's key column, and a DEAD cell is visited only for a fully masked
// row, whose p is full_row_p on every key (0 for the other rows); ds is 0
// where the row does not see the key, and written / scale per element
// into dm when it is given ([B * H, SQ, SK], zeros where skipped).
template <int DMAX, bool KM, bool DROP, typename T = bf16, bool TM = false>
__global__ void __launch_bounds__(kThreadsWs, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, Geom g, Strides sdk_,
                    Strides sdv_) {
  using C = DkvCfg<DMAX, TM>;
  constexpr int BK = C::BK, BQ = C::BQ, ST = C::STAGES;
  static_assert(!(KM && TM), "a key row or a tile mask, not both");
  char* sm = aligned_smem();
  float* stats = reinterpret_cast<float*>(sm + C::OFF_STATS);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* full_kv = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + ST;
  uint8_t* skip = reinterpret_cast<uint8_t*>(sm + C::OFF_SKIP);
  float* smask = reinterpret_cast<float*>(sm + C::OFF_MASK);  // TM
  int* sitem = reinterpret_cast<int*>(sm + C::OFF_ITEM);        // TM
  uint8_t* smode = reinterpret_cast<uint8_t*>(sm + C::OFF_MODE);  // TM
  int bhk, kt;
  grouped_block((g.SK + BK - 1) / BK, &bhk, &kt);
  if (bhk >= g.B * g.HKV) return;
  const int b = bhk / g.HKV, hk = bhk - b * g.HKV;
  const int group = g.H / g.HKV;
  const int c0 = kt * BK;
  int qt0, qt1;
  query_tiles<BQ, BK>(g, c0, &qt0, &qt1);
  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < ST; ++s) {
      // TM: each lane's copies and its stats writes
      mbar_init(full + s, TM ? 64 : 32);
      mbar_init(empty + s, kConsumers);
    }
    mbar_fence_init();
  }
  // bit w of skip[gi]: warpgroup w's keys are wholly padding for query
  // head gi (every thread takes part in the block-wide scans)
  for (int gi = 0; gi < group && gi < C::MAX_GROUP; ++gi) {
    const float* kmr = KM ? km_row(g, b, hk * group + gi) : nullptr;
    const bool s0 = KM && padded_tile<64>(g, kmr, c0);
    const bool s1 = KM && padded_tile<64>(g, kmr, c0 + 64);
    if (threadIdx.x == 0) skip[gi] = (uint8_t)(s0 | (s1 << 1));
  }
  __syncthreads();
  auto head_skip = [&](int gi) {
    return gi < C::MAX_GROUP ? (int)skip[gi] : 0;
  };
  // Q and dO of query head h's rows [r0, r0 + 64) into stage s
  auto load_q = [&](int s, int h, int r0) {
    char* ring = sm + C::OFF_RING + s * 2 * C::Q_BYTES;
    mbar_expect_tx(full + s, 2 * C::Q_BYTES);
    load_tile<BQ, DMAX>(ring, &tm_q, full + s, h, r0, b);
    load_tile<BQ, DMAX>(ring + C::Q_BYTES, &tm_do, full + s, h, r0, b);
  };

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup
    regs_dec<C::REGS_PRODUCER>();
    if (threadIdx.x < kConsumers + 32) {  // its first warp loads
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        mbar_expect_tx(full_kv, 2 * C::KV_BYTES);
        load_tile<BK, DMAX>(sm, &tm_k, full_kv, hk, c0, b);
        load_tile<BK, DMAX>(sm + C::OFF_V, &tm_v, full_kv, hk, c0, b);
      }
      if constexpr (TM) {
        tile_dkv_producer<BQ, ST, C::LDM>(g, b, hk, c0, lse, delta, stats,
                                          smask, sitem, smode, full, empty,
                                          load_q);
      } else {
        int i = 0;
        for (int gi = 0; gi < group; ++gi) {
          if (head_skip(gi) == 3) continue;
          const int h = hk * group + gi;
          const long long bh = (long long)b * g.H + h;
          for (int qt = qt0; qt < qt1; ++qt, ++i) {
            const int s = i % ST, r0 = qt * BQ;
            mbar_wait(empty + s, ((i / ST) & 1) ^ 1);
            float* sl = stats + s * 2 * BQ;
            for (int j = lane; j < BQ; j += 32) {
              const int r = r0 + j;
              sl[j] = r < g.SQ ? lse[bh * g.SQ + r] : kNegInf;
              sl[BQ + j] = r < g.SQ ? delta[bh * g.SQ + r] : 0.f;
            }
            if (lane == 0) {
              load_q(s, h, r0);
            } else {
              mbar_arrive(full + s);
            }
          }
        }
      }
    }
  } else {  // the consumer warpgroups
    regs_inc<C::REGS_CONSUMER>();
    // warpgroup wq owns keys c0 + 64 wq ..; this thread key rows kr and
    // kr + 8 of the S^T tiles
    const int wq = threadIdx.x >> 7;
    const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
    const int kr = c0 + 64 * wq + 16 * ((threadIdx.x >> 5) & 3) + gq;
    // the query rows that see key kr + 8 r: [qlo[r], qhi[r])
    // (bottom-right causal diagonal, window); rows past SQ and keys past
    // SK take no part
    int qlo[2], qhi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int c = kr + 8 * r, first = c - (g.SK - g.SQ);
      qlo[r] = g.causal ? first : 0;
      qhi[r] = c >= g.SK ? 0
               : g.causal && g.window > 0 ? min(first + g.window, g.SQ)
                                          : g.SQ;
    }
    float acc_k[DMAX / 2], acc_v[DMAX / 2];
#pragma unroll
    for (int j = 0; j < DMAX / 2; ++j) acc_k[j] = acc_v[j] = 0.f;
    // one item: query head bh's rows [r0, r0 + 64) from stage s, with the
    // key row's values kmv (KM), the dropout salt (DROP) and the mode
    // (TM); KM sums ds into dm. TM: the compile-time flags full_rows (the
    // tile holds a fully masked row; the other tiles keep the plain
    // arithmetic) and write_dm (ds / scale per element into g.dm).
    auto item = [&](auto full_rows, auto write_dm, int s, int r0,
                    long long bh, uint32_t salt, const float (&kmv)[2],
                    int mode, float (&dm)[2]) {
      constexpr bool FULL = decltype(full_rows)::value;
      constexpr bool DMW = decltype(write_dm)::value;
      const char* sQ = sm + C::OFF_RING + s * 2 * C::Q_BYTES;
      const char* sdO = sQ + C::Q_BYTES;
      const float* sl = stats + s * 2 * BQ;
      // TM: the stage's mask tile, from this thread's key column
      const float* smk = smask + s * BQ * C::LDM + (kr - c0);
      float st[32], dpt[32];
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < DMAX / 16; ++ks)
        wgmma_ss<64, T>(st, desc_kmajor<BK>(sm, 64 * wq, ks),
                        desc_kmajor<BQ>(sQ, 0, ks), ks);
      wg_commit();
#pragma unroll
      for (int ks = 0; ks < DMAX / 16; ++ks)
        wgmma_ss<64, T>(dpt, desc_kmajor<BK>(sm + C::OFF_V, 64 * wq, ks),
                        desc_kmajor<BQ>(sdO, 0, ks), ks);
      wg_commit();
      // the tile needs the causal, window or edge tests only where it
      // crosses them
      const int off = g.SK - g.SQ;
      const bool masked =
          r0 + BQ > g.SQ || c0 + BK > g.SK ||
          (g.causal &&
           (c0 + BK - 1 > r0 + off ||
            (g.window > 0 && c0 <= r0 + BQ - 1 + off - g.window)));
      // p (undropped) into st while dP^T is in flight
      wg_wait<1>();
      fence_regs(st);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * tq + (e & 1), qr = r0 + col;
          const float lse_q = sl[col];
          // rows that saw no key in the forward have lse ~ -1e30
          const bool row_ok = lse_q > 0.5f * kNegInf;
          bool live = row_ok;
          if (masked)
            live = live && qr >= qlo[e >> 1] && qr < qhi[e >> 1];
          float x = st[4 * j + e] * g.scale;
          if (KM) x += kmv[e >> 1];
          if (TM && mode == kTileMixed) x += smk[col * C::LDM + 8 * (e >> 1)];
          float p = live ? ex2((x - lse_q) * kLog2e) : 0.f;
          if constexpr (FULL) {
            // a DEAD cell is visited only beside a fully masked row, whose
            // p is 1 / SK on every key
            if (mode == kTileDead) p = 0.f;
            if (!row_ok) p = kr + 8 * (e >> 1) < g.SK ? full_row_p(g, qr) : 0.f;
          }
          st[4 * j + e] = p;
        }
      wg_wait<0>();
      fence_regs(dpt);
      uint32_t pf[4][4], df[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float pv[4], dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * tq + (e & 1), qr = r0 + col;
          const float p = st[4 * j + e];
          float dpv = dpt[4 * j + e], pd = p;
          if (DROP) {  // dp masked and scaled; dV takes the dropped p
            const float dmk =
                keep(g, salt, qr, kr + 8 * (e >> 1)) ? g.dscale : 0.f;
            dpv *= dmk;
            pd = p * dmk;
          }
          pv[e] = pd;
          dsv[e] = p * (dpv - sl[BQ + col]) * g.scale;
          if constexpr (FULL) {
            // 0 where the row does not see the key (a fully masked row's p
            // is not)
            if (masked && !(qr >= qlo[e >> 1] && qr < qhi[e >> 1]))
              dsv[e] = 0.f;
          }
          if constexpr (DMW) {
            const int kc = kr + 8 * (e >> 1);
            if (qr < g.SQ && kc < g.SK)
              g.dm[(bh * g.SQ + qr) * g.SK + kc] = dsv[e] / g.scale;
          }
          if (KM) dm[e >> 1] += dsv[e];
        }
        pf[j >> 1][2 * (j & 1)] = pack<T>(pv[0], pv[1]);
        pf[j >> 1][2 * (j & 1) + 1] = pack<T>(pv[2], pv[3]);
        df[j >> 1][2 * (j & 1)] = pack<T>(dsv[0], dsv[1]);
        df[j >> 1][2 * (j & 1) + 1] = pack<T>(dsv[2], dsv[3]);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<DMAX, T>(acc_v, pf[kk], desc_mnmajor<BQ>(sdO, kk), 1);
        wgmma_rs<DMAX, T>(acc_k, df[kk], desc_mnmajor<BQ>(sQ, kk), 1);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(acc_v);
      fence_regs(acc_k);
      fence_regs(pf);
      fence_regs(df);
    };
    mbar_wait(full_kv, 0);
    if constexpr (TM) {  // the items as the producer announces them
      const int nqt = (g.SQ + BQ - 1) / BQ;
      const float kmv[2] = {0.f, 0.f};
      float dm[2];
      for (int i = 0;; ++i) {
        const int s = i % ST;
        mbar_wait(full + s, (i / ST) & 1);
        const int it = sitem[s];
        if (it < 0) break;
        const int flags = smode[2 * s + wq], mode = flags & 3;
        if (mode != kTileSkip) {
          const int gi = it / nqt, r0 = (it - gi * nqt) * BQ;
          const long long bh = (long long)b * g.H + hk * group + gi;
          const uint32_t salt = DROP ? head_salt(g, (int)bh) : 0u;
          const bool full_rows = flags & kTileFull;
          if (g.dm) {
            if (full_rows)
              item(Flag<true>(), Flag<true>(), s, r0, bh, salt, kmv, mode,
                   dm);
            else
              item(Flag<false>(), Flag<true>(), s, r0, bh, salt, kmv, mode,
                   dm);
          } else if (full_rows) {
            item(Flag<true>(), Flag<false>(), s, r0, bh, salt, kmv, mode,
                 dm);
          } else {
            item(Flag<false>(), Flag<false>(), s, r0, bh, salt, kmv, mode,
                 dm);
          }
        }
        mbar_arrive(empty + s);
      }
    } else {
      int i = 0;
      for (int gi = 0; gi < group; ++gi) {
        const int h = hk * group + gi;
        const long long bh = (long long)b * g.H + h;
        const int sk = head_skip(gi);
        float dm[2] = {0.f, 0.f};
        if (sk != 3) {
          const bool mine = !((sk >> wq) & 1);
          float kmv[2] = {0.f, 0.f};
          if (KM) {
            const float* kmr = km_row(g, b, h);
#pragma unroll
            for (int r = 0; r < 2; ++r)
              if (kr + 8 * r < g.SK) kmv[r] = kmr[kr + 8 * r];
          }
          const uint32_t salt = DROP ? head_salt(g, (int)bh) : 0u;
          for (int qt = qt0; qt < qt1; ++qt, ++i) {
            const int s = i % ST;
            mbar_wait(full + s, (i / ST) & 1);
            if (mine)
              item(Flag<false>(), Flag<false>(), s, qt * BQ, bh, salt, kmv,
                   kTileMixed, dm);
            mbar_arrive(empty + s);
          }
        }
        if (KM) {  // this query head's dmask row (zeros where skipped)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float x = dm[r];
            x += __shfl_xor_sync(0xffffffffu, x, 1);
            x += __shfl_xor_sync(0xffffffffu, x, 2);
            const int c = kr + 8 * r;
            if (tq == 0 && c < g.SK) g.dm[bh * g.SK + c] = x / g.scale;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int c = kr + 8 * r;
      if (c >= g.SK) continue;
      T* krow = dk + b * sdk_.b + (long long)c * sdk_.s + hk * sdk_.h;
      T* vrow = dv + b * sdv_.b + (long long)c * sdv_.s + hk * sdv_.h;
#pragma unroll
      for (int j = 0; j < DMAX / 8; ++j) {
        const int col = 8 * j + 2 * tq;
        if (col < g.d) {
          *reinterpret_cast<uint32_t*>(krow + col) =
              pack<T>(acc_k[4 * j + 2 * r], acc_k[4 * j + 2 * r + 1]);
          *reinterpret_cast<uint32_t*>(vrow + col) =
              pack<T>(acc_v[4 * j + 2 * r], acc_v[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// dQ tiles: 128 query rows a block (64 per consumer warpgroup), Q and dO
// resident, key tiles of 64 rows in a ring of STAGES (K and V). With a
// key row (KM) each stage also holds its key tile's row (fp32) and the
// tile's index; in the tile mode (TM) its [128, LDM] fp32 mask tile, the
// tile's index and the two warpgroups' modes, in a ring of 2 at d 128 so
// that the mask tiles fit (the plain layout is unchanged).
template <int DMAX, bool KM = false, bool TM = false>
struct DqCfg {
  static constexpr int BQ = 128, BK = 64, STAGES = TM && DMAX > 64 ? 2 : 3;
  // TM: the producer's class and copy loops need 40 registers
  static constexpr int REGS_PRODUCER = TM ? 40 : kRegsProducer;
  static constexpr int REGS_CONSUMER = TM ? 232 : kRegsConsumer;
  // the mask tile's row: 64 keys and 8 floats of padding, so that the
  // consumers' float2 reads in the accumulator's layout (a half-warp: 4
  // rows x 4 column pairs) fall in distinct banks
  static constexpr int LDM = BK + 8;
  static constexpr int Q_BYTES = BQ * DMAX * 2;   // Q, then dO
  static constexpr int KV_BYTES = BK * DMAX * 2;  // K or V of one stage
  static constexpr int OFF_DO = Q_BYTES;
  static constexpr int OFF_K = 2 * Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_DELTA = OFF_V + STAGES * KV_BYTES;  // [BQ] fp32
  static constexpr int OFF_BAR = OFF_DELTA + BQ * 4;
  // barriers: full_q, full_k[STAGES], full_v[STAGES], empty[STAGES]
  static constexpr int BAR_BYTES = 8 * (1 + 3 * STAGES);
  static constexpr int OFF_KM = (OFF_BAR + BAR_BYTES + 15) / 16 * 16;
  static constexpr int OFF_KT =
      OFF_KM + STAGES * (TM ? BQ * LDM : KM ? BK : 0) * 4;
  static constexpr int OFF_MODE = OFF_KT + STAGES * 4;
  static constexpr size_t SMEM = KM || TM ? OFF_MODE + 2 * STAGES + 1024
                                          : OFF_BAR + BAR_BYTES + 1024;
};

// dQ (kernel 2, and kernel 5: with KM and DROP). grid =
// grouped_blocks(B * H, ceil(SQ / 128)): one block per (query head, 128
// query rows), within each group of query heads the heaviest causal tiles
// (the last rows) first, while the group's K and V stay in L2 for its
// query tiles; key tiles run from the last to the first, so the tiles
// that need the causal, window or ragged mask come first and a
// block-uniform test skips the mask on the rest. Per key tile each
// consumer warpgroup computes S = Q.K^T and dP = dO.V^T for its 64 rows
// (wgmma from shared memory, two commit groups: p is computed while dP is
// in flight), ds = p (dp - delta) scale in registers, and dQ += dS.K
// (wgmma, dS from registers, rounded to bf16 once, K MN-major).
// FUSED: the block also computes delta = rowsum(dO * O) in fp32 for its
// rows, from the resident dO and O read once (loaded while Q and dO land,
// summed under the first key tile's products), and writes it to `delta`
// ([B * H, SQ]) for the dK/dV kernel that runs after it; otherwise it
// reads `delta`. KM: the key row (copied beside K, scaled to log2 units
// as it is read) is added to the scaled scores, and the 64-key tiles that
// are wholly padding are neither loaded nor visited (key_tile_producer,
// which also announces the tiles, first to last without causal masking):
// their p, and so their ds, is exactly 0. DROP: dp is masked by the
// counter hash and scaled by dscale before ds (p itself is not dropped in
// dQ). At d 128 with a key row, and in the tile mode, FUSED sums delta
// before the key loop (see kEarly). TM (the tile mode): the
// producer announces the key tiles of the causal band and each warpgroup's
// mode for them (tile_row_producer): a skipped cell's ds is exactly 0, a
// ZERO cell's scores add nothing, a MIXED cell's add the mask values that
// the producer staged in shared memory, read here in the accumulator's
// layout, and a DEAD cell is visited only for a fully masked row (lse <=
// -0.5e30), whose p is full_row_p on every key (0 for the other rows);
// ds is 0 where the row does not see the key.
template <int DMAX, bool FUSED, bool KM, bool DROP, typename T = bf16,
          bool TM = false>
__global__ void __launch_bounds__(kThreadsWs, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const T* __restrict__ out,
                   const float* __restrict__ lse, float* __restrict__ delta,
                   T* __restrict__ dq, Geom g, Strides so_,
                   Strides sdq_) {
  using C = DqCfg<DMAX, KM, TM>;
  constexpr int BQ = C::BQ, BK = C::BK, ST = C::STAGES;
  static_assert(!(KM && TM), "a key row or a tile mask, not both");
  static_assert(BK == kCell, "a key tile is one cell's keys");
  char* sm = aligned_smem();
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* full_q = bars;
  uint64_t* full_k = bars + 1;
  uint64_t* full_v = bars + 1 + ST;
  uint64_t* empty = bars + 1 + 2 * ST;
  const int nqt = (g.SQ + BQ - 1) / BQ;
  int bh, qi;
  grouped_block(nqt, &bh, &qi);
  if (bh >= g.B * g.H) return;
  const int b = bh / g.H, h = bh - b * g.H;
  const int hk = h / (g.H / g.HKV);
  const int r0 = (nqt - 1 - qi) * BQ;
  int kt0, kt1;
  key_tiles<BQ, BK>(g, r0, &kt0, &kt1);
  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < ST; ++s) {
      // KM, TM: and the producer warp's 32 lanes, once their copies of the
      // tile's key row or mask land
      mbar_init(full_k + s, KM || TM ? 33 : 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();
  int* skt = reinterpret_cast<int*>(sm + C::OFF_KT);  // KM, TM: tile indices
  uint8_t* smode = reinterpret_cast<uint8_t*>(sm + C::OFF_MODE);  // TM
  auto load_kv = [&](int s, int kt) {
    mbar_expect_tx(full_k + s, C::KV_BYTES);
    load_tile<BK, DMAX>(sm + C::OFF_K + s * C::KV_BYTES, &tm_k, full_k + s,
                        hk, kt * BK, b);
    mbar_expect_tx(full_v + s, C::KV_BYTES);
    load_tile<BK, DMAX>(sm + C::OFF_V + s * C::KV_BYTES, &tm_v, full_v + s,
                        hk, kt * BK, b);
  };

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup
    regs_dec<C::REGS_PRODUCER>();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(full_q, 2 * C::Q_BYTES);
      load_tile<BQ, DMAX>(sm, &tm_q, full_q, h, r0, b);
      load_tile<BQ, DMAX>(sm + C::OFF_DO, &tm_do, full_q, h, r0, b);
    }
    if constexpr (KM) {  // its first warp
      if (threadIdx.x < kConsumers + 32)
        key_tile_producer<BK, ST>(
            g, km_row(g, b, h), kt0, kt1,
            reinterpret_cast<float*>(sm + C::OFF_KM), skt, full_k, empty,
            load_kv);
    } else if constexpr (TM) {  // its first warp
      if (threadIdx.x < kConsumers + 32) {
        // bit w: warpgroup w's rows hold a fully masked row (full_row)
        const float* lse_bh = lse + (long long)bh * g.SQ;
        const int lane = threadIdx.x & 31;
        auto full_rows = [&]() {
          float l[4];  // rows r0 + 32 j + lane
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int row = r0 + 32 * j + lane;
            l[j] = row < g.SQ ? lse_bh[row] : 0.f;
          }
          int fr = 0;
#pragma unroll
          for (int w = 0; w < 2; ++w)
            fr |= __any_sync(0xffffffffu,
                             full_row(g, l[2 * w], r0 + 64 * w + lane) |
                                 full_row(g, l[2 * w + 1],
                                          r0 + 64 * w + 32 + lane))
                  << w;
          return fr;
        };
        tile_row_producer<ST, C::LDM, false>(
            g, b, h, r0, kt0, kt1, full_rows,
            reinterpret_cast<float*>(sm + C::OFF_KM), skt, smode, full_k,
            empty, load_kv, 0);
      }
    } else if (threadIdx.x == kConsumers) {
      for (int i = 0, kt = kt1 - 1; kt >= kt0; --kt, ++i) {
        const int s = i % ST;
        mbar_wait(empty + s, ((i / ST) & 1) ^ 1);
        load_kv(s, kt);
      }
    }
  } else {  // the consumer warpgroups
    regs_inc<C::REGS_CONSUMER>();
    // warpgroup wq owns tile rows 64 wq .. 64 wq + 63; this thread rows
    // rw and rw + 8 of them
    const int wq = threadIdx.x >> 7;
    const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
    const int rw = 64 * wq + 16 * ((threadIdx.x >> 5) & 3) + gq;
    const float sl2 = g.scale * kLog2e;  // scores in the log2 domain
    const int offset = g.SK - g.SQ;
    const int rmax = min(r0 + BQ, g.SQ) - 1;
    const long long rows = (long long)bh * g.SQ;
    // the keys row r0 + rw + 8 r sees: [lo[r], hi[r]) (bottom-right
    // causal diagonal, window); its lse in the log2 domain, +inf for rows
    // that saw no key in the forward (lse ~ -1e30) and rows past SQ, so
    // that their p = ex2(-inf) is exactly 0
    int lo[2], hi[2];
    float lse2[2], dl[2];
    uint32_t hrow[2];  // DROP: the hash's row terms, salt included
    bool full[2];      // TM: the row is fully masked (or past SQ)
    float fp[2];       // TM: its p (full_row_p)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + rw + 8 * r, diag = row + offset;
      lo[r] = g.causal && g.window > 0 ? diag - g.window + 1 : INT_MIN;
      hi[r] = g.causal ? diag + 1 : INT_MAX;
      const float l = row < g.SQ ? lse[rows + row] : kNegInf;
      lse2[r] = l > 0.5f * kNegInf ? l * kLog2e : INFINITY;
      full[r] = !(l > 0.5f * kNegInf);
      fp[r] = full_row_p(g, row);
      dl[r] = !FUSED && row < g.SQ ? delta[rows + row] : 0.f;
      if constexpr (DROP)
        hrow[r] = (uint32_t)row * kRowMul + head_salt(g, bh);
    }
    // FUSED: delta of this warpgroup's 64 rows. Thread t sums half of
    // row 64 wq + t / 2: its O from device memory, loaded here while Q
    // and dO land, and its dO from the resident tile (16-byte chunk c of
    // a 128-byte line of box col / 64 lies at chunk c ^ (line % 8), the
    // 128-byte swizzle). The sum runs once the first key tile's products
    // are issued, under them (after the loop if the rows see no key); at
    // d 128 with a key row before the loop, since O's registers beside the
    // first tile's spill there, and in the tile mode before the loop too:
    // a sum inside the branch on the stage's mode (a skipped first tile)
    // makes ptxas serialize the wgmma instructions after it.
    constexpr bool kEarly = FUSED && ((KM && DMAX > 64) || TM);
    const int t = threadIdx.x & 127, rr = 64 * wq + (t >> 1);
    uint4 ov[DMAX / 16];
    if (FUSED) {
#pragma unroll
      for (int c = 0; c < DMAX / 16; ++c) {
        const int col = (t & 1) * (DMAX / 2) + 8 * c;
        ov[c] = r0 + rr < g.SQ && col < g.d
                    ? *reinterpret_cast<const uint4*>(
                          out + b * so_.b + (long long)(r0 + rr) * so_.s +
                          h * so_.h + col)
                    : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    auto sum_delta = [&]() {
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < DMAX / 16; ++c) {
        const int col = (t & 1) * (DMAX / 2) + 8 * c;
        const uint4 dv = *reinterpret_cast<const uint4*>(
            sm + C::OFF_DO + (col >> 6) * BQ * 128 + rr * 128 +
            ((((col & 63) >> 3) ^ (rr & 7)) << 4));
        const T* de = reinterpret_cast<const T*>(&dv);
        const T* oe = reinterpret_cast<const T*>(&ov[c]);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          sum = fmaf(to_f32(de[e]), to_f32(oe[e]), sum);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      float* sdelta = reinterpret_cast<float*>(sm + C::OFF_DELTA);
      if (!(t & 1)) {
        sdelta[rr] = sum;
        if (r0 + rr < g.SQ) delta[rows + r0 + rr] = sum;
      }
      bar_sync(1 + wq, 128);
      dl[0] = sdelta[rw];
      dl[1] = sdelta[rw + 8];
    };
    mbar_wait(full_q, 0);
    if (kEarly) sum_delta();
    float acc[DMAX / 2];
#pragma unroll
    for (int j = 0; j < DMAX / 2; ++j) acc[j] = 0.f;
    constexpr bool kAnnounced = KM || TM;  // the producer names the tiles
    int visited = 0;  // KM, TM: the tiles announced
    // the key tiles from the last to the first; KM, TM: as the producer
    // announces them
    for (int i = 0, kt = kt1 - 1; kAnnounced || kt >= kt0; --kt, ++i) {
      const int s = i % ST;
      const uint32_t ph = (i / ST) & 1;
      if constexpr (kAnnounced) {
        mbar_wait(full_k + s, ph);
        kt = skt[s];
        if (kt < 0) break;
        visited = i + 1;
      }
      const int flags = TM ? smode[2 * s + wq] : kTileMixed;
      const int mode = flags & 3;
      if (TM && mode == kTileSkip) {  // this warpgroup's ds is 0 here
        mbar_arrive(empty + s);
        continue;
      }
      const int c0 = kt * BK;
      const char* sK = sm + C::OFF_K + s * C::KV_BYTES;
      const char* sV = sm + C::OFF_V + s * C::KV_BYTES;
      // KM: the tile's key row from this thread's first column, 2 tq; TM:
      // the stage's mask tile from this thread's row rw and column 2 tq
      const float* skm =
          reinterpret_cast<const float*>(sm + C::OFF_KM) +
          (TM ? s * BQ * C::LDM + rw * C::LDM : s * BK) + 2 * tq;
      float sc[BK / 2], dp[BK / 2];
      mbar_wait(full_k + s, ph);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < DMAX / 16; ++ks)
        wgmma_ss<BK, T>(sc, desc_kmajor<BQ>(sm, 64 * wq, ks),
                     desc_kmajor<BK>(sK, 0, ks), ks);
      wg_commit();
      mbar_wait(full_v + s, ph);
#pragma unroll
      for (int ks = 0; ks < DMAX / 16; ++ks)
        wgmma_ss<BK, T>(dp, desc_kmajor<BQ>(sm + C::OFF_DO, 64 * wq, ks),
                     desc_kmajor<BK>(sV, 0, ks), ks);
      wg_commit();
      if (FUSED && !kEarly && i == 0) sum_delta();
      // a mask is needed where the tile crosses the causal diagonal, the
      // window's lower edge or the last key
      const bool masked =
          c0 + BK > g.SK ||
          (g.causal && (c0 + BK - 1 > r0 + offset ||
                        (g.window > 0 && c0 <= rmax + offset - g.window)));
      // p into sc while dP is in flight; masked keys and keys past SK
      // weigh exactly 0
      wg_wait<1>();
      fence_regs(sc);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        float2 kv = make_float2(0.f, 0.f), mv[2] = {kv, kv};
        if constexpr (KM) kv = *reinterpret_cast<const float2*>(skm + 8 * j);
        if (TM && mode == kTileMixed) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
            mv[r] = *reinterpret_cast<const float2*>(skm + 8 * r * C::LDM +
                                                     8 * j);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + 8 * j + 2 * tq + (e & 1), r = e >> 1;
          float p;
          if constexpr (TM) {  // a fully masked row's p: below
            p = ex2(fmaf(sc[4 * j + e], sl2,
                         (e & 1 ? mv[r].y : mv[r].x) * kLog2e - lse2[r]));
          } else {
            p = KM ? ex2(fmaf(sc[4 * j + e], sl2,
                              (e & 1 ? kv.y : kv.x) * kLog2e - lse2[r]))
                   : ex2(fmaf(sc[4 * j + e], sl2, -lse2[r]));
          }
          if (masked && (c < lo[r] || c >= hi[r] || c >= g.SK)) p = 0.f;
          sc[4 * j + e] = p;
        }
      }
      // TM, only where the warpgroup's rows hold a fully masked row (so
      // the other tiles keep the plain arithmetic): such a row's p is
      // full_row_p on every key, and the other rows' is 0 on a DEAD cell
      const bool has_full = TM && (flags & kTileFull);
      if (has_full) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = c0 + 8 * j + 2 * tq + (e & 1), r = e >> 1;
            if (mode == kTileDead) sc[4 * j + e] = 0.f;
            if (full[r]) sc[4 * j + e] = c < g.SK ? fp[r] : 0.f;
          }
      }
      wg_wait<0>();
      fence_regs(dp);
      // dS rounded to bf16 once as the A operand of dS.K
      const uint32_t hcol = DROP ? (uint32_t)(c0 + 2 * tq) * kColMul : 0u;
      uint32_t da[BK / 16][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float dpv = dp[4 * j + e];
          if constexpr (DROP)  // dp masked and scaled before ds
            dpv = keep_sum(hrow[e >> 1] + hcol +
                               (uint32_t)(8 * j + (e & 1)) * kColMul,
                           g.thresh)
                      ? dpv * g.dscale
                      : 0.f;
          ds[e] = sc[4 * j + e] * (dpv - dl[e >> 1]) * g.scale;
          if (has_full && masked) {  // 0 where the row does not see the key
            const int c = c0 + 8 * j + 2 * tq + (e & 1);
            if (c < lo[e >> 1] || c >= hi[e >> 1]) ds[e] = 0.f;
          }
        }
        da[j >> 1][2 * (j & 1)] = pack<T>(ds[0], ds[1]);
        da[j >> 1][2 * (j & 1) + 1] = pack<T>(ds[2], ds[3]);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<DMAX, T>(acc, da[kk], desc_mnmajor<BK>(sK, kk), 1);
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
      fence_regs(da);
      mbar_arrive(empty + s);
    }
    if (FUSED && !kEarly && (kAnnounced ? visited == 0 : kt1 <= kt0))
      sum_delta();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + rw + 8 * r;
      if (row >= g.SQ) continue;
      T* qrow = dq + b * sdq_.b + (long long)row * sdq_.s + h * sdq_.h;
#pragma unroll
      for (int j = 0; j < DMAX / 8; ++j) {
        const int col = 8 * j + 2 * tq;
        if (col < g.d)
          *reinterpret_cast<uint32_t*>(qrow + col) =
              pack<T>(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

}  // namespace wg

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

template <typename T, int DMAX, int BQ, int BK, bool KM, bool DROP,
          bool TM = false>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, const Geom& g, const long long* st,
                cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, DMAX, BQ, BK, KM, DROP, TM>;
  const size_t smem = Cfg<T, DMAX, BQ, BK>::fwd;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((g.SQ + BQ - 1) / BQ, g.B * g.H), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, g,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3));
  return cudaGetLastError();
}

template <typename T, int DMAX, int BQ, int BK, bool KM, bool DROP,
          bool TM = false>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, const Geom& g, const long long* st,
                   cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T, DMAX, BQ, BK, KM, DROP, TM>;
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

// dK/dV grid: one block per (key tile, kv head).
dim3 dkv_grid(const Geom& g, int bk) {
  return dim3((g.SK + bk - 1) / bk, g.B * g.HKV);
}

// The head-batched dmask: out[b, c] = sum over h of per_head[b * H + h, c],
// in head order (deterministic, no atomics). grid = (ceil(SK / 256), B).
__global__ void __launch_bounds__(256)
dmask_head_sum(const float* __restrict__ per_head, float* __restrict__ out,
               int H, int SK) {
  const int c = blockIdx.x * 256 + threadIdx.x;
  if (c >= SK) return;
  const float* src = per_head + (long long)blockIdx.y * H * SK + c;
  float sum = 0.f;
  for (int h = 0; h < H; ++h) sum += src[(long long)h * SK];
  out[(long long)blockIdx.y * SK + c] = sum;
}

template <typename T, int DMAX, int BQ, int BK, bool KM, bool DROP,
          bool TM = false>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, const Geom& g, const long long* st,
                    cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<T, DMAX, BQ, BK, KM, DROP, TM>;
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

// cuTensorMapEncodeTiled, a driver-API function, taken from the driver
// library that the process already has loaded (no link against libcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? (EncodeTiledFn)dlsym(lib, "cuTensorMapEncodeTiled")
               : (EncodeTiledFn) nullptr;
  }();
  return fn;
}

// Returned for a tensor map that cannot be encoded, plus its CUresult.
constexpr int kTensorMapError = 1000;

// A bf16 or fp16 (T) [B, S, heads, d] tensor read through its (batch,
// seq, head) strides as the 4-D map (d, heads, S, B) with boxes of (64,
// 1, rows, 1) and the 128-byte swizzle; reads past an edge return zeros.
template <typename T>
constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
template <>
constexpr CUtensorMapDataType kMapType<__half> =
    CU_TENSOR_MAP_DATA_TYPE_FLOAT16;

template <typename T>
int tile_map(CUtensorMap* map, const void* base, int B, int S, int heads,
             int d, Strides st, int rows) {
  const EncodeTiledFn enc = encode_tiled();
  if (!enc) return kTensorMapError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t bytes[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2,
                               (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  auto encode = [&] {
    return enc(map, kMapType<T>, 4, const_cast<void*>(base), dims, bytes,
               box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  };
  CUresult r = encode();
  if (r == CUDA_ERROR_INVALID_CONTEXT) {
    // a thread with no current context (PyTorch's autograd device thread,
    // when a flash backward is its first CUDA work) cannot use the
    // driver's encoder: cudaSetDevice makes the tensor's device's primary
    // context current on this thread (CUDA 12), then encode again
    cudaPointerAttributes a;
    int dev = -1;
    if (cudaPointerGetAttributes(&a, base) == cudaSuccess) dev = a.device;
    if (dev < 0) cudaGetDevice(&dev);
    if (dev >= 0 && cudaSetDevice(dev) == cudaSuccess) r = encode();
  }
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + (int)r;
}

template <int DMAX, bool KM, bool DROP, typename T = wg::bf16>
cudaError_t fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                      void* lse, const Geom& g, const long long* st,
                      cudaStream_t stream) {
  using C = wg::FwdCfg<DMAX, KM>;
  CUtensorMap tq, tk, tv;
  int err = tile_map<T>(&tq, q, g.B, g.SQ, g.H, g.d, strides_at(st, 0), C::BQ);
  if (!err)
    err = tile_map<T>(&tk, k, g.B, g.SK, g.HKV, g.d, strides_at(st, 1), C::BK);
  if (!err)
    err = tile_map<T>(&tv, v, g.B, g.SK, g.HKV, g.d, strides_at(st, 2), C::BK);
  if (err) return (cudaError_t)err;
  auto kernel = wg::flash_fwd_wgmma<DMAX, KM, DROP, T>;
  cudaError_t e = prepare(kernel, C::SMEM);
  if (e != cudaSuccess) return e;
  kernel<<<g.B * g.H * ((g.SQ + C::BQ - 1) / C::BQ),
           KM || DROP ? wg::kThreadsWs : wg::kThreadsWg, C::SMEM,
           stream>>>(
      tq, tk, tv, (T*)o, (float*)lse, g, strides_at(st, 3));
  return cudaGetLastError();
}

// The tile mode's forward: g.blocks blocks (0: one an SM), each walking
// its share of the items.
template <typename T, int DMAX, bool DROP>
cudaError_t fwd_tile_wgmma(const void* q, const void* k, const void* v,
                           void* o, void* lse, const Geom& g,
                           const long long* st, cudaStream_t stream) {
  using C = wg::FwdTileCfg<DMAX>;
  CUtensorMap tq, tk, tv;
  int err = tile_map<T>(&tq, q, g.B, g.SQ, g.H, g.d, strides_at(st, 0), C::BQ);
  if (!err)
    err = tile_map<T>(&tk, k, g.B, g.SK, g.HKV, g.d, strides_at(st, 1), C::BK);
  if (!err)
    err = tile_map<T>(&tv, v, g.B, g.SK, g.HKV, g.d, strides_at(st, 2), C::BK);
  if (err) return (cudaError_t)err;
  auto kernel = wg::flash_fwd_tile_wgmma<DMAX, DROP, T>;
  cudaError_t e = prepare(kernel, C::SMEM);
  if (e != cudaSuccess) return e;
  int blocks = g.blocks;
  if (blocks <= 0) {
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&blocks, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  const int items = g.B * g.H * ((g.SQ + C::BQ - 1) / C::BQ);
  kernel<<<blocks < items ? blocks : items, wg::kThreadsWs, C::SMEM,
           stream>>>(
      tq, tk, tv, (T*)o, (float*)lse, g, strides_at(st, 3));
  return cudaGetLastError();
}

// The forward (kernels 1 and 4, every variant) runs the wgmma kernel, and
// the tile mode its own.
template <typename T, int DMAX, bool KM, bool DROP, bool TM = false>
cudaError_t fwd_tc(const void* q, const void* k, const void* v, void* o,
                   void* lse, const Geom& g, const long long* st,
                   cudaStream_t stream) {
  if constexpr (TM)
    return fwd_tile_wgmma<T, DMAX, DROP>(q, k, v, o, lse, g, st, stream);
  else
    return fwd_wgmma<DMAX, KM, DROP, T>(q, k, v, o, lse, g, st, stream);
}

// dQ on wgmma: FUSED computes delta from O (strides so_) and writes it;
// otherwise delta is read. st: the strides of q, k, v, dout.
template <int DMAX, bool FUSED, bool KM, bool DROP, typename T = wg::bf16,
          bool TM = false>
cudaError_t bwd_dq_wgmma(const void* q, const void* k, const void* v,
                         const void* dout, const void* out, const void* lse,
                         void* delta, void* dq, const Geom& g,
                         const long long* st, Strides so_, Strides sdq_,
                         cudaStream_t stream) {
  using C = wg::DqCfg<DMAX, KM, TM>;
  CUtensorMap tq, tk, tv, tdo;
  int err = tile_map<T>(&tq, q, g.B, g.SQ, g.H, g.d, strides_at(st, 0), C::BQ);
  if (!err)
    err = tile_map<T>(&tk, k, g.B, g.SK, g.HKV, g.d, strides_at(st, 1), C::BK);
  if (!err)
    err = tile_map<T>(&tv, v, g.B, g.SK, g.HKV, g.d, strides_at(st, 2), C::BK);
  if (!err)
    err = tile_map<T>(&tdo, dout, g.B, g.SQ, g.H, g.d, strides_at(st, 3),
                   C::BQ);
  if (err) return (cudaError_t)err;
  auto kernel = wg::flash_bwd_dq_wgmma<DMAX, FUSED, KM, DROP, T, TM>;
  cudaError_t e = prepare(kernel, C::SMEM);
  if (e != cudaSuccess) return e;
  const int grid =
      wg::grouped_blocks(g.B * g.H, (g.SQ + C::BQ - 1) / C::BQ);
  kernel<<<grid, wg::kThreadsWs, C::SMEM, stream>>>(
      tq, tk, tv, tdo, (const T*)out, (const float*)lse,
      (float*)delta, (T*)dq, g, so_, sdq_);
  return cudaGetLastError();
}

// dQ given delta (kernels 2 and 5, every variant and the tile mode) runs
// the wgmma kernel.
template <typename T, int DMAX, bool KM, bool DROP, bool TM = false>
cudaError_t bwd_dq_tc(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, const Geom& g, const long long* st,
                      cudaStream_t stream) {
  return bwd_dq_wgmma<DMAX, false, KM, DROP, T, TM>(
      q, k, v, dout, nullptr, lse, const_cast<void*>(delta), dq, g, st,
      Strides{}, strides_at(st, 4), stream);
}

template <int DMAX, bool KM, bool DROP, typename T = wg::bf16,
          bool TM = false>
cudaError_t bwd_dkv_wgmma(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv,
                          const Geom& g, const long long* st,
                          cudaStream_t stream) {
  using C = wg::DkvCfg<DMAX, TM>;
  CUtensorMap tq, tk, tv, tdo;
  int err = tile_map<T>(&tq, q, g.B, g.SQ, g.H, g.d, strides_at(st, 0), C::BQ);
  if (!err)
    err = tile_map<T>(&tk, k, g.B, g.SK, g.HKV, g.d, strides_at(st, 1), C::BK);
  if (!err)
    err = tile_map<T>(&tv, v, g.B, g.SK, g.HKV, g.d, strides_at(st, 2), C::BK);
  if (!err)
    err = tile_map<T>(&tdo, dout, g.B, g.SQ, g.H, g.d, strides_at(st, 3),
                   C::BQ);
  if (err) return (cudaError_t)err;
  auto kernel = wg::flash_bwd_dkv_wgmma<DMAX, KM, DROP, T, TM>;
  cudaError_t e = prepare(kernel, C::SMEM);
  if (e != cudaSuccess) return e;
  const int grid =
      wg::grouped_blocks(g.B * g.HKV, (g.SK + C::BK - 1) / C::BK);
  kernel<<<grid, wg::kThreadsWs, C::SMEM, stream>>>(
      tq, tk, tv, tdo, (const float*)lse, (const float*)delta,
      (T*)dk, (T*)dv, g, strides_at(st, 4), strides_at(st, 5));
  return cudaGetLastError();
}

// d <= 64 (kernel 6, and kernel 3 at d <= 64), d <= 128 without key row
// or dropout (kernel 3 on the Llama path) and the tile mode at every d <=
// 128 run the wgmma kernel; the key-row and dropout variants at 64 < d <=
// 128 the mma.sync template.
template <typename T, int DMAX, bool KM, bool DROP, bool TM = false>
cudaError_t bwd_dkv_tc(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, const Geom& g, const long long* st,
                       cudaStream_t stream) {
  if constexpr (TM || DMAX == 64 || (!KM && !DROP)) {
    return bwd_dkv_wgmma<DMAX, KM, DROP, T, TM>(
        q, k, v, dout, lse, delta, dk, dv, g, st, stream);
  } else {
    auto kernel = tc::flash_bwd_dkv_tc<DMAX, KM, DROP, T>;
    const size_t smem = tc::Smem<DMAX>::dkv;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dkv_grid(g, 64), tc::kThreadsTc, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
        (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, g,
        strides_at(st, 0),
        strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
        strides_at(st, 4), strides_at(st, 5));
    return cudaGetLastError();
  }
}

// geom = {B, H, HKV, SQ, SK, d, causal, window}; km: the additive key
// rows (or null), one per query head (hb = 0) or per batch row (hb = 1);
// dm: their gradient (dK/dV entries, with km); drop: {seed0, seed1,
// threshold, global heads, first batch row, first head} (or null: no
// dropout), dscale = 1 / (1 - rate).
Geom make_geom(const int* geom, float scale, const void* km, void* dm,
               const unsigned* drop, float dscale, int hb) {
  Geom g{geom[0], geom[1], geom[2], geom[3], geom[4],
         geom[5], geom[6], geom[7], scale};
  g.km = (const float*)km;
  g.dm = (float*)dm;
  g.km_b = hb ? g.SK : (long long)g.H * g.SK;
  g.km_h = hb ? 0 : g.SK;
  g.km_q = 0;
  g.tcls = g.tfull = nullptr;
  g.tc_b = g.tc_h = g.tf_b = g.tf_h = 0;
  g.seed0 = drop ? drop[0] : 0u;
  g.seed1 = drop ? drop[1] : 0u;
  g.thresh = drop ? drop[2] : 0u;
  g.hg = drop ? drop[3] : (uint32_t)g.H;
  g.b0 = drop ? drop[4] : 0u;
  g.h0 = drop ? drop[5] : 0u;
  g.dscale = dscale;
  g.blocks = 0;
  return g;
}

// dtype codes shared with ops/cuda/flash_attention.py
enum { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };

// The 16-bit element type of this library. flash_attention.cu builds the
// bf16 and fp32 kernels; flash_attention_fp16.cu is this source with
// PT_FLASH_FP16 defined, and builds the same templates at __half (no fp32)
// into a library of its own, which nvcc compiles beside this one. Each
// library refuses the other's dtypes.
#ifdef PT_FLASH_FP16
typedef __half Low;
constexpr int kLowCode = kFloat16;
#else
typedef __nv_bfloat16 Low;
constexpr int kLowCode = kBFloat16;
#endif

// The 16-bit type with d <= 128 takes the tensor-core kernels, with d >
// 128 the fp32-FMA kernels; fp32 (any d) the fp32-FMA kernels, with 64 x
// 64 tiles up to DMAX 128 and 32 x 32 at DMAX 256 so that fp32 backward
// tiles fit in shared memory.
#ifdef PT_FLASH_FP16
#define PT_FLASH_F32(FN, KM, DROP, ...)
#else
#define PT_FLASH_F32(FN, KM, DROP, ...)                                 \
  if (dtype == kFloat32) {                                              \
    if (g.d <= 64) return FN<float, 64, 64, 64, KM, DROP>(__VA_ARGS__); \
    if (g.d <= 128) return FN<float, 128, 64, 64, KM, DROP>(__VA_ARGS__); \
    return FN<float, 256, 32, 32, KM, DROP>(__VA_ARGS__);                \
  }
#endif
#define PT_FLASH_FAMILY(FN, KM, DROP, ...)                              \
  do {                                                                  \
    if (dtype == kLowCode) {                                            \
      if (g.d <= 64) return FN##_tc<Low, 64, KM, DROP>(__VA_ARGS__);    \
      if (g.d <= 128) return FN##_tc<Low, 128, KM, DROP>(__VA_ARGS__);  \
      return FN<Low, 256, 32, 32, KM, DROP>(__VA_ARGS__);               \
    }                                                                   \
    PT_FLASH_F32(FN, KM, DROP, __VA_ARGS__)                             \
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

#if PT_IN_PART(0)
int fwd_entry(const void* q, const void* k, const void* v, void* o,
              void* lse, const void* km, const int* geom, float scale,
              const long long* strides, const unsigned* drop, float dscale,
              int dtype, void* stream, int hb) {
  const Geom g = make_geom(geom, scale, km, nullptr, drop, dscale, hb);
  PT_FLASH_DISPATCH(fwd, q, k, v, o, lse, g, strides, (cudaStream_t)stream);
}
#endif

#if PT_IN_PART(1)
int bwd_dq_entry(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, const void* km, const int* geom, float scale,
                 const long long* strides, const unsigned* drop, float dscale,
                 int dtype, void* stream, int hb) {
  const Geom g = make_geom(geom, scale, km, nullptr, drop, dscale, hb);
  PT_FLASH_DISPATCH(bwd_dq, q, k, v, dout, lse, delta, dq, g, strides,
                    (cudaStream_t)stream);
}
#endif

#if PT_IN_PART(2)
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
#endif

// The tile mode (TM): the 16-bit type with d <= 128 on the wgmma kernels
// (the backward ones reading the class table), fp32 (any d) and the 16-bit
// type with d > 128 on the fp32-FMA kernels, which visit every tile; no
// window.
#ifdef PT_FLASH_FP16
#define PT_TILE_F32(FN, DROP, ...)
#else
#define PT_TILE_F32(FN, DROP, ...)                                         \
  if (dtype == kFloat32) {                                                 \
    if (g.d <= 64)                                                         \
      return FN<float, 64, 64, 64, false, DROP, true>(__VA_ARGS__);         \
    if (g.d <= 128)                                                        \
      return FN<float, 128, 64, 64, false, DROP, true>(__VA_ARGS__);        \
    return FN<float, 256, 32, 32, false, DROP, true>(__VA_ARGS__);          \
  }
#endif
#define PT_TILE_FAMILY(FN, DROP, ...)                                        \
  do {                                                                     \
    if (dtype == kLowCode) {                                               \
      if (g.d <= 64)                                                       \
        return FN##_tc<Low, 64, false, DROP, true>(__VA_ARGS__);            \
      if (g.d <= 128)                                                      \
        return FN##_tc<Low, 128, false, DROP, true>(__VA_ARGS__);           \
      return FN<Low, 256, 32, 32, false, DROP, true>(__VA_ARGS__);          \
    }                                                                      \
    PT_TILE_F32(FN, DROP, __VA_ARGS__)                                     \
    return cudaErrorInvalidValue;                                          \
  } while (0)

#define PT_TILE_DISPATCH(FN, ...)                                         \
  do {                                                                    \
    if (g.d % 8 || g.d > 256 || g.H % g.HKV || g.window || !g.km)         \
      return cudaErrorInvalidValue;                                       \
    if (drop) PT_TILE_FAMILY(FN, true, __VA_ARGS__);                      \
    PT_TILE_FAMILY(FN, false, __VA_ARGS__);                               \
  } while (0)

// kms: the tile mode mask's batch, head and query-row strides (elements,
// 0 over a broadcast dim; its key stride is 1), the class table's batch
// and head strides (0 over a broadcast dim), then the forward's block
// count (0: one an SM); tcls, tfull: the class table and the full-row
// flags (the wgmma kernels; the flags, one a cell row, the forward's).
Geom tile_geom(const int* geom, float scale, const void* km,
               const long long* kms, const void* tcls, const void* tfull,
               void* dm, const unsigned* drop, float dscale) {
  Geom g = make_geom(geom, scale, km, dm, drop, dscale, 0);
  g.km_b = kms[0];
  g.km_h = kms[1];
  g.km_q = kms[2];
  g.tcls = (const uint8_t*)tcls;
  g.tfull = (const uint8_t*)tfull;
  g.tc_b = kms[3];
  g.tc_h = kms[4];
  // the flags' strides: the table's, one byte a cell row
  const int nct = (g.SK + kCell - 1) / kCell;
  g.tf_b = g.tc_b / nct;
  g.tf_h = g.tc_h / nct;
  g.blocks = (int)kms[5];
  return g;
}

// dQ that also computes delta (the 16-bit type, d <= 128, every variant):
// strides of q, k, v, dout, out, dq.
#if PT_IN_PART(1)
int bwd_dq_delta_entry(const void* q, const void* k, const void* v,
                       const void* dout, const void* out, const void* lse,
                       void* delta, void* dq, const void* km,
                       const int* geom, float scale, const long long* strides,
                       const unsigned* drop, float dscale, int dtype,
                       void* stream, int hb) {
  const Geom g = make_geom(geom, scale, km, nullptr, drop, dscale, hb);
  const Strides so_ = strides_at(strides, 4), sdq_ = strides_at(strides, 5);
  if (dtype != kLowCode || g.d % 8 || g.d > 128 || g.H % g.HKV)
    return cudaErrorInvalidValue;
#define PT_DQ_DELTA(KM, DROP)                                              \
  return g.d <= 64 ? bwd_dq_wgmma<64, true, KM, DROP, Low>(                \
                         q, k, v, dout, out, lse, delta, dq, g, strides,   \
                         so_, sdq_, (cudaStream_t)stream)                  \
                   : bwd_dq_wgmma<128, true, KM, DROP, Low>(               \
                         q, k, v, dout, out, lse, delta, dq, g, strides,   \
                         so_, sdq_, (cudaStream_t)stream)
  if (km && drop) PT_DQ_DELTA(true, true);
  if (km) PT_DQ_DELTA(true, false);
  if (drop) PT_DQ_DELTA(false, true);
  PT_DQ_DELTA(false, false);
#undef PT_DQ_DELTA
}
#endif

// The wgmma kernels (the 16-bit type, d <= 128) read the class table, the
// forward also the full-row flags.
bool wgmma_classes_given(const Geom& g, int dtype, bool flags) {
  return dtype != kLowCode || g.d > 128 || (g.tcls && (g.tfull || !flags));
}

#if PT_IN_PART(0)
int tile_fwd_entry(const void* q, const void* k, const void* v, void* o,
                   void* lse, const void* km, const void* tcls,
                   const void* tfull, const long long* kms, const int* geom,
                   float scale, const long long* strides,
                   const unsigned* drop, float dscale, int dtype,
                   void* stream) {
  const Geom g =
      tile_geom(geom, scale, km, kms, tcls, tfull, nullptr, drop, dscale);
  if (!wgmma_classes_given(g, dtype, true)) return cudaErrorInvalidValue;
  PT_TILE_DISPATCH(fwd, q, k, v, o, lse, g, strides, (cudaStream_t)stream);
}
#endif

#if PT_IN_PART(1)
int tile_bwd_dq_entry(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, const void* km, const void* tcls,
                      const long long* kms, const int* geom, float scale,
                      const long long* strides, const unsigned* drop,
                      float dscale, int dtype, void* stream) {
  const Geom g =
      tile_geom(geom, scale, km, kms, tcls, nullptr, nullptr, drop, dscale);
  if (!wgmma_classes_given(g, dtype, false)) return cudaErrorInvalidValue;
  PT_TILE_DISPATCH(bwd_dq, q, k, v, dout, lse, delta, dq, g, strides,
                   (cudaStream_t)stream);
}
#endif

// The tile mode's dQ that also computes delta (the 16-bit type, d <=
// 128): strides of q, k, v, dout, out, dq.
#if PT_IN_PART(1)
int tile_bwd_dq_delta_entry(const void* q, const void* k, const void* v,
                            const void* dout, const void* out,
                            const void* lse, void* delta, void* dq,
                            const void* km, const void* tcls,
                            const long long* kms, const int* geom,
                            float scale, const long long* strides,
                            const unsigned* drop, float dscale, int dtype,
                            void* stream) {
  const Geom g =
      tile_geom(geom, scale, km, kms, tcls, nullptr, nullptr, drop, dscale);
  if (dtype != kLowCode || g.d % 8 || g.d > 128 || g.H % g.HKV ||
      g.window || !g.km || !g.tcls)
    return cudaErrorInvalidValue;
  const Strides so_ = strides_at(strides, 4), sdq_ = strides_at(strides, 5);
#define PT_TILE_DQ_DELTA(DROP)                                              \
  return g.d <= 64 ? bwd_dq_wgmma<64, true, false, DROP, Low, true>(        \
                         q, k, v, dout, out, lse, delta, dq, g, strides,    \
                         so_, sdq_, (cudaStream_t)stream)                   \
                   : bwd_dq_wgmma<128, true, false, DROP, Low, true>(       \
                         q, k, v, dout, out, lse, delta, dq, g, strides,    \
                         so_, sdq_, (cudaStream_t)stream)
  if (drop) PT_TILE_DQ_DELTA(true);
  PT_TILE_DQ_DELTA(false);
#undef PT_TILE_DQ_DELTA
}
#endif

#if PT_IN_PART(3)
int tile_bwd_dkv_entry(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, const void* km, void* dm,
                       const void* tcls, const long long* kms,
                       const int* geom, float scale,
                       const long long* strides, const unsigned* drop,
                       float dscale, int dtype, void* stream) {
  const Geom g =
      tile_geom(geom, scale, km, kms, tcls, nullptr, dm, drop, dscale);
  if (!wgmma_classes_given(g, dtype, false)) return cudaErrorInvalidValue;
  PT_TILE_DISPATCH(bwd_dkv, q, k, v, dout, lse, delta, dk, dv, g, strides,
                   (cudaStream_t)stream);
}
#endif

}  // namespace

// Strides: the (batch, seq, head) element strides of each [b, s, h, d]
// tensor argument in order, 3 per tensor. lse and delta are [B * H, SQ]
// fp32; km and dm contiguous fp32 rows of SK.

// q, k, v, o strides. km: [B * H, 1, SK] or null.
#if PT_IN_PART(0)
extern "C" int pt_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, const void* km,
                            const int* geom, float scale,
                            const long long* strides, const unsigned* drop,
                            float dscale, int dtype, void* stream) {
  return fwd_entry(q, k, v, o, lse, km, geom, scale, strides, drop, dscale,
                   dtype, stream, 0);
}
#endif

// q, k, v, dout, dq strides.
#if PT_IN_PART(1)
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
#endif

// dQ and delta = rowsum(dO * O) in one launch (the 16-bit type, d <= 128,
// no key row or dropout: drop must be null): delta [B * H, SQ]
// fp32 is written, not read. q, k, v, dout, out, dq strides.
#if PT_IN_PART(1)
extern "C" int pt_flash_bwd_dq_delta(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* out, const void* lse,
                                     void* delta, void* dq, const int* geom,
                                     float scale, const long long* strides,
                                     const unsigned* drop, float dscale,
                                     int dtype, void* stream) {
  if (drop) return cudaErrorInvalidValue;
  return bwd_dq_delta_entry(q, k, v, dout, out, lse, delta, dq, nullptr,
                            geom, scale, strides, nullptr, dscale, dtype,
                            stream, 0);
}
#endif

// q, k, v, dout, dk, dv strides. dm: [B * H, 1, SK] (with km).
#if PT_IN_PART(2)
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
#endif

// The head-batched entries (head_flash.py): as above with km [B, 1, SK]
// one row per batch row, and dm [B, 1, SK] summed over every head.
#if PT_IN_PART(0)
extern "C" int pt_hb_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, const void* km,
                         const int* geom, float scale,
                         const long long* strides, const unsigned* drop,
                         float dscale, int dtype, void* stream) {
  return fwd_entry(q, k, v, o, lse, km, geom, scale, strides, drop, dscale,
                   dtype, stream, 1);
}
#endif

#if PT_IN_PART(1)
extern "C" int pt_hb_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, const void* km,
                            const int* geom, float scale,
                            const long long* strides, const unsigned* drop,
                            float dscale, int dtype, void* stream) {
  return bwd_dq_entry(q, k, v, dout, lse, delta, dq, km, geom, scale,
                      strides, drop, dscale, dtype, stream, 1);
}
#endif

// Kernel 5 computing delta itself, as pt_flash_bwd_dq_delta with the key
// row km [B, 1, SK] (or null) and dropout (drop or null).
#if PT_IN_PART(1)
extern "C" int pt_hb_bwd_dq_delta(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* out, const void* lse,
                                  void* delta, void* dq, const void* km,
                                  const int* geom, float scale,
                                  const long long* strides,
                                  const unsigned* drop, float dscale,
                                  int dtype, void* stream) {
  return bwd_dq_delta_entry(q, k, v, dout, out, lse, delta, dq, km, geom,
                            scale, strides, drop, dscale, dtype, stream, 1);
}
#endif

// dm_heads: [B * H, 1, SK] fp32 scratch (with km) for the per-head dmask
// rows of the dK/dV pass, which a second pass sums over heads into dm.
#if PT_IN_PART(2)
extern "C" int pt_hb_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv,
                             const void* km, void* dm, void* dm_heads,
                             const int* geom, float scale,
                             const long long* strides, const unsigned* drop,
                             float dscale, int dtype, void* stream) {
  const int err = bwd_dkv_entry(q, k, v, dout, lse, delta, dk, dv, km,
                                dm_heads, geom, scale, strides, drop, dscale,
                                dtype, stream, 1);
  if (err || !km) return err;
  const int B = geom[0], H = geom[1], SK = geom[4];
  dmask_head_sum<<<dim3((SK + 255) / 256, B), 256, 0,
                   (cudaStream_t)stream>>>((const float*)dm_heads, (float*)dm,
                                           H, SK);
  return cudaGetLastError();
}
#endif

// The tile mode of the flash entries: km is an fp32 mask that broadcasts
// to [B, H, SQ, SK] with the strides kms = {batch, head, query row} (0
// over a broadcast dim) and a unit key stride, added to every score, then
// the class table's {batch, head} strides and the forward's block count
// (tile_geom); tcls: the class table of pt_flash_tile_classes and (the
// forward) tfull its full-row flags, required for the 16-bit type at d <=
// 128 (null otherwise); dm (or null) receives ds / scale per element as
// [B * H, SQ, SK] fp32 (zeroed by the caller). Other arguments as the
// pt_flash_* entries.
#if PT_IN_PART(0)
extern "C" int pt_flash_tile_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* lse, const void* km,
                                 const void* tcls, const void* tfull,
                                 const long long* kms, const int* geom,
                                 float scale, const long long* strides,
                                 const unsigned* drop, float dscale,
                                 int dtype, void* stream) {
  return tile_fwd_entry(q, k, v, o, lse, km, tcls, tfull, kms, geom, scale,
                        strides, drop, dscale, dtype, stream);
}
#endif

#if PT_IN_PART(1)
extern "C" int pt_flash_tile_bwd_dq(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, const void* km,
                                    const void* tcls, const long long* kms,
                                    const int* geom, float scale,
                                    const long long* strides,
                                    const unsigned* drop, float dscale,
                                    int dtype, void* stream) {
  return tile_bwd_dq_entry(q, k, v, dout, lse, delta, dq, km, tcls, kms,
                           geom, scale, strides, drop, dscale, dtype, stream);
}
#endif

// dQ and delta = rowsum(dO * O) in one launch (the 16-bit type, d <=
// 128; dropout allowed): delta [B * H, SQ] fp32 is written, not read. q,
// k, v, dout, out, dq strides.
#if PT_IN_PART(1)
extern "C" int pt_flash_tile_bwd_dq_delta(
    const void* q, const void* k, const void* v, const void* dout,
    const void* out, const void* lse, void* delta, void* dq, const void* km,
    const void* tcls, const long long* kms, const int* geom, float scale,
    const long long* strides, const unsigned* drop, float dscale, int dtype,
    void* stream) {
  return tile_bwd_dq_delta_entry(q, k, v, dout, out, lse, delta, dq, km,
                                 tcls, kms, geom, scale, strides, drop,
                                 dscale, dtype, stream);
}
#endif

#if PT_IN_PART(3)
extern "C" int pt_flash_tile_bwd_dkv(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, const void* km,
                                     void* dm, const void* tcls,
                                     const long long* kms, const int* geom,
                                     float scale, const long long* strides,
                                     const unsigned* drop, float dscale,
                                     int dtype, void* stream) {
  return tile_bwd_dkv_entry(q, k, v, dout, lse, delta, dk, dv, km, dm, tcls,
                            kms, geom, scale, strides, drop, dscale, dtype,
                            stream);
}
#endif

// The tile mode's class table: km and kms[0..2] as above, mb and mh the
// table's batch and head counts (1 over a broadcast dim), causal the
// kernels' flag; out: uint8 [mb, mh, ceil(SQ / 64), ceil(SK / 64)], full:
// uint8 [mb, mh, ceil(SQ / 64)] (tile_classes_kernel).
#if PT_IN_PART(0)
extern "C" int pt_flash_tile_classes(const void* km, const long long* kms,
                                     int mb, int mh, int SQ, int SK,
                                     int causal, void* out, void* full,
                                     void* stream) {
  if (mb < 1 || mh < 1 || SQ < 1 || SK < 1 || mb * mh > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((SQ + kCell - 1) / kCell, mb * mh);
  tile_classes_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)km, kms[0], kms[1], kms[2], mh, SQ, SK, causal,
      (uint8_t*)out, (uint8_t*)full);
  return cudaGetLastError();
}
#endif
