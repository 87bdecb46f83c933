// Hopper (sm_90a) building blocks of the flash kernels, in raw PTX:
// mbarriers and named barriers, cp.async copies that arrive on an
// mbarrier, register reallocation between warpgroups (setmaxnreg), TMA
// tensor loads, wgmma shared-memory descriptors and the warpgroup
// products wgmma.mma_async (bf16 operands, fp32 accumulators).
//
// Tiles live in shared memory as TMA writes them with the 128-byte
// swizzle: an [R, 64] bf16 box (one "atom" column block of 128 bytes a
// row) per TMA load, 1024-byte aligned, and a tile of DMAX columns is
// DMAX / 64 such boxes one after the other (box a at base + a * R * 128
// bytes). The descriptors below name exactly that layout:
//   - K-major (the contraction runs along the 128-byte rows: Q and K in
//     Q.K^T): SBO = 1024 bytes between 8-row groups; a k16 step moves the
//     start address 32 bytes inside the atom, and past column 64 to the
//     next box;
//   - MN-major (the contraction runs down the rows: V in P.V): the
//     transpose bit of the instruction, SBO = 1024 bytes between 8-row
//     groups along the contraction, LBO = R * 128 bytes between the
//     64-column boxes; a k16 step moves the start 16 rows (2048 bytes).
// wgmma's fp32 accumulator of an m64nN tile has the mma.sync m16n8 layout
// per warp: warp w of the warpgroup holds rows 16 w .. 16 w + 15, and its
// register 4 j + e is row 16 w + lane / 4 + 8 (e / 2), column 8 j + 2
// (lane % 4) + e % 2. An A operand from registers has the mma.sync A
// layout per warp, so an accumulator repacks into it without moving data.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// after every mbar_init and before any other thread or the TMA unit uses
// the barriers
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the barrier has left the phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// A barrier among the `count` threads (whole warps) that name barrier
// `id` (1-15; 0 is __syncthreads's).
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// -- cp.async ----------------------------------------------------------------

// Copy 4 bytes from device to shared memory asynchronously, or write 4
// zero bytes when !valid (src is then not read).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Copy `bytes` (0 to 16) from device to shared memory asynchronously and
// zero the rest of the 16 (src, 16-byte aligned, is read only where bytes
// > 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// One arrival on `bar` once this thread's earlier cp.async copies have
// landed (.noinc: the barrier's count includes it).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// -- register reallocation ----------------------------------------------------

// setmaxnreg: every warp of a warpgroup sets its threads' register count
// to R together, giving registers back to the block's pool (dec) or
// taking them from it (inc, which waits until the pool has them). R is a
// multiple of 8 in [24, 256]. ptxas honours it only where each path of
// the kernel runs one of them and the paths never rejoin.
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// -- TMA ---------------------------------------------------------------------

// One box of a 4-D tensor map into shared memory; completion (its whole
// box, zero-filled past the tensor's edges) is counted on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// -- wgmma -------------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled operand.
__device__ __forceinline__ uint64_t desc_sw128(const void* p,
                                               uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;  // layout: 128-byte swizzle
  return d;
}

// K-major operand: k16 step `ks` of rows [row0, row0 + 64 or N) of an
// [R, DMAX] tile (R rows a box).
template <int R>
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile, int row0,
                                                int ks) {
  const char* p = static_cast<const char*>(tile) + (ks >> 2) * R * 128 +
                  row0 * 128 + (ks & 3) * 32;
  return desc_sw128(p, 16, 1024);
}

// MN-major operand: k16 step `ks` down the rows of an [R, DMAX] tile.
template <int R>
__device__ __forceinline__ uint64_t desc_mnmajor(const void* tile, int ks) {
  const char* p = static_cast<const char*>(tile) + ks * 16 * 128;
  return desc_sw128(p, R * 128, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the wait (or the issue).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R, int C>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define PT_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define PT_ACC16(i) \
  PT_ACC4(i), PT_ACC4(i + 4), PT_ACC4(i + 8), PT_ACC4(i + 12)
#define PT_ACC32 PT_ACC16(0), PT_ACC16(16)
#define PT_ACC64 PT_ACC32, PT_ACC16(32), PT_ACC16(48)

// d (+)= A.B for a 64 x N tile, k16: A and B from shared memory, both
// K-major; scale_d = 0 overwrites d. T: the operands' element type
// (__nv_bfloat16 or __half).
template <int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
// d (+)= A.B, A from registers (4 pairs of T a thread), B from shared
// memory MN-major.
template <int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d);

// The four products for one element type T, whose PTX name is TY.
#define PT_WGMMA_DEFS(T, TY)                                                 \
  template <>                                                                \
  __device__ __forceinline__ void wgmma_ss<64, T>(                           \
      float(&d)[32], uint64_t da, uint64_t db, int scale_d) {                \
    asm volatile(                                                            \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                         \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"         \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "       \
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "       \
        "%26, %27, %28, %29, %30, %31"                                       \
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                    \
        : PT_ACC32                                                           \
        : "l"(da), "l"(db), "r"(scale_d));                                   \
  }                                                                          \
  template <>                                                                \
  __device__ __forceinline__ void wgmma_rs<64, T>(                           \
      float(&d)[32], const uint32_t(&a)[4], uint64_t db, int scale_d) {      \
    asm volatile(                                                            \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                         \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"         \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "       \
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "       \
        "%26, %27, %28, %29, %30, %31"                                       \
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                      \
        : PT_ACC32                                                           \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),               \
          "r"(scale_d));                                                     \
  }                                                                          \
  template <>                                                                \
  __device__ __forceinline__ void wgmma_ss<128, T>(                          \
      float(&d)[64], uint64_t da, uint64_t db, int scale_d) {                \
    asm volatile(                                                            \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                         \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"        \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "       \
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "       \
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "       \
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "       \
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "       \
        "%62, %63"                                                           \
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                                    \
        : PT_ACC64                                                           \
        : "l"(da), "l"(db), "r"(scale_d));                                   \
  }                                                                          \
  template <>                                                                \
  __device__ __forceinline__ void wgmma_rs<128, T>(                          \
      float(&d)[64], const uint32_t(&a)[4], uint64_t db, int scale_d) {      \
    asm volatile(                                                            \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                         \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"        \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "       \
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "       \
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "       \
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "       \
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "       \
        "%62, %63"                                                           \
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                      \
        : PT_ACC64                                                           \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),               \
          "r"(scale_d));                                                     \
  }

PT_WGMMA_DEFS(__nv_bfloat16, "bf16")
PT_WGMMA_DEFS(__half, "f16")
#undef PT_WGMMA_DEFS
#undef PT_ACC4
#undef PT_ACC16
#undef PT_ACC32
#undef PT_ACC64

}  // namespace hopper
