// Hopper pieces of the warp-specialized ADC screen (screen_wg.cuh), sm_90a
// only: warpgroup products (wgmma.mma_async, A in registers, B from shared
// memory through a matrix descriptor), mbarriers, 1-D bulk copies
// (cp.async.bulk) that complete on an mbarrier, named barriers and the
// register hand-over between warpgroups (setmaxnreg).
//
// wgmma m64nNk16 with A in registers takes, per warp w of the warpgroup,
// rows 16 w .. 16 w + 15 in mma.sync's m16n8k16 A fragment layout
// (mma.cuh: a0 = (g, 2c..), a1 = (g + 8, 2c..), a2 = (g, 2c + 8..),
// a3 = (g + 8, 2c + 8..)), and leaves in each thread the accumulators
// d[4 i + 0..3] = (g, 8 i + 2c), (g, 8 i + 2c + 1), (g + 8, 8 i + 2c),
// (g + 8, 8 i + 2c + 1) of its warp's rows, for each 8 columns i.
// B is K-major without swizzle: core matrices of 8 columns x 16 bytes of k
// stored as 128 contiguous bytes; the descriptor's leading byte offset
// steps from one core matrix to the next along k, its stride byte offset
// from one 8-column group to the next.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace afis_wg {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}
// Makes the barriers' initialization visible to the other threads and to
// the bulk copies; then a __syncthreads.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}
// One arrival that also expects `bytes` of bulk copies on the phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// --- copies and proxies ----------------------------------------------------

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from device
// memory into shared memory, completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// Orders this thread's shared-memory accesses before later ones of the
// async proxy (wgmma operands, bulk copies).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- named barriers and registers ------------------------------------------

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
template <int N>
__device__ __forceinline__ void regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_take() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// --- warpgroup products ----------------------------------------------------

// The descriptor of a K-major, unswizzled B operand at p (16-byte aligned,
// below 256 KB): lbo bytes between core matrices along k, sbo between
// 8-column groups.
__device__ __forceinline__ uint64_t b_desc(const void* p, uint32_t lbo,
                                           uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4)
      | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
      | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Tells the compiler that v changes here: accumulators are written by the
// products until wgmma_wait returns, so reads must not move above it.
__device__ __forceinline__ void fence_reg(float& v) {
  asm volatile("" : "+f"(v)::"memory");
}

// d (+)= a b for 64 rows x 64 columns x 16 of k, bf16 x bf16 -> f32: a in
// registers, b through its descriptor; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4], uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

}  // namespace afis_wg
