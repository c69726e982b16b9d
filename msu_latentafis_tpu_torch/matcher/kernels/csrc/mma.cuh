// Tensor-core pieces of the bf16 screens (screen_body.cuh: the ADC screens
// and the transposed screen; minu_screen.cu): mma.sync.m16n8k16 bf16 x
// bf16 -> f32 and ldmatrix, with
// the fragment layouts of the PTX ISA (lane = 4 g + c, g = lane / 4,
// c = lane % 4):
//   A 16 x 16 (row-major, k contiguous): a0 = (g, 2c..2c+1),
//     a1 = (g + 8, 2c..), a2 = (g, 2c + 8..), a3 = (g + 8, 2c + 8..);
//   B 16 x 8 (k contiguous per column n): b0 = (k 2c..2c+1, n g),
//     b1 = (k 2c + 8.., n g);
//   C 16 x 8 f32: c0, c1 = (g, 2c), (g, 2c + 1); c2, c3 = (g + 8, 2c..).
// A column tile stored [n][k] in shared memory (k contiguous, rows padded
// to an odd number of 16-byte units) gives B fragments by ldmatrix without
// .trans and without bank conflicts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace afis_mma {

constexpr int kK = 16;          // depth of one mma step
constexpr int kMaxKSteps = 6;   // D <= 96 (the matcher's descriptors)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a b for one 16 x 8 x 16 tile (no side effects: not volatile, so
// the compiler may interleave independent tiles).
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo,
                                         __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo))
      | (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Elements k, k + 1 of one bf16 row of length D (zero past D), each times
// s, rounded to bf16 (exact when s is 0 or 1, as validity is).
__device__ __forceinline__ uint32_t row_pair(const __nv_bfloat16* row,
                                             int k, int D, float s) {
  const float lo = k < D ? __bfloat162float(row[k]) * s : 0.f;
  const float hi = k + 1 < D ? __bfloat162float(row[k + 1]) * s : 0.f;
  return pack(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// row_pair with one 32-bit load when the pair is whole and aligned (D
// even) and s is 0 or 1.
__device__ __forceinline__ uint32_t row_pair_fast(const __nv_bfloat16* row,
                                                  int k, int D, float s) {
  if ((D & 1) == 0 && k + 1 < D && (s == 0.f || s == 1.f))
    return s == 0.f ? 0u : __ldg(reinterpret_cast<const unsigned int*>(row + k));
  return row_pair(row, k, D, s);
}

// The A fragments of rows r0 .. r0 + 15 of a [n_rows, D] bf16 matrix for
// k-step ks, each row times scale(row); rows past n_rows are zero.
template <class Scale>
__device__ __forceinline__ void load_a(uint32_t a[4],
                                       const __nv_bfloat16* m, int n_rows,
                                       int D, int r0, int ks,
                                       const Scale& scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int k = ks * kK + 2 * c;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r < n_rows) {
      const __nv_bfloat16* row = m + (size_t)r * D;
      const float s = scale(r);
      a[h] = row_pair_fast(row, k, D, s);
      a[h + 2] = row_pair_fast(row, k + 8, D, s);
    } else {
      a[h] = 0u;
      a[h + 2] = 0u;
    }
  }
}

// B fragments of columns n0 .. n0 + 7 of a tile stored [n][ld] bf16 in
// shared memory, for k-steps 2 j and 2 j + 1: b[0], b[1] and b[2], b[3].
__device__ __forceinline__ void load_b2(uint32_t b[4],
                                        const __nv_bfloat16* tile, int ld,
                                        int n0, int j) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* p = tile + (size_t)(n0 + (lane & 7)) * ld
      + j * 2 * kK + (lane >> 3) * 8;
  ldmatrix_x4(b, smem_addr(p));
}

}  // namespace afis_mma
