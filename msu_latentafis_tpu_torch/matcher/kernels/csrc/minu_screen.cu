// Minutiae screening score, one thread block per gallery entry.
//
// Replaces the JAX package's pallas_kernels.py fused_minu_screen fast path
// (:1312, pallas_call :1341, body _minu_screen_fast_kernel :1262). For every
// latent template t and entry b, with invalid rows and columns zeroed:
//   s = (ldes_t * lv_t) . (rdes_b * rv_b)^T           [P, R]
//   out[t, b] = min(sum_p relu(max_r s[p, r]), sum_r relu(max_p s[p, r]))
// With all of it in the kernel: the TPU kernel writes the row and column
// maxima planes ([NT, B, P] and [NT, B, R], ~1.5 GB at 100,000 entries) and
// leaves the relu-sums and the min to XLA. It is an upper bound on the
// exact minutiae score. normalize=True is another kernel, not ported.
//
// Bound: operations, 2 P R D flops per (template, entry) pair (1.2 MFLOP at
// P = 64, R = 96, D = 96) against the entry's 37 KB of descriptors. Design:
// the entry's R descriptors stay in shared memory (rows padded to D + 1,
// R rounded up to 96 with zeros) while the block walks every template in
// 64-row tiles; each of the 256 threads keeps a 4 x 6 register tile, the
// D-long dots in index order with one rounding per product and per sum.
// Row maxima merge across a half-warp by shuffles, column maxima through
// shared memory; two threads then sum the relu'd maxima in index order, as
// the plain version does. Maxima are exact in any order.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // latent rows per tile (16 groups of 4)
constexpr int kCols = 96;      // rolled columns per tile (16 groups of 6)
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) minu_screen_kernel(
    const float* __restrict__ ldes, const float* __restrict__ lvalid,
    const float* __restrict__ rdes, const float* __restrict__ rvalid,
    float* __restrict__ out, int NT, int P, int B, int R, int D) {
  extern __shared__ float sm[];
  const int DP = D + 1;
  const int Rpad = (R + kCols - 1) / kCols * kCols;
  float* rs = sm;                        // [Rpad][DP] entry descriptors
  float* xs = rs + (size_t)Rpad * DP;    // [kRows][DP] template rows
  float* rowmax = xs + kRows * DP;       // [P]
  float* colmax = rowmax + P;            // [R]
  float* colpart = colmax + R;           // [16][kCols]
  float* sums = colpart + 16 * kCols;    // [2]
  const int b = blockIdx.x;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;

  for (int idx = tid; idx < Rpad * D; idx += blockDim.x) {
    const int r = idx / D, d = idx - r * D;
    rs[r * DP + d] = r < R
        ? rdes[((size_t)b * R + r) * D + d] * rvalid[(size_t)b * R + r] : 0.f;
  }

  for (int t = 0; t < NT; ++t) {
    __syncthreads();
    for (int p = tid; p < P; p += blockDim.x) rowmax[p] = -INFINITY;
    for (int r = tid; r < R; r += blockDim.x) colmax[r] = -INFINITY;
    for (int p0 = 0; p0 < P; p0 += kRows) {
      __syncthreads();
      for (int idx = tid; idx < kRows * D; idx += blockDim.x) {
        const int p = idx / D, d = idx - p * D;
        const size_t row = (size_t)t * P + p0 + p;
        xs[p * DP + d] = p0 + p < P ? ldes[row * D + d] * lvalid[row] : 0.f;
      }
      __syncthreads();
      for (int r0 = 0; r0 < R; r0 += kCols) {
        float acc[4][6];
        for (int i = 0; i < 4; ++i)
          for (int j = 0; j < 6; ++j) acc[i][j] = 0.f;
        for (int d = 0; d < D; ++d) {
          float xv[4], rv[6];
          for (int q = 0; q < 4; ++q) xv[q] = xs[(tr * 4 + q) * DP + d];
          for (int q = 0; q < 6; ++q) rv[q] = rs[(r0 + tc * 6 + q) * DP + d];
          for (int i = 0; i < 4; ++i)
            for (int j = 0; j < 6; ++j)
              acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(xv[i], rv[j]));
        }
        // row maxima over this tile's valid columns, merged over 16 lanes
        for (int i = 0; i < 4; ++i) {
          float m = -INFINITY;
          for (int j = 0; j < 6; ++j)
            if (r0 + tc * 6 + j < R) m = fmaxf(m, acc[i][j]);
          for (int off = 8; off > 0; off >>= 1)
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
          const int p = p0 + tr * 4 + i;
          if (tc == 0 && p < P) rowmax[p] = fmaxf(rowmax[p], m);
        }
        // column maxima over this tile's rows, merged through shared memory
        for (int j = 0; j < 6; ++j) {
          float m = -INFINITY;
          for (int i = 0; i < 4; ++i)
            if (p0 + tr * 4 + i < P) m = fmaxf(m, acc[i][j]);
          colpart[tr * kCols + tc * 6 + j] = m;
        }
        __syncthreads();
        for (int c = tid; c < kCols; c += blockDim.x) {
          if (r0 + c >= R) continue;
          float m = colmax[r0 + c];
          for (int g = 0; g < 16; ++g) m = fmaxf(m, colpart[g * kCols + c]);
          colmax[r0 + c] = m;
        }
        __syncthreads();
      }
    }
    if (tid == 0) {
      float s = 0.f;
      for (int p = 0; p < P; ++p) s = s + fmaxf(rowmax[p], 0.f);
      sums[0] = s;
    } else if (tid == 32) {
      float s = 0.f;
      for (int r = 0; r < R; ++r) s = s + fmaxf(colmax[r], 0.f);
      sums[1] = s;
    }
    __syncthreads();
    if (tid == 0) out[(size_t)t * B + b] = fminf(sums[0], sums[1]);
  }
}

}  // namespace

extern "C" int afis_minu_screen(const float* ldes, const float* lvalid,
                                const float* rdes, const float* rvalid,
                                float* out, int NT, int P, int B, int R,
                                int D, void* stream) {
  if (NT <= 0 || P <= 0 || B <= 0 || R <= 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  const int Rpad = (R + kCols - 1) / kCols * kCols;
  const size_t bytes = ((size_t)(Rpad + kRows) * (D + 1) + P + R
                        + 16 * kCols + 2) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      minu_screen_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  minu_screen_kernel<<<B, kThreads, bytes, (cudaStream_t)stream>>>(
      ldes, lvalid, rdes, rvalid, out, NT, P, B, R, D);
  return (int)cudaGetLastError();
}
