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
// exact minutiae score. normalize=True is minu_screen_norm.cu.
//
// Bound: operations, 2 P R D flops per (template, entry) pair (1.2 MFLOP at
// P = 64, R = 96, D = 96) against the entry's 37 KB of descriptors. Design
// (minu_tile.cuh): the entry's validity-zeroed descriptors stay in shared
// memory while the block walks every template in 64-row tiles, or, for an
// entry too large for shared memory (R above ~480 at D = 96), come in
// 96-column chunks, reloaded per template. The running row maxima [P] and
// column maxima [R] live in shared memory; two threads then sum the relu'd
// maxima in index order, as the plain version does. In the bf16 and int8
// modes the loaders widen the descriptors to f32 (the TPU kernel casts the
// gallery tile to the latent's type and accumulates in f32).
#include "minu_tile.cuh"

namespace {

using namespace afis_minu;

template <class LT, class RT>
__global__ void __launch_bounds__(kThreads) minu_screen_kernel(
    const LT* __restrict__ ldes, const float* __restrict__ lvalid,
    const RT* __restrict__ rdes, const float* __restrict__ rvalid,
    float* __restrict__ out, int NT, int P, int B, int R, int D, int RC) {
  extern __shared__ float sm[];
  const int DP = D + 1;
  float* rs = sm;                        // [RC][DP] entry columns
  float* xs = rs + (size_t)RC * DP;      // [kRows][DP] template rows
  float* rowmax = xs + kRows * DP;       // [P]
  float* colmax = rowmax + P;            // [R]
  float* colpart = colmax + R;           // [16][kCols]
  float* sums = colpart + 16 * kCols;    // [2]
  const int b = blockIdx.x;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const bool resident = RC >= R;

  if (resident) load_cols(rs, rdes, rvalid, b, 0, RC, R, D);
  for (int t = 0; t < NT; ++t) {
    __syncthreads();
    for (int p = tid; p < P; p += blockDim.x) rowmax[p] = -INFINITY;
    for (int r = tid; r < R; r += blockDim.x) colmax[r] = -INFINITY;
    for (int c0 = 0; c0 < R; c0 += RC) {
      if (!resident) {
        __syncthreads();
        load_cols(rs, rdes, rvalid, b, c0, RC, R, D);
      }
      const int c1 = min(c0 + RC, R);
      for (int p0 = 0; p0 < P; p0 += kRows) {
        __syncthreads();
        load_rows(xs, ldes, lvalid, t, p0, P, D);
        __syncthreads();
        for (int r0 = c0; r0 < c1; r0 += kCols) {
          float acc[4][6];
          tile_dots(xs, rs + (size_t)(r0 - c0) * DP, D, tr, tc, acc);
          fold_maxima(acc, p0, r0, P, R, tr, tc, rowmax, colmax, colpart);
        }
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

// ltype / rtype: the descriptors' type codes (dtypes.cuh).
extern "C" int afis_minu_screen(const void* ldes, const float* lvalid,
                                const void* rdes, const float* rvalid,
                                float* out, int NT, int P, int B, int R,
                                int D, int ltype, int rtype, void* stream) {
  if (NT <= 0 || P <= 0 || B <= 0 || R <= 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  size_t bytes = 0;
  const int RC = pick_chunk(R, [&](int rc) {
    return (size_t)(rc + kRows) * (D + 1) + P + R + 16 * kCols + 2;
  }, &bytes);
  if (RC == 0) return (int)cudaErrorInvalidValue;
  return afis_t::dispatch_pair(ltype, rtype, [&](auto lt, auto rt) {
    using LT = typename decltype(lt)::type;
    using RT = typename decltype(rt)::type;
    cudaError_t e = cudaFuncSetAttribute(
        minu_screen_kernel<LT, RT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    minu_screen_kernel<LT, RT>
        <<<B, kThreads, bytes, (cudaStream_t)stream>>>(
            static_cast<const LT*>(ldes), lvalid,
            static_cast<const RT*>(rdes), rvalid, out, NT, P, B, R, D, RC);
    return (int)cudaGetLastError();
  });
}
