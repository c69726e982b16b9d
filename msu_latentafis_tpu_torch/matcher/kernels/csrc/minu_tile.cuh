// Shared pieces of the two minutiae screens (minu_screen.cu and
// minu_screen_norm.cu): one thread block per gallery entry walks every
// template in 64-row tiles against the entry's columns in 96-column tiles;
// each of the 256 threads keeps a 4 x 6 register tile, the D-long dots in
// index order with one rounding per product and per sum. Rows are padded to
// D + 1 in shared memory. The block holds the whole entry when it fits in
// shared memory and otherwise one 96-column chunk at a time, so any R runs.
// The descriptors are f32 or bf16 on the latent side and the latent's type
// or int8 on the gallery side (dtypes.cuh); the loaders widen them to f32.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dtypes.cuh"

namespace afis_minu {

using afis_t::widen;

constexpr int kRows = 64;      // latent rows per tile (16 groups of 4)
constexpr int kCols = 96;      // rolled columns per tile (16 groups of 6)
constexpr int kThreads = 256;

// xs[p][d] = ldes[t, p0 + p, d] (times lvalid[t, p0 + p] when lvalid is
// given) for p < kRows; zero past P.
template <class LT>
__device__ inline void load_rows(float* xs, const LT* __restrict__ ldes,
                                 const float* __restrict__ lvalid, int t,
                                 int p0, int P, int D) {
  const int DP = D + 1;
  for (int idx = threadIdx.x; idx < kRows * D; idx += blockDim.x) {
    const int p = idx / D, d = idx - p * D;
    const size_t row = (size_t)t * P + p0 + p;
    float v = 0.f;
    if (p0 + p < P) {
      v = widen(ldes[row * D + d]);
      if (lvalid != nullptr) v = v * lvalid[row];
    }
    xs[p * DP + d] = v;
  }
}

// rs[c][d] = rdes[b, c0 + c, d] (times rvalid[b, c0 + c] when rvalid is
// given) for c < n; zero past R.
template <class RT>
__device__ inline void load_cols(float* rs, const RT* __restrict__ rdes,
                                 const float* __restrict__ rvalid, int b,
                                 int c0, int n, int R, int D) {
  const int DP = D + 1;
  for (int idx = threadIdx.x; idx < n * D; idx += blockDim.x) {
    const int c = idx / D, d = idx - c * D;
    const size_t col = (size_t)b * R + c0 + c;
    float v = 0.f;
    if (c0 + c < R) {
      v = widen(rdes[col * D + d]);
      if (rvalid != nullptr) v = v * rvalid[col];
    }
    rs[c * DP + d] = v;
  }
}

// acc[i][j] = xs row (tr * 4 + i) . rs row (tc * 6 + j), index order.
__device__ inline void tile_dots(const float* xs, const float* rs, int D,
                                 int tr, int tc, float acc[4][6]) {
  const int DP = D + 1;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 6; ++j) acc[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float xv[4], rv[6];
    for (int q = 0; q < 4; ++q) xv[q] = xs[(tr * 4 + q) * DP + d];
    for (int q = 0; q < 6; ++q) rv[q] = rs[(tc * 6 + q) * DP + d];
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 6; ++j)
        acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(xv[i], rv[j]));
  }
}

// Fold one tile's values v (rows p0 + tr * 4 + i, columns r0 + tc * 6 + j)
// into the running row maxima [P] and column maxima [R]: rows across the
// 16 lanes of a half-warp by shuffles, columns through colpart [16][kCols].
// Maxima are exact in any order. Every thread calls it; it synchronizes.
__device__ inline void fold_maxima(float v[4][6], int p0, int r0,
                                   int P, int R, int tr, int tc,
                                   float* rowmax, float* colmax,
                                   float* colpart) {
  for (int i = 0; i < 4; ++i) {
    float m = -INFINITY;
    for (int j = 0; j < 6; ++j)
      if (r0 + tc * 6 + j < R) m = fmaxf(m, v[i][j]);
    for (int off = 8; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const int p = p0 + tr * 4 + i;
    if (tc == 0 && p < P) rowmax[p] = fmaxf(rowmax[p], m);
  }
  for (int j = 0; j < 6; ++j) {
    float m = -INFINITY;
    for (int i = 0; i < 4; ++i)
      if (p0 + tr * 4 + i < P) m = fmaxf(m, v[i][j]);
    colpart[tr * kCols + tc * 6 + j] = m;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < kCols; c += blockDim.x) {
    if (r0 + c >= R) continue;
    float m = colmax[r0 + c];
    for (int g = 0; g < 16; ++g) m = fmaxf(m, colpart[g * kCols + c]);
    colmax[r0 + c] = m;
  }
  __syncthreads();
}

// Rolled columns a block holds at once: the whole entry (R rounded up to
// kCols) when words(that) floats of shared memory fit in the card's opt-in
// limit, else one kCols chunk. Writes the bytes; returns 0 when not even
// one chunk fits.
template <class Words>
inline int pick_chunk(int R, const Words& words, size_t* bytes) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&limit,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev) != cudaSuccess)
    return 0;
  const int rpad = (R + kCols - 1) / kCols * kCols;
  const int cand[2] = {rpad, kCols};
  for (int i = 0; i < 2; ++i) {
    *bytes = words(cand[i]) * sizeof(float);
    if (*bytes <= (size_t)limit) return cand[i];
  }
  return 0;
}

}  // namespace afis_minu
