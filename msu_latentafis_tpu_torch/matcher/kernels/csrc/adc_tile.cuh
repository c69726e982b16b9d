// The CUDA-core tiles of the ADC row max (adc_rowmax.cu, predecoded and
// codes) and of the shapes the screens' Hopper bodies (screen_body.cuh) do
// not take: the predecoded screen with bf16 latents and D > 96, or with f32
// latents beyond the card's shared memory (adc_screen.cu), and the
// transposed bf16 screen with Da > 98 (screen_t.cu, whose int8 screen
// keeps these tiles' layout). The screens' main shapes no longer use it.
//
// A block holds kTile latent rows and kTile rolled columns in shared memory,
// each row padded to D + 1 floats, and every one of its 256 threads keeps a
// 4 x 4 register tile of dot products. The D-long dots run in index order
// with one rounding per product and per sum (the library is built with
// --fmad=false), as in the plain PyTorch versions.
//
// The rolled columns come from one of two loaders with the same interface:
//   DecCols  - predecoded descriptors dec [B, Rt, D], f32, bf16 or int8;
//   CodeCols - uint8 PQ codes [B, Rt, S] looked up in the codebook
//              [S, C, sub_dim] (f32, or rounded to bf16 as the JAX engine's
//              bf16 decode tensor is), which the block copies into shared
//              memory once. Decoded values are exact codebook entries, so
//              both loaders fill a tile with the same bits for the same
//              entry.
// Every loader widens its values to f32 (dtypes.cuh); the tiles and the
// 4 x 4 register tiles stay f32 in every mode.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dtypes.cuh"

namespace afis_adc {

using afis_t::widen;

constexpr int kTile = 64;      // latent rows and rolled columns per tile
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

// Latent rows row0 .. row0 + kTile - 1 of latent n into xs [kTile][D + 1];
// rows past Lt are zero.
template <class XT>
__device__ __forceinline__ void load_rows(float* xs, const XT* x, int n,
                                          int row0, int Lt, int D) {
  const int DP = D + 1;
  for (int idx = threadIdx.x; idx < kTile * D; idx += blockDim.x) {
    const int r = idx / D, d = idx - r * D;
    xs[r * DP + d] = row0 + r < Lt
        ? widen(x[((size_t)n * Lt + row0 + r) * D + d]) : 0.f;
  }
}

template <class DT>
struct DecCols {
  const DT* dec;               // [B, Rt, D]

  static size_t smem_bytes() { return 0; }
  __device__ void init(void*) {}
  // Columns c0 .. c0 + kTile - 1 of entry b into ds [kTile][D + 1].
  __device__ void load(float* ds, int b, int c0, int Rt, int D) const {
    const int DP = D + 1;
    for (int idx = threadIdx.x; idx < kTile * D; idx += blockDim.x) {
      const int c = idx / D, d = idx - c * D;
      ds[c * DP + d] = c0 + c < Rt
          ? widen(dec[((size_t)b * Rt + c0 + c) * D + d]) : 0.f;
    }
  }
};

template <class CT>
struct CodeCols {
  const uint8_t* codes;        // [B, Rt, S]
  const CT* codebook;          // [S, C, sub_dim] in device memory
  int S, C, sub_dim;
  const CT* cb;                // the block's copy in shared memory

  size_t smem_bytes() const { return (size_t)S * C * sub_dim * sizeof(CT); }
  // Copies the codebook into shared memory at sm; the caller synchronizes
  // before the first load.
  __device__ void init(void* sm) {
    CT* dst = static_cast<CT*>(sm);
    const int n = S * C * sub_dim;
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = codebook[i];
    cb = dst;
  }
  // Feature d = s * sub_dim + k of minutia c reads cb[s][codes[c][s]][k].
  __device__ void load(float* ds, int b, int c0, int Rt, int D) const {
    const int DP = D + 1;
    for (int idx = threadIdx.x; idx < kTile * D; idx += blockDim.x) {
      const int c = idx / D, d = idx - c * D;
      float v = 0.f;
      if (c0 + c < Rt) {
        const int s = d / sub_dim, k = d - s * sub_dim;
        const int code = codes[((size_t)b * Rt + c0 + c) * S + s];
        v = widen(cb[(s * C + code) * sub_dim + k]);
      }
      ds[c * DP + d] = v;
    }
  }
};

// acc[i][j] = x_(4 tr + i) . d_(4 tc + j) over the two tiles.
__device__ __forceinline__ void tile_dots(const float* xs, const float* ds,
                                          int D, int tr, int tc,
                                          float acc[4][4]) {
  const int DP = D + 1;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float xv[4], dv[4];
    for (int q = 0; q < 4; ++q) {
      xv[q] = xs[(tr * 4 + q) * DP + d];
      dv[q] = ds[(tc * 4 + q) * DP + d];
    }
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j)
        acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(xv[i], dv[j]));
  }
}

}  // namespace afis_adc
