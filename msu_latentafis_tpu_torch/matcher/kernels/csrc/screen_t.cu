// The transposed ADC screens of the ADC-screen throughput experiment.
//
// Replaces the two Pallas kernels of the JAX package's
// scripts/exp_screen_mfu.py (pallas_calls :154 and :124, bodies
// kernel_bf16 :89 and kernel_int8 :101). The experiment asks whether the
// screen's row maximum runs faster over the other axis of the product:
// dots [Rt, NL Lt] per entry, reduced over Rt.
//   screen_t_bf16: raw[b, m] = max_j sum_d dect[b, j, d] xt[d, m]
//     dect [B, Rt, D + 2] bf16 (the gallery side with its two augmented
//     columns -|dec|^2 / 2 and the invalid sentinel), xt [D + 2, M] bf16
//     (the latents, M = NL Lt, with two ones rows); f32 sums, raw f32.
//   screen_t_int8: raw[b, m] = max_j (sum_d dect[b, j, d] xt[d, m]
//     + corr[b, j]), int8 x int8 products summed in int32 (__dp4a), exact
//     in any order; corr [B, Rt] int32 carries -|dec|^2 / 2 in x's scale
//     and -2^28 for an invalid column.
// The wrapper (ops.screen_t) builds the operands and applies the script's
// epilogue.
//
// Bound: operations, 2 M Rt (D + 2) per entry (39.3 MFLOP at the script's
// NL 8, Lt 448, Rt 448, D 96), against 88 KB (bf16) or 43 KB (int8) per
// entry read. Designs:
//   - bf16, Da = D + 2 <= 98: tensor cores, screen_body.cuh's body, the
//     same as the bf16 ADC screens' with the script's operands: the rows
//     are the M columns of xt, in fixed groups of 512 (7 at the script's
//     M 3,584), whose A fragments each block reads once from the
//     transposed xt and keeps for its life; the entries' columns arrive in
//     tiles of 128 by 4-byte cp.async (a row of 98 bf16 is not 16-byte
//     aligned) into a ring of three stages. The first 96 features run on
//     the tensor cores; features 96 and 97 (the aug columns against xt's
//     ones rows) are added after the dot in f32, in index order, as the
//     last two terms of the plain version's sum. The blocks of a group take
//     its entries E at a time (the wrapper's `entries`). Only the order of
//     the first 96 products' sum differs from the plain version
//     (ops.screen_t_tol states the tolerance).
//   - bf16 with Da > 98: adc_tile.cuh's 64 x 64 f32 tiles, widened on
//     load, sums in index order: a block owns 64 columns m of xt, kept in
//     shared memory, and walks E entries and each entry's Rt axis in
//     64-row tiles; each of 256 threads keeps a 4 x 4 register tile.
//   - int8: the same tiling, four int8 values to a 32-bit word in shared
//     memory, summed with __dp4a.
#include <limits.h>

#include "adc_tile.cuh"
#include "screen_body.cuh"

namespace {

using namespace afis_adc;

constexpr int kMaxEntries = 64;   // entries per block (static cap)

// xs[m][d] = xt[d, m0 + m] widened, rows past M zero.
__device__ void load_xt_bf16(float* xs, const afis_t::bf16* xt, int m0,
                             int M, int Da) {
  const int DP = Da + 1;
  for (int idx = threadIdx.x; idx < kTile * Da; idx += blockDim.x) {
    const int d = idx / kTile, m = idx - d * kTile;
    xs[m * DP + d] = m0 + m < M ? widen(xt[(size_t)d * M + m0 + m]) : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads) screen_t_bf16_kernel(
    const afis_t::bf16* __restrict__ xt,
    const afis_t::bf16* __restrict__ dect, float* __restrict__ raw, int M,
    int B, int Rt, int Da, int E) {
  extern __shared__ float sm[];
  const int DP = Da + 1;
  float* xs = sm;                      // [kTile][DP] latent columns m
  float* ds = sm + kTile * DP;         // [kTile][DP] entry rows j
  const int m0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  load_xt_bf16(xs, xt, m0, M, Da);
  const DecCols<afis_t::bf16> cols{dect};
  for (int e = 0; e < E; ++e) {
    const int b = blockIdx.y * E + e;
    if (b >= B) break;
    float bv[4];
    for (int q = 0; q < 4; ++q) bv[q] = -INFINITY;
    for (int c0 = 0; c0 < Rt; c0 += kTile) {
      __syncthreads();
      cols.load(ds, b, c0, Rt, Da);
      __syncthreads();
      float acc[4][4];
      tile_dots(xs, ds, Da, tr, tc, acc);
      for (int j = 0; j < 4; ++j) {
        if (c0 + tc * 4 + j >= Rt) break;
        for (int i = 0; i < 4; ++i) bv[i] = fmaxf(bv[i], acc[i][j]);
      }
    }
    for (int i = 0; i < 4; ++i) {
      for (int off = 8; off > 0; off >>= 1)
        bv[i] = fmaxf(bv[i], __shfl_xor_sync(0xffffffffu, bv[i], off));
      const int m = m0 + tr * 4 + i;
      if (tc == 0 && m < M) raw[(size_t)b * M + m] = bv[i];
    }
  }
}

__device__ __forceinline__ int pack4(const int8_t* p, size_t stride) {
  return (int)(uint8_t)p[0] | ((int)(uint8_t)p[stride] << 8)
      | ((int)(uint8_t)p[2 * stride] << 16)
      | ((int)(uint8_t)p[3 * stride] << 24);
}

__global__ void __launch_bounds__(kThreads) screen_t_int8_kernel(
    const int8_t* __restrict__ xt, const int8_t* __restrict__ dect,
    const int* __restrict__ corr, int* __restrict__ raw, int M, int B,
    int Rt, int D, int E) {
  extern __shared__ int smi[];
  const int W = D / 4, WP = W + 1;     // 32-bit words per row, padded
  int* xs = smi;                       // [kTile][WP] latent columns m
  int* ds = smi + kTile * WP;          // [kTile][WP] entry rows j
  const int m0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  for (int idx = tid; idx < kTile * W; idx += blockDim.x) {
    const int w = idx / kTile, m = idx - w * kTile;
    xs[m * WP + w] = m0 + m < M
        ? pack4(xt + (size_t)4 * w * M + m0 + m, (size_t)M) : 0;
  }
  for (int e = 0; e < E; ++e) {
    const int b = blockIdx.y * E + e;
    if (b >= B) break;
    int bv[4] = {INT_MIN, INT_MIN, INT_MIN, INT_MIN};
    for (int c0 = 0; c0 < Rt; c0 += kTile) {
      __syncthreads();
      for (int idx = tid; idx < kTile * W; idx += blockDim.x) {
        const int c = idx / W, w = idx - c * W;
        ds[c * WP + w] = c0 + c < Rt
            ? pack4(dect + ((size_t)b * Rt + c0 + c) * D + 4 * w, 1) : 0;
      }
      __syncthreads();
      int acc[4][4];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] = 0;
      for (int w = 0; w < W; ++w) {
        int xv[4], dv[4];
        for (int q = 0; q < 4; ++q) {
          xv[q] = xs[(tr * 4 + q) * WP + w];
          dv[q] = ds[(tc * 4 + q) * WP + w];
        }
        for (int i = 0; i < 4; ++i)
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(xv[i], dv[j], acc[i][j]);
      }
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tc * 4 + j;
        if (c >= Rt) break;
        const int cr = corr[(size_t)b * Rt + c];
        for (int i = 0; i < 4; ++i) bv[i] = max(bv[i], acc[i][j] + cr);
      }
    }
    for (int i = 0; i < 4; ++i) {
      for (int off = 8; off > 0; off >>= 1)
        bv[i] = max(bv[i], __shfl_xor_sync(0xffffffffu, bv[i], off));
      const int m = m0 + tr * 4 + i;
      if (tc == 0 && m < M) raw[(size_t)b * M + m] = bv[i];
    }
  }
}

bool bad_shape(int M, int B, int Rt, int D, int E) {
  return M <= 0 || B <= 0 || Rt <= 0 || D <= 0 || E <= 0 || E > kMaxEntries
      || (B + E - 1) / E > 65535;
}

}  // namespace

// xt [Da, M] bf16, dect [B, Rt, Da] bf16 -> raw [B, M] f32; E entries per
// block at a time.
extern "C" int afis_screen_t_bf16(const void* xt, const void* dect,
                                  float* raw, int M, int B, int Rt, int Da,
                                  int E, void* stream) {
  namespace sc = afis_screen;
  if (bad_shape(M, B, Rt, Da, E)) return (int)cudaErrorInvalidValue;
  const auto* x = static_cast<const afis_t::bf16*>(xt);
  const auto* d = static_cast<const afis_t::bf16*>(dect);
  const int Dk = min(Da, sc::kDMax), tail = Da - Dk;
  if (tail <= 2) {
    sc::TRows rows{x, raw, M, Dk, tail, B, M, 0};
    sc::Walk w{B, Rt, sc::kCT, (Rt + sc::kCT - 1) / sc::kCT, 1, E, true};
    rows.plan_tc(w);
    const sc::CopyTC<afis_t::bf16, true> src{
        d, nullptr, nullptr, Da, Dk, tail, sc::copy_chunk(d, Da, Dk)};
    if (sc::tc_smem_bytes(src, rows) <= sc::smem_optin())
      return sc::launch_tc(src, rows, w, stream);
  }
  const size_t bytes = 2 * (size_t)kTile * (Da + 1) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      screen_t_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + kTile - 1) / kTile, (B + E - 1) / E);
  screen_t_bf16_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      x, d, raw, M, B, Rt, Da, E);
  return (int)cudaGetLastError();
}

// xt [D, M] int8, dect [B, Rt, D] int8 (D a multiple of 4), corr [B, Rt]
// int32 -> raw [B, M] int32; E entries per block.
extern "C" int afis_screen_t_int8(const int8_t* xt, const int8_t* dect,
                                  const int* corr, int* raw, int M, int B,
                                  int Rt, int D, int E, void* stream) {
  if (bad_shape(M, B, Rt, D, E) || D % 4) return (int)cudaErrorInvalidValue;
  const size_t bytes = 2 * (size_t)kTile * (D / 4 + 1) * sizeof(int);
  const dim3 grid((M + kTile - 1) / kTile, (B + E - 1) / E);
  screen_t_int8_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      xt, dect, corr, raw, M, B, Rt, D, E);
  return (int)cudaGetLastError();
}
