// ADC texture screening score, one thread block per (latent, entry).
//
// Replaces the JAX package's pallas_kernels.py fused_adc_screen (:1106) /
// _adc_augmax_kernel (:1080) and, over uint8 PQ codes,
// fused_adc_screen_codes (:1213) / _adc_screen_codes_kernel (:1174):
//   v[i, j]  = (x_i . dec_j + (-(0.5 |dec_j|^2))) + mask_j,
//              mask_j = 0 for a valid rolled minutia, -1e4 for an invalid one
//   out[n, b] = sum_i max(2 max_j v[i, j] + ((6 - |x_i|^2) - tau), 0) * lv_i
// The TPU kernel carries -|dec|^2 / 2 and the -1e4 sentinel as two
// augmented contraction rows; here they are added after the D-long dot, in
// the order written above. With tau = 0 the score bounds the exact texture
// score from above.
//
// Bound: operations, 2 Lt Rt D flops per pair (5.5 MFLOP at the prescreen's
// Lt = 64, 38.5 MFLOP at Lt = 448), against the entry's 172 KB of decoded
// descriptors or 7 KB of codes. Design: the block walks its latent rows in
// 64-row tiles and, for each, the rolled columns in 64-column tiles
// (adc_tile.cuh); a row's term goes to shared memory, and one thread sums
// the Lt terms in index order, as the plain version does. Consecutive
// blocks share the entry, so its descriptors are read from L2 for all but
// the first latent. The codes variant adds the 98.3 KB codebook to the two
// 24.8 KB tiles; the launcher opts in to the shared memory.
#include "adc_tile.cuh"

namespace {

using namespace afis_adc;

template <class Cols>
__global__ void __launch_bounds__(kThreads) adc_screen_kernel(
    const float* __restrict__ x, const float* __restrict__ lsq,
    const float* __restrict__ lvalid, Cols cols,
    const float* __restrict__ rsq, const float* __restrict__ rvalid,
    float* __restrict__ out, int NL, int Lt, int B, int Rt, int D,
    float tau) {
  extern __shared__ float sm[];
  const int DP = D + 1;
  float* xs = sm;                      // [kTile][DP] latent rows
  float* ds = xs + kTile * DP;         // [kTile][DP] rolled columns
  float* term = ds + kTile * DP;       // [Lt] per-row terms
  cols.init(term + Lt);
  // latent fastest: consecutive blocks share the rolled entry in L2
  const int n = blockIdx.x % NL, b = blockIdx.x / NL;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;

  for (int row0 = 0; row0 < Lt; row0 += kTile) {
    __syncthreads();
    load_rows(xs, x, n, row0, Lt, D);
    float bv[4];
    for (int q = 0; q < 4; ++q) bv[q] = -INFINITY;
    for (int c0 = 0; c0 < Rt; c0 += kTile) {
      __syncthreads();
      cols.load(ds, b, c0, Rt, D);
      __syncthreads();
      float acc[4][4];
      tile_dots(xs, ds, D, tr, tc, acc);
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tc * 4 + j;
        if (c >= Rt) break;
        const float nh = -(0.5f * rsq[(size_t)b * Rt + c]);
        const float mk = rvalid[(size_t)b * Rt + c] > 0.f ? 0.f : -1e4f;
        for (int i = 0; i < 4; ++i)
          bv[i] = fmaxf(bv[i], (acc[i][j] + nh) + mk);
      }
    }
    for (int i = 0; i < 4; ++i) {
      for (int off = 8; off > 0; off >>= 1)
        bv[i] = fmaxf(bv[i], __shfl_xor_sync(0xffffffffu, bv[i], off));
      const int r = row0 + tr * 4 + i;
      if (tc == 0 && r < Lt) {
        const size_t o = (size_t)n * Lt + r;
        const float t6 = (6.f - lsq[o]) - tau;
        term[r] = fmaxf(2.f * bv[i] + t6, 0.f) * lvalid[o];
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int r = 0; r < Lt; ++r) s = s + term[r];
    out[(size_t)n * B + b] = s;
  }
}

template <class Cols>
int launch(const float* x, const float* lsq, const float* lvalid, Cols cols,
           const float* rsq, const float* rvalid, float* out, int NL, int Lt,
           int B, int Rt, int D, float tau, void* stream) {
  if (NL <= 0 || Lt <= 0 || B <= 0 || Rt <= 0 || D <= 0
      || (long long)NL * B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = (2 * (size_t)kTile * (D + 1) + Lt
                        + cols.smem_floats()) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      adc_screen_kernel<Cols>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  adc_screen_kernel<Cols><<<NL * B, kThreads, bytes, (cudaStream_t)stream>>>(
      x, lsq, lvalid, cols, rsq, rvalid, out, NL, Lt, B, Rt, D, tau);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int afis_adc_screen(const float* x, const float* lsq,
                               const float* lvalid, const float* dec,
                               const float* rsq, const float* rvalid,
                               float* out, int NL, int Lt, int B, int Rt,
                               int D, float tau, void* stream) {
  return launch(x, lsq, lvalid, DecCols{dec}, rsq, rvalid, out, NL, Lt, B,
                Rt, D, tau, stream);
}

extern "C" int afis_adc_screen_codes(const float* x, const float* lsq,
                                     const float* lvalid,
                                     const uint8_t* codes,
                                     const float* codebook, const float* rsq,
                                     const float* rvalid, float* out, int NL,
                                     int Lt, int B, int Rt, int S, int C,
                                     int sub_dim, float tau, void* stream) {
  if (S <= 0 || C <= 0 || C > 256 || sub_dim <= 0)
    return (int)cudaErrorInvalidValue;
  return launch(x, lsq, lvalid,
                CodeCols{codes, codebook, S, C, sub_dim, nullptr}, rsq,
                rvalid, out, NL, Lt, B, Rt, S * sub_dim, tau, stream);
}
