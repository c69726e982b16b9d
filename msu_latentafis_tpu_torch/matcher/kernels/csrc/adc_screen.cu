// ADC texture screening score, one thread block per (latent, entry).
//
// Replaces the JAX package's pallas_kernels.py fused_adc_screen (:1106) /
// _adc_augmax_kernel (:1080); the codes variant fused_adc_screen_codes is
// adc_screen_codes.cu:
//   v[i, j]   = (x_i . dec_j + a1_j) + a2_j
//   raw[i]    = max_j v[i, j], rounded to x's type
//   out[n, b] = sum_i max(2 raw[i] + ((6 - |x_i|^2) - tau), 0) * lv_i
// The TPU kernel carries a1 and a2 as two augmented contraction rows of
// dec against two columns of x; the wrapper (ops.screen_aug) forms the
// products a1_j, a2_j the contraction adds and this kernel adds them after
// the D-long dot, in the order written above:
//   - f32 / bf16 dec: a1 = -(|dec_j|^2 / 2) and a2 = 0 for a valid rolled
//     minutia, -1e4 for an invalid one, both rounded to dec's type;
//   - int8 dec (tex_int8): a1 = c1 * round(-(|dec_j|^2 / 2) / c1) with c1
//     one scale per JAX engine block of entries, in x's type, and a2 = 0 or
//     -127.
// In f32 the screen is the one before the modes, bit for bit. With tau = 0
// it bounds the exact texture score from above (up to the rounding of the
// bf16 and int8 modes).
//
// Bound: operations, 2 Lt Rt D flops per pair (5.5 MFLOP at the prescreen's
// Lt = 64, 38.5 MFLOP at Lt = 448), against the entry's 172 KB of decoded
// f32 descriptors (86 KB in bf16, 43 KB in int8). Design:
// the block walks its latent rows in 64-row tiles and, for each, the rolled
// columns in 64-column tiles (adc_tile.cuh, values widened to f32 on load);
// a row's term goes to shared memory, and one thread sums the Lt terms in
// index order, as the plain version does. Consecutive blocks share the
// entry, so its descriptors are read from L2 for all but the first latent.
// The two 24.8 KB tiles exceed the 48 KB default; the launcher opts in.
#include "adc_tile.cuh"

namespace {

using namespace afis_adc;

template <class XT, class Cols>
__global__ void __launch_bounds__(kThreads) adc_screen_kernel(
    const XT* __restrict__ x, const float* __restrict__ lsq,
    const float* __restrict__ lvalid, Cols cols,
    const float* __restrict__ a1, const float* __restrict__ a2,
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
        const float u = a1[(size_t)b * Rt + c];
        const float w = a2[(size_t)b * Rt + c];
        for (int i = 0; i < 4; ++i)
          bv[i] = fmaxf(bv[i], (acc[i][j] + u) + w);
      }
    }
    for (int i = 0; i < 4; ++i) {
      for (int off = 8; off > 0; off >>= 1)
        bv[i] = fmaxf(bv[i], __shfl_xor_sync(0xffffffffu, bv[i], off));
      const int r = row0 + tr * 4 + i;
      if (tc == 0 && r < Lt) {
        const size_t o = (size_t)n * Lt + r;
        const float t6 = (6.f - lsq[o]) - tau;
        const float raw = afis_t::round_to<XT>(bv[i]);
        term[r] = fmaxf(2.f * raw + t6, 0.f) * lvalid[o];
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

template <class XT, class Cols>
int launch(const XT* x, const float* lsq, const float* lvalid, Cols cols,
           const float* a1, const float* a2, float* out, int NL, int Lt,
           int B, int Rt, int D, float tau, void* stream) {
  if (NL <= 0 || Lt <= 0 || B <= 0 || Rt <= 0 || D <= 0
      || (long long)NL * B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = (2 * (size_t)kTile * (D + 1) + Lt) * sizeof(float)
      + cols.smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(
      adc_screen_kernel<XT, Cols>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  adc_screen_kernel<XT, Cols>
      <<<NL * B, kThreads, bytes, (cudaStream_t)stream>>>(
          x, lsq, lvalid, cols, a1, a2, out, NL, Lt, B, Rt, D, tau);
  return (int)cudaGetLastError();
}

}  // namespace

// xtype / dtype: the operands' type codes (dtypes.cuh); a1 / a2 [B, Rt].
extern "C" int afis_adc_screen(const void* x, const float* lsq,
                               const float* lvalid, const void* dec,
                               const float* a1, const float* a2, float* out,
                               int NL, int Lt, int B, int Rt, int D,
                               float tau, int xtype, int dtype,
                               void* stream) {
  return afis_t::dispatch_pair(xtype, dtype, [&](auto xt, auto dt) {
    using XT = typename decltype(xt)::type;
    using DT = typename decltype(dt)::type;
    return launch(static_cast<const XT*>(x), lsq, lvalid,
                  DecCols<DT>{static_cast<const DT*>(dec)}, a1, a2, out, NL,
                  Lt, B, Rt, D, tau, stream);
  });
}
