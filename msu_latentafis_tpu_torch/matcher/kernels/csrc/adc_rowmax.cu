// ADC texture similarity row maxima, without materializing the similarity.
//
// Replaces the JAX package's pallas_kernels.py fused_adc_rowmax (:1489) /
// _adc_rowmax_kernel (:29) and, over uint8 PQ codes, fused_adc_rowmax_codes
// (:1434) / _adc_rowmax_codes_kernel (:1387). For every latent n, gallery
// entry b and latent row i:
//   simi[i, j] = 2 x_i . dec_j + ((6 - |x_i|^2) - |dec_j|^2) + (v_j - 1) 1e30
//   best[n, b, i] = max_j simi[i, j], bestj = the first j reaching it.
// The masking expression is kept exactly: a row whose rolled side is all
// invalid becomes all -1e30 and its argmax is 0.
//
// Bound: operations, 2 Lt Rt D flops per (latent, entry) pair (38.5 MFLOP at
// Lt = Rt = 448, D = 96) against ~0.3 MB read (7 KB of codes), in f32 (no
// TF32: this is the parity mode). Design: a block owns 64 latent rows of one
// (n, b) and walks the Rt axis in 64-column tiles (adc_tile.cuh); the codes
// variant decodes each column tile from the codebook in shared memory (a
// lookup, not the TPU's one-hot matmul). Tiles merge in column order with a
// strict >, threads merge with the smaller index on equal values, so ties
// resolve to the first index. Two 64 x 97 f32 tiles are 49.7 KB and the
// 16 x 256 x 6 codebook 98.3 KB more (49.2 KB rounded to bf16), above the
// 48 KB default: the launcher opts in. Both variants run the same body, so
// on the same entry they give the same bits.
//
// Modes (dtypes.cuh): x is f32 or bf16 (the compute dtype, any int8 scale
// folded in); dec is x's type or int8; the codebook is x's type. Values
// widen to f32 on load and everything after the dot is f32, as in the TPU
// kernel, which casts dec to x's type and accumulates in f32.
#include "adc_tile.cuh"

namespace {

using namespace afis_adc;

template <class XT, class Cols>
__global__ void __launch_bounds__(kThreads) adc_rowmax_kernel(
    const XT* __restrict__ x, const float* __restrict__ lsq, Cols cols,
    const float* __restrict__ rsq, const float* __restrict__ rvalid,
    float* __restrict__ best, int* __restrict__ bestj, int Lt, int B, int Rt,
    int D) {
  extern __shared__ float sm[];
  const int DP = D + 1;
  float* xs = sm;                      // [kTile][DP] latent rows
  float* ds = sm + kTile * DP;         // [kTile][DP] rolled columns
  cols.init(ds + kTile * DP);
  const int row0 = blockIdx.x * kTile, b = blockIdx.y, n = blockIdx.z;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;

  load_rows(xs, x, n, row0, Lt, D);
  float t6[4], bv[4];
  int bi[4];
  for (int q = 0; q < 4; ++q) {
    const int r = row0 + tr * 4 + q;
    t6[q] = r < Lt ? 6.f - lsq[(size_t)n * Lt + r] : 0.f;
    bv[q] = -INFINITY;
    bi[q] = 0;
  }

  for (int c0 = 0; c0 < Rt; c0 += kTile) {
    __syncthreads();
    cols.load(ds, b, c0, Rt, D);
    __syncthreads();
    float acc[4][4];
    tile_dots(xs, ds, D, tr, tc, acc);
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tc * 4 + j;
      if (c >= Rt) break;
      const float cr = rsq[(size_t)b * Rt + c];
      const float mask = (rvalid[(size_t)b * Rt + c] - 1.f) * 1e30f;
      for (int i = 0; i < 4; ++i) {
        const float s = (2.f * acc[i][j] + (t6[i] - cr)) + mask;
        if (s > bv[i]) { bv[i] = s; bi[i] = c; }
      }
    }
  }

  // merge the 16 column groups of each row (lanes of one half-warp)
  for (int i = 0; i < 4; ++i) {
    for (int off = 8; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi[i], off);
      if (ov > bv[i] || (ov == bv[i] && oi < bi[i])) { bv[i] = ov; bi[i] = oi; }
    }
    const int r = row0 + tr * 4 + i;
    if (tc == 0 && r < Lt) {
      const size_t o = ((size_t)n * B + b) * Lt + r;
      best[o] = bv[i];
      bestj[o] = bi[i];
    }
  }
}

template <class XT, class Cols>
int launch(const XT* x, const float* lsq, Cols cols, const float* rsq,
           const float* rvalid, float* best, int* bestj, int NL, int Lt,
           int B, int Rt, int D, void* stream) {
  if (NL <= 0 || Lt <= 0 || B <= 0 || B > 65535 || NL > 65535 || Rt <= 0
      || D <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t bytes =
      2 * (size_t)kTile * (D + 1) * sizeof(float) + cols.smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(
      adc_rowmax_kernel<XT, Cols>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Lt + kTile - 1) / kTile, B, NL);
  adc_rowmax_kernel<XT, Cols>
      <<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
          x, lsq, cols, rsq, rvalid, best, bestj, Lt, B, Rt, D);
  return (int)cudaGetLastError();
}

}  // namespace

// xtype / dtype: the operands' type codes (dtypes.cuh).
extern "C" int afis_adc_rowmax(const void* x, const float* lsq,
                               const void* dec, const float* rsq,
                               const float* rvalid, float* best, int* bestj,
                               int NL, int Lt, int B, int Rt, int D,
                               int xtype, int dtype, void* stream) {
  return afis_t::dispatch_pair(xtype, dtype, [&](auto xt, auto dt) {
    using XT = typename decltype(xt)::type;
    using DT = typename decltype(dt)::type;
    return launch(static_cast<const XT*>(x), lsq,
                  DecCols<DT>{static_cast<const DT*>(dec)}, rsq, rvalid,
                  best, bestj, NL, Lt, B, Rt, D, stream);
  });
}

// The codebook has x's type.
extern "C" int afis_adc_rowmax_codes(const void* x, const float* lsq,
                                     const uint8_t* codes,
                                     const void* codebook, const float* rsq,
                                     const float* rvalid, float* best,
                                     int* bestj, int NL, int Lt, int B,
                                     int Rt, int S, int C, int sub_dim,
                                     int xtype, void* stream) {
  if (S <= 0 || C <= 0 || C > 256 || sub_dim <= 0)
    return (int)cudaErrorInvalidValue;
  return afis_t::dispatch_float(xtype, [&](auto xt) {
    using XT = typename decltype(xt)::type;
    return launch(static_cast<const XT*>(x), lsq,
                  CodeCols<XT>{codes, static_cast<const XT*>(codebook), S, C,
                               sub_dim, nullptr},
                  rsq, rvalid, best, bestj, NL, Lt, B, Rt, S * sub_dim,
                  stream);
  });
}

extern "C" const char* afis_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" const char* afis_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
