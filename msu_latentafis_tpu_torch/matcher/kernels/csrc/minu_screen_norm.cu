// Mutually normalized minutiae screening score, one thread block per
// gallery entry.
//
// Replaces the JAX package's pallas_kernels.py fused_minu_screen with
// normalize=True (:1312, pallas_call :1370, body _minu_screen_kernel
// :1281). For every latent template t and entry b:
//   s    = (relu(ldes_t . rdes_b) * lv) * rv                [P, R]
//   row  = sum_r s, col = sum_p s                  (index order)
//   n    = ((s / (((row + col) - s) + 1e-6)) * lv) * rv
//   out[t, b] = min(sum_p max_r n, sum_r max_p n)   (index order)
// The descriptors are not zeroed before the product, unlike the fast path.
// It is a correlation heuristic, not a bound on the exact score.
//
// Bound: operations, 2 P R D flops per (template, entry) pair, counted
// once although the kernel forms the product twice. Design: the
// normalization needs the whole row and column sums before any maximum,
// so each template takes two passes over the entry's column tiles
// (minu_tile.cuh). Pass 1 stores each 64 x 96 tile of s in shared memory
// and adds it to the row sums [P] (one thread per row) and column sums [R]
// (one thread per column) in index order; pass 2 forms the product again,
// normalizes it and folds it into the row and column maxima. Recomputing
// the tile costs less than keeping P x R floats, and keeps R = 1000 within
// shared memory. In the bf16 and int8 modes the loaders widen the
// descriptors to f32, as the TPU kernel casts them and accumulates in f32.
#include "minu_tile.cuh"

namespace {

using namespace afis_minu;

constexpr int kStoreStride = kCols + 1;   // tile store rows, bank-spread

template <class LT, class RT>
__global__ void __launch_bounds__(kThreads) minu_screen_norm_kernel(
    const LT* __restrict__ ldes, const float* __restrict__ lvalid,
    const RT* __restrict__ rdes, const float* __restrict__ rvalid,
    float* __restrict__ out, int NT, int P, int B, int R, int D, int RC) {
  extern __shared__ float sm[];
  const int DP = D + 1;
  float* rs = sm;                          // [RC][DP] entry columns
  float* xs = rs + (size_t)RC * DP;        // [kRows][DP] template rows
  float* st = xs + kRows * DP;             // [kRows][kStoreStride] s tile
  float* rsum = st + kRows * kStoreStride; // [P]
  float* csum = rsum + P;                  // [R]
  float* rowmax = csum + R;                // [P]
  float* colmax = rowmax + P;              // [R]
  float* colpart = colmax + R;             // [16][kCols]
  float* sums = colpart + 16 * kCols;      // [2]
  const int b = blockIdx.x;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const bool resident = RC >= R;
  const float* rv = rvalid + (size_t)b * R;

  if (resident) load_cols(rs, rdes, nullptr, b, 0, RC, R, D);
  for (int t = 0; t < NT; ++t) {
    const float* lv = lvalid + (size_t)t * P;
    __syncthreads();
    for (int p = tid; p < P; p += blockDim.x) {
      rsum[p] = 0.f;
      rowmax[p] = -INFINITY;
    }
    for (int r = tid; r < R; r += blockDim.x) {
      csum[r] = 0.f;
      colmax[r] = -INFINITY;
    }
    for (int pass = 0; pass < 2; ++pass) {
      for (int c0 = 0; c0 < R; c0 += RC) {
        if (!resident) {
          __syncthreads();
          load_cols(rs, rdes, nullptr, b, c0, RC, R, D);
        }
        const int c1 = min(c0 + RC, R);
        for (int p0 = 0; p0 < P; p0 += kRows) {
          __syncthreads();
          load_rows(xs, ldes, nullptr, t, p0, P, D);
          __syncthreads();
          for (int r0 = c0; r0 < c1; r0 += kCols) {
            float v[4][6];
            tile_dots(xs, rs + (size_t)(r0 - c0) * DP, D, tr, tc, v);
            for (int i = 0; i < 4; ++i) {
              const int p = min(p0 + tr * 4 + i, P - 1);
              for (int j = 0; j < 6; ++j) {
                const int r = min(r0 + tc * 6 + j, R - 1);
                const float s = (fmaxf(v[i][j], 0.f) * lv[p]) * rv[r];
                v[i][j] = pass == 0 ? s
                    : ((s / (((rsum[p] + csum[r]) - s) + 1e-6f)) * lv[p])
                      * rv[r];
              }
            }
            if (pass == 1) {
              fold_maxima(v, p0, r0, P, R, tr, tc, rowmax, colmax, colpart);
              continue;
            }
            for (int i = 0; i < 4; ++i)
              for (int j = 0; j < 6; ++j)
                st[(tr * 4 + i) * kStoreStride + tc * 6 + j] = v[i][j];
            __syncthreads();
            if (tid < kRows) {                       // row sums
              const int p = p0 + tid;
              if (p < P) {
                float a = rsum[p];
                for (int c = 0; c < min(kCols, R - r0); ++c)
                  a = a + st[tid * kStoreStride + c];
                rsum[p] = a;
              }
            } else if (tid < kRows + kCols) {        // column sums
              const int c = tid - kRows, r = r0 + c;
              if (r < R) {
                float a = csum[r];
                for (int i = 0; i < min(kRows, P - p0); ++i)
                  a = a + st[i * kStoreStride + c];
                csum[r] = a;
              }
            }
            __syncthreads();
          }
        }
      }
    }
    if (tid == 0) {
      float s = 0.f;
      for (int p = 0; p < P; ++p) s = s + rowmax[p];
      sums[0] = s;
    } else if (tid == 32) {
      float s = 0.f;
      for (int r = 0; r < R; ++r) s = s + colmax[r];
      sums[1] = s;
    }
    __syncthreads();
    if (tid == 0) out[(size_t)t * B + b] = fminf(sums[0], sums[1]);
  }
}

}  // namespace

// ltype / rtype: the descriptors' type codes (dtypes.cuh).
extern "C" int afis_minu_screen_norm(const void* ldes, const float* lvalid,
                                     const void* rdes, const float* rvalid,
                                     float* out, int NT, int P, int B, int R,
                                     int D, int ltype, int rtype,
                                     void* stream) {
  if (NT <= 0 || P <= 0 || B <= 0 || R <= 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  size_t bytes = 0;
  const int RC = pick_chunk(R, [&](int rc) {
    return (size_t)(rc + kRows) * (D + 1) + kRows * kStoreStride
        + 2 * (P + R) + 16 * kCols + 2;
  }, &bytes);
  if (RC == 0) return (int)cudaErrorInvalidValue;
  return afis_t::dispatch_pair(ltype, rtype, [&](auto lt, auto rt) {
    using LT = typename decltype(lt)::type;
    using RT = typename decltype(rt)::type;
    cudaError_t e = cudaFuncSetAttribute(
        minu_screen_norm_kernel<LT, RT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    minu_screen_norm_kernel<LT, RT>
        <<<B, kThreads, bytes, (cudaStream_t)stream>>>(
            static_cast<const LT*>(ldes), lvalid,
            static_cast<const RT*>(rdes), rvalid, out, NT, P, B, R, D, RC);
    return (int)cudaGetLastError();
  });
}
