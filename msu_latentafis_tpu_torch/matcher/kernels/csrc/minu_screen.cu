// Minutiae screening score, fast path.
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
// P = 64, R = 96, D = 96; 3.1 MFLOP at the cap's P = R = 128) against the
// entry's 37 KB of descriptors (12 KB in int8); without FMA (the sums stay
// in the plain version's roundings) the f32 ceiling is half the f32 rate.
// Two designs by the latent operand's type (minu_body.cuh):
//   - f32 latents ([f32,f32], [f32,int8]): CUDA cores, bit for bit the
//     plain version. At the serving shape (8 templates, P 64, R 96) a block
//     keeps 4 templates' validity-zeroed rows in shared memory and walks a
//     run of ~250 entries (the grid: 2 template groups x 66 runs, one
//     block an SM), each entry's rows copied by cp.async while the block
//     works on the entry before; 8 warps take 16 items of 32 x 48 sums, 4 x
//     12 per lane from 16-byte shared loads, and fold row and column maxima
//     by shuffles; one warp per template sums the relu'd maxima in index
//     order during the next entry.
//   - bf16 latents ([bf16,bf16], [bf16,int8]): tensor cores,
//     mma.sync.m16n8k16 bf16 -> f32. The block stages the entry in bf16
//     (stage_entry: an int8 value |v| <= 127 is exact in bf16),
//     validity-zeroed, in chunks of up to 128 columns, so R = 96 and R = 128
//     are one chunk without padding and any R runs (24.6 KB at R 128). Each
//     warp takes a template: 32 rows at a time as A fragments straight from
//     global memory (tc_rows; the templates are the same for every entry,
//     so L2 serves them), the chunk's columns as B fragments by ldmatrix
//     (tc_cols); row maxima fold from the accumulators in registers and go
//     to shared memory [NT, P], column maxima stay in registers until the
//     warp has seen all P rows, then their relu's add to the template's
//     column sum in index order; the row sums follow in index order. Maxima
//     are exact in any order, so only the f32 accumulation inside each dot
//     differs from the plain version (held to rtol 1e-5 / atol 1e-4).
#include "minu_body.cuh"

namespace {

using namespace afis_minu;

// One warp, template t, the staged chunk (columns c0 .. c0 + nc - 1): row
// maxima into rowmax[t][P] (max with the earlier chunks'), the chunk's
// column maxima relu'd and added to csum[t] in index order.
__device__ inline void sweep_template(const bf16* __restrict__ ldes,
                                      const float* __restrict__ lvalid,
                                      const bf16* es, float* rowmax,
                                      float* csum, float* colbuf, int t,
                                      int P, int D, int c0, int nc) {
  using afis_mma::kMaxKSteps;
  const int lane = threadIdx.x & 31, g = lane >> 2, cq = lane & 3;
  const int nn = (nc + 7) >> 3;
  const bool col_edge = (nc & 7) != 0;
  const bf16* lt = ldes + (size_t)t * P * D;
  const float* lv = lvalid + (size_t)t * P;
  const auto scale = [&](int r) { return lv[r]; };
  float cm[kRC / 8][2];
#pragma unroll
  for (int n = 0; n < kRC / 8; ++n) cm[n][0] = cm[n][1] = -INFINITY;
  for (int mp = 0; mp < P; mp += 32) {
    uint32_t a[2][kMaxKSteps][4];
    tc_rows(a, lt, P, D, mp, scale);
    const bool row_edge = mp + 32 > P;
    float rm[2][2];
#pragma unroll
    for (int m = 0; m < 2; ++m) rm[m][0] = rm[m][1] = -INFINITY;
#pragma unroll
    for (int n = 0; n < kRC / 8; ++n) {
      if (n >= nn) break;
      float acc[2][4];
      tc_cols(a, es, n * 8, acc);
      if (col_edge && n == nn - 1) {     // columns past nc are not the entry's
        const int col = n * 8 + 2 * cq;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if (col >= nc) acc[m][0] = acc[m][2] = -INFINITY;
          if (col + 1 >= nc) acc[m][1] = acc[m][3] = -INFINITY;
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        rm[m][0] = fmaxf(rm[m][0], fmaxf(acc[m][0], acc[m][1]));
        rm[m][1] = fmaxf(rm[m][1], fmaxf(acc[m][2], acc[m][3]));
      }
      if (row_edge) {                    // rows past P are not the template's
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int r = mp + 16 * m + g;
          if (r >= P) acc[m][0] = acc[m][1] = -INFINITY;
          if (r + 8 >= P) acc[m][2] = acc[m][3] = -INFINITY;
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        cm[n][0] = fmaxf(cm[n][0], fmaxf(acc[m][0], acc[m][2]));
        cm[n][1] = fmaxf(cm[n][1], fmaxf(acc[m][1], acc[m][3]));
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = rm[m][h];
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
        const int r = mp + 16 * m + g + 8 * h;
        if (cq == 0 && r < P) {
          float* o = rowmax + (size_t)t * P + r;
          *o = c0 == 0 ? v : fmaxf(*o, v);
        }
      }
  }
  float* cb = colbuf + (threadIdx.x >> 5) * kRC;
#pragma unroll
  for (int n = 0; n < kRC / 8; ++n) {
    if (n >= nn) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = cm[n][h];
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
      if (g == 0) cb[n * 8 + 2 * cq + h] = v;
    }
  }
  __syncwarp();
  if (lane == 0) {
    float s = c0 == 0 ? 0.f : csum[t];
    for (int c = 0; c < nc; ++c) s = s + fmaxf(cb[c], 0.f);
    csum[t] = s;
  }
  __syncwarp();
}

template <class RT>
__global__ void __launch_bounds__(kThreads, 2) minu_screen_tc_kernel(
    const bf16* __restrict__ ldes, const float* __restrict__ lvalid,
    const RT* __restrict__ rdes, const float* __restrict__ rvalid,
    float* __restrict__ out, int NT, int P, int B, int R, int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* es = reinterpret_cast<bf16*>(smem);  // [kRC][kLdE]
  float* rowmax = reinterpret_cast<float*>(es + kRC * kLdE);  // [NT][P]
  float* csum = rowmax + (size_t)NT * P;                      // [NT]
  float* colbuf = csum + NT;                                  // [kWarps][kRC]
  const int b = blockIdx.x, tid = threadIdx.x, warp = tid >> 5;
  for (int i = tid; i < kRC * kLdE / 8; i += kThreads)
    reinterpret_cast<uint4*>(es)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int c0 = 0; c0 < R; c0 += kRC) {
    const int nc = min(kRC, R - c0);
    __syncthreads();     // the zeroing, or the last chunk's readers
    stage_entry(es, rdes, rvalid, b, c0, nc, R, D);
    __syncthreads();
    for (int t = warp; t < NT; t += kWarps)
      sweep_template(ldes, lvalid, es, rowmax, csum, colbuf, t, P, D, c0,
                     nc);
  }
  __syncthreads();
  for (int t = tid; t < NT; t += kThreads) {
    float s = 0.f;
    for (int p = 0; p < P; ++p) s = s + fmaxf(rowmax[(size_t)t * P + p], 0.f);
    out[(size_t)t * B + b] = fminf(s, csum[t]);
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
  if (ltype == afis_t::kBF16) {
    if (D > afis_mma::kMaxKSteps * afis_mma::kK)
      return (int)cudaErrorInvalidValue;
    const size_t bytes = kRC * kLdE * sizeof(bf16)
        + ((size_t)NT * P + NT + kWarps * kRC) * sizeof(float);
    const auto run = [&](auto rt) {
      using RT = typename decltype(rt)::type;
      cudaError_t e = cudaFuncSetAttribute(
          minu_screen_tc_kernel<RT>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (e != cudaSuccess) return (int)e;
      minu_screen_tc_kernel<RT>
          <<<B, kThreads, bytes, (cudaStream_t)stream>>>(
              static_cast<const bf16*>(ldes), lvalid,
              static_cast<const RT*>(rdes), rvalid, out, NT, P, B, R, D);
      return (int)cudaGetLastError();
    };
    if (rtype == afis_t::kBF16) return run(afis_t::Tag<bf16>{});
    if (rtype == afis_t::kI8) return run(afis_t::Tag<int8_t>{});
    return (int)cudaErrorInvalidValue;
  }
  if (ltype != afis_t::kF32) return (int)cudaErrorInvalidValue;
  if (rtype == afis_t::kF32)
    return launch_screen<float, float, false>(ldes, lvalid, rdes, rvalid,
                                              out, NT, P, B, R, D, stream);
  if (rtype == afis_t::kI8)
    return launch_screen<float, int8_t, false>(ldes, lvalid, rdes, rvalid,
                                               out, NT, P, B, R, D, stream);
  return (int)cudaErrorInvalidValue;
}
