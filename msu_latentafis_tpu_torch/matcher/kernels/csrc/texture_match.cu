// Texture-match tail: top-K rows of the ADC maxima, then the graph filter.
//
// Replaces the JAX package's pallas_kernels.py fused_texture_match (:1031)
// / _make_texture_match_kernel (:939) / _select_slots_batched (:612). One
// thread block per (latent, gallery entry):
//   1. invalid latent rows -> -1e4; bisect window [min valid - 1, max + 1];
//   2. 26 bisect steps, mid = 0.5 (lo + hi), keeping count(> lo) > K >=
//      count(> hi) (a sort would pick another set whenever two values fall
//      within one step, which near magnitude 10 is near f32 spacing);
//   3. values above hi take the first slots, the (lo, hi] band fills the
//      rest, each in latent-row order (warp ballot scans);
//   4. slot coordinates gathered from the [Lt, 4] / [R, 4] packs, tie key
//      value * [n_valid > K];
//   5. filter_run with the lookup distance, 3 power iterations.
//
// Bound: operations (the O(K^2) filter, K = 200); the block reads 3.6 KB.
#include "filter_body.cuh"

namespace {

using namespace afis;

__host__ __device__ inline int texture_words(int Lt, int K) {
  return 64 + 4 * Lt + filter_words(K);
}

__global__ void __launch_bounds__(kThreads) texture_match_kernel(
    const float* __restrict__ best, const int* __restrict__ bestj,
    const float* __restrict__ lvalid, const float* __restrict__ lpack,
    const float* __restrict__ rpack, float* __restrict__ out, int B, int Lt,
    int R, int K, int lookup, int dist_iters) {
  extern __shared__ uint32_t smem[];
  const float SENT = -1e4f;
  const int pair = blockIdx.x;                 // n * B + b
  const int n = pair / B, b = pair - n * B;
  float* red = reinterpret_cast<float*>(smem);             // [64]
  float* bm = red + 64;                                    // [Lt]
  int* bj = reinterpret_cast<int*>(bm + Lt);               // [Lt]
  int* rank_hi = bj + Lt;                                  // [Lt]
  int* rank_tie = rank_hi + Lt;                            // [Lt]
  Filter f = carve_filter(smem + 64 + 4 * Lt, K, 1);

  const size_t row = (size_t)pair * Lt;
  float vmin = 1e30f, vmax = -INFINITY;
  for (int i = threadIdx.x; i < Lt; i += blockDim.x) {
    const float v = lvalid[(size_t)n * Lt + i] > 0.5f ? best[row + i] : SENT;
    bm[i] = v;
    bj[i] = bestj[row + i];
    vmin = fminf(vmin, v > SENT + 1.f ? v : 1e30f);
    vmax = fmaxf(vmax, v);
  }
  float mn, mx;
  block_minmax(vmin, vmax, red, &mn, &mx);

  float lo = fmaxf(mn - 1.f, SENT), hi = mx + 1.f;
  for (int it = 0; it < 26; ++it) {
    const float mid = 0.5f * (lo + hi);
    const int cnt = block_count(Lt, [&](int i) { return bm[i] > mid; });
    if (cnt > K) lo = mid; else hi = mid;
  }
  const int n_hi = scan_count(Lt, [&](int i) { return bm[i] > hi; },
                              rank_hi, f.iscratch);
  scan_count(Lt, [&](int i) { return bm[i] > lo && !(bm[i] > hi); },
             rank_tie, f.iscratch);

  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    f.val[k] = 0.f; f.li[k] = 0; f.ri[k] = 0; f.vf[k] = 0;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Lt; i += blockDim.x) {
    int k = -1;
    if (bm[i] > hi) k = rank_hi[i];
    else if (bm[i] > lo && rank_tie[i] < K - n_hi) k = n_hi + rank_tie[i];
    if (k >= 0) { f.val[k] = bm[i]; f.li[k] = i; f.ri[k] = bj[i]; f.vf[k] = 1; }
  }
  if (threadIdx.x == 0) {       // spec candidate order (matcher.cpp:736-749)
    float s = 0.f;
    for (int i = 0; i < Lt; ++i) s = s + lvalid[(size_t)n * Lt + i];
    f.scratch[2] = s > (float)K ? 1.f : 0.f;
  }
  __syncthreads();
  const float usef = f.scratch[2];
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float* lp = lpack + ((size_t)n * Lt + f.li[k]) * 4;
    const float* rp = rpack + ((size_t)b * R + f.ri[k]) * 4;
    f.lx[k] = lp[0]; f.ly[k] = lp[1]; f.lc[k] = lp[2]; f.ls[k] = lp[3];
    f.rx[k] = rp[0]; f.ry[k] = rp[1]; f.rc[k] = rp[2]; f.rs[k] = rp[3];
    f.tie0[k] = f.val[k] * usef;
    f.tie1[k] = 0.f;
  }
  __syncthreads();
  const float score = filter_run(f, lookup != 0, dist_iters);
  if (threadIdx.x == 0) out[pair] = score;
}

}  // namespace

extern "C" int afis_texture_match(const float* best, const int* bestj,
                                  const float* lvalid, const float* lpack,
                                  const float* rpack, float* out, int NL,
                                  int B, int Lt, int R, int K, int lookup,
                                  int dist_iters, void* stream) {
  if (NL <= 0 || B <= 0 || Lt <= 0 || R <= 0 || K <= 0 || K > kMaxK
      || K > Lt || dist_iters < 0)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)texture_words(Lt, K) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      texture_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  texture_match_kernel<<<NL * B, kThreads, bytes, (cudaStream_t)stream>>>(
      best, bestj, lvalid, lpack, rpack, out, B, Lt, R, K, lookup,
      dist_iters);
  return (int)cudaGetLastError();
}
