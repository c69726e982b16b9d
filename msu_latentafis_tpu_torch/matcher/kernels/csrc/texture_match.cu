// Texture-match tail: top-K rows of the ADC maxima, then the graph filter.
//
// Replaces the JAX package's pallas_kernels.py fused_texture_match (:1031)
// / _make_texture_match_kernel (:939) / _select_slots_batched (:612). One
// thread block per (latent, gallery entry):
//   1. invalid latent rows -> -1e4; bisect window [min valid - 1, max + 1];
//   2. 26 bisect steps, mid = 0.5 (lo + hi), keeping count(> lo) > K >=
//      count(> hi) (a sort would pick another set whenever two values fall
//      within one step, which near magnitude 10 is near f32 spacing), run
//      in registers on the (K + 1)-th largest value (a radix select,
//      filter_body.cuh kth_largest), with no block barrier in the steps;
//   3. values above hi take the first slots, the (lo, hi] band fills the
//      rest, each in latent-row order (block scans);
//   4. slot coordinates gathered from the [Lt, 4] / [R, 4] packs, tie key
//      value * [n_valid > K] (n_valid a block sum when every validity is 0
//      or 1, exact in any order; else thread 0 sums it in index order);
//   5. filter_run with the lookup distance, 3 power iterations.
//
// Bound: operations (the O(K^2) filter, K = 200); the block reads 3.6 KB.
// The time is one block's critical path (a dense launch of 256 blocks is
// one wave), which filter_body.cuh shortens. Its H1 table overlays the
// selection arrays once the slots are filled: a launch of more blocks than
// SMs takes the half table (K x 100 floats, 80 KB; a block ~112 KB of
// shared memory, two to an SM, so the dense launch stays one wave); a
// launch of at most one block per SM, as the rerank's, the full matrix
// (K x (K | 1) floats), whose reads cost one load at a fixed stride, where
// it fits the opt-in limit (K <= 219 on a 227 KB card), else the half table.
#include <algorithm>

#include "filter_body.cuh"

namespace {

using namespace afis;

inline int texture_region(int Lt, int K, bool full) {
  return std::max(4 * Lt, full ? h1_full_words(K) : h1_words(K));
}

__global__ void __launch_bounds__(kThreads) texture_match_kernel(
    const float* __restrict__ best, const int* __restrict__ bestj,
    const float* __restrict__ lvalid, const float* __restrict__ lpack,
    const float* __restrict__ rpack, float* __restrict__ out, int B, int Lt,
    int R, int K, int lookup, int dist_iters, int full, int region) {
  extern __shared__ uint32_t smem[];
  const float SENT = -1e4f;
  const int pair = blockIdx.x;                 // n * B + b
  const int n = pair / B, b = pair - n * B;
  float* red = reinterpret_cast<float*>(smem);             // [64]
  float* bm = red + 64;                                    // [Lt]
  int* bj = reinterpret_cast<int*>(bm + Lt);               // [Lt]
  int* rank_hi = bj + Lt;                                  // [Lt]
  int* rank_tie = rank_hi + Lt;                            // [Lt]
  // the H1 matrix or half table takes the place of bm .. rank_tie once the
  // slots are set
  Filter f = carve_filter(smem + 64 + region, K, 1, bm, full != 0);

  const size_t row = (size_t)pair * Lt;
  const float* lv = lvalid + (size_t)n * Lt;
  float vmin = 1e30f, vmax = -INFINITY, nvalid = 0.f;
  bool binary = true;
  for (int i = threadIdx.x; i < Lt; i += blockDim.x) {
    const float lvi = lv[i];
    const float v = lvi > 0.5f ? best[row + i] : SENT;
    bm[i] = v;
    bj[i] = bestj[row + i];
    vmin = fminf(vmin, v > SENT + 1.f ? v : 1e30f);
    vmax = fmaxf(vmax, v);
    nvalid += lvi;
    binary = binary && (lvi == 0.f || lvi == 1.f);
  }
  for (int off = 16; off > 0; off >>= 1)
    nvalid += __shfl_xor_sync(kFull, nvalid, off);
  binary = __all_sync(kFull, binary);
  float mn, mx;
  block_minmax(vmin, vmax, red, &mn, &mx);
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5] = nvalid;
    red[kWarps + (threadIdx.x >> 5)] = binary ? 1.f : 0.f;
  }
  __syncthreads();
  // spec candidate order (matcher.cpp:736-749)
  float s = 0.f;
  bool all_binary = true;
  for (int w = 0; w < kWarps; ++w) {
    s += red[w];
    all_binary = all_binary && red[kWarps + w] != 0.f;
  }
  if (!all_binary) {            // block-uniform: sum in index order
    if (threadIdx.x == 0) {
      float acc = 0.f;
      for (int i = 0; i < Lt; ++i) acc = acc + lv[i];
      red[2 * kWarps] = acc;
    }
    __syncthreads();
    s = red[2 * kWarps];
  }
  const float usef = s > (float)K ? 1.f : 0.f;

  float lo = fmaxf(mn - 1.f, SENT), hi = mx + 1.f;
  bisect_window(kth_largest(Lt, K, [&](int i) { return bm[i]; }, f.hist),
                lo, hi);
  const int n_hi = block_scan_count(Lt, [&](int i) { return bm[i] > hi; },
                                    rank_hi, f.hist);
  block_scan_count(Lt, [&](int i) { return bm[i] > lo && !(bm[i] > hi); },
                   rank_tie, f.hist);

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
  __syncthreads();
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
  // a launch of at most one block per SM (the rerank's 64 entries) keeps
  // the full H1 matrix where it fits; a larger one the half table, two
  // blocks an SM
  int dev = 0, sms = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return (int)e;
  auto words = [&](bool full) {
    return (size_t)(64 + texture_region(Lt, K, full) + filter_words(K));
  };
  const bool full =
      (long long)NL * B <= sms && words(true) * 4 <= (size_t)optin;
  const int region = texture_region(Lt, K, full);
  const size_t bytes = words(full) * 4;
  e = cudaFuncSetAttribute(texture_match_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e != cudaSuccess) return (int)e;
  texture_match_kernel<<<NL * B, kThreads, bytes, (cudaStream_t)stream>>>(
      best, bestj, lvalid, lpack, rpack, out, B, Lt, R, K, lookup,
      dist_iters, full, region);
  return (int)cudaGetLastError();
}
