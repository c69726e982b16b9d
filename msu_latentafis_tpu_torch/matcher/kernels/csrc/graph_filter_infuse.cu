// Graph filter over a [NT, B] grid of correspondence sets with the operand
// gathers inside the kernel, one thread block per (template, entry).
//
// Replaces the JAX package's pallas_kernels.py fused_graph_filter_infuse
// (:551, pallas_call :594, body _make_filter_gather_kernel :494). The TPU
// kernel gathers the slot coordinates from the [4, P] / [4, R] coordinate
// planes, and with ``simi`` the weights val[k] = simi[li_k, ri_k], as
// one-hot matmuls on the MXU; here each thread loads its slots' values
// with plain indexed loads. An index outside [0, P) or [0, R) gathers
// zeros, as a one-hot row of zeros does. Then filter_run (filter_body.cuh)
// with no tie keys.
//
// Bound: operations, the O(K^2) filter per set; the gathers read 9 floats
// per slot (plus one of the [P, R] similarity block with ``simi``).
#include "filter_body.cuh"

namespace {

using namespace afis;

__global__ void __launch_bounds__(kThreads) graph_filter_infuse_kernel(
    const float* __restrict__ val, const int* __restrict__ li,
    const int* __restrict__ ri, const unsigned char* __restrict__ valid,
    const float* __restrict__ lpackT, const float* __restrict__ rpackT,
    const float* __restrict__ simi, float* __restrict__ out, int NT, int B,
    int K, int P, int R, int lookup, int dist_iters) {
  extern __shared__ uint32_t smem[];
  // template fastest: consecutive blocks share the entry's planes in L2
  const int t = blockIdx.x % NT, b = blockIdx.x / NT;
  const size_t set = (size_t)t * B + b;
  Filter f = carve_filter(smem, K, 0);
  const float* lp = lpackT + (size_t)t * 4 * P;
  const float* rp = rpackT + (size_t)b * 4 * R;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const size_t s = set * K + k;
    const int l = li[s], r = ri[s];
    const bool lin = l >= 0 && l < P, rin = r >= 0 && r < R;
    f.lx[k] = lin ? lp[l] : 0.f;
    f.ly[k] = lin ? lp[P + l] : 0.f;
    f.lc[k] = lin ? lp[2 * P + l] : 0.f;
    f.ls[k] = lin ? lp[3 * P + l] : 0.f;
    f.rx[k] = rin ? rp[r] : 0.f;
    f.ry[k] = rin ? rp[R + r] : 0.f;
    f.rc[k] = rin ? rp[2 * R + r] : 0.f;
    f.rs[k] = rin ? rp[3 * R + r] : 0.f;
    f.val[k] = simi == nullptr ? val[s]
        : (lin && rin ? simi[(set * P + l) * R + r] : 0.f);
    f.li[k] = l;
    f.ri[k] = r;
    f.vf[k] = valid[s] ? 1 : 0;
    f.tie0[k] = 0.f;
    f.tie1[k] = 0.f;
  }
  __syncthreads();
  const float score = filter_run(f, lookup != 0, dist_iters);
  if (threadIdx.x == 0) out[set] = score;
}

}  // namespace

// ``val`` or ``simi`` is null: the weights come from the other one.
extern "C" int afis_graph_filter_infuse(
    const float* val, const int* li, const int* ri,
    const unsigned char* valid, const float* lpackT, const float* rpackT,
    const float* simi, float* out, int NT, int B, int K, int P, int R,
    int lookup, int dist_iters, void* stream) {
  if (NT <= 0 || B <= 0 || K <= 0 || K > kMaxK || P <= 0 || R <= 0
      || dist_iters < 0 || (val == nullptr) == (simi == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)filter_words(K) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      graph_filter_infuse_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  graph_filter_infuse_kernel<<<NT * B, kThreads, bytes,
                               (cudaStream_t)stream>>>(
      val, li, ri, valid, lpackT, rpackT, simi, out, NT, B, K, P, R, lookup,
      dist_iters);
  return (int)cudaGetLastError();
}
