// Standalone graph filter over pre-gathered correspondence sets, one thread
// block per set.
//
// Replaces the JAX package's pallas_kernels.py fused_graph_filter_packed
// (:456, pallas_call :483) and fused_graph_filter (:410, pallas_call :442),
// whose cos / sin packs the wrapper builds with torch ops as the JAX
// function does outside its pallas_call. Both run _filter_body (:189) over
// a [tile, K] block of sets; here one block runs filter_run (filter_body.cuh)
// over one set, with no tie keys (slot order breaks support ties, as in
// the JAX body called without tie1), and the bench hooks ``stages`` and
// ``stage2_cap`` of the JAX body.
//
// Bound: operations, O(K^2) pairwise tests per set against 45 bytes of
// operands per slot (K <= 256 slots, the 8 mask words of filter_body).
// The set's slot vectors and bit masks sit in shared memory (40 KB at
// K = 256), so several blocks share an SM.
#include "filter_body.cuh"

namespace {

using namespace afis;

__global__ void __launch_bounds__(kThreads) graph_filter_kernel(
    const float* __restrict__ val, const float* __restrict__ gl,
    const float* __restrict__ gr, const int* __restrict__ li,
    const int* __restrict__ ri, const unsigned char* __restrict__ valid,
    float* __restrict__ out, int K, int lookup, int dist_iters, int stages,
    int stage2_cap) {
  extern __shared__ uint32_t smem[];
  const int n = blockIdx.x;
  Filter f = carve_filter(smem, K, 0);
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const size_t s = (size_t)n * K + k;
    const float* lp = gl + s * 4;
    const float* rp = gr + s * 4;
    f.val[k] = val[s];
    f.lx[k] = lp[0]; f.ly[k] = lp[1]; f.lc[k] = lp[2]; f.ls[k] = lp[3];
    f.rx[k] = rp[0]; f.ry[k] = rp[1]; f.rc[k] = rp[2]; f.rs[k] = rp[3];
    f.li[k] = li[s];
    f.ri[k] = ri[s];
    f.vf[k] = valid[s] ? 1 : 0;
    f.tie0[k] = 0.f;
    f.tie1[k] = 0.f;
  }
  __syncthreads();
  const float score = filter_run(f, lookup != 0, dist_iters, stages,
                                 stage2_cap);
  if (threadIdx.x == 0) out[n] = score;
}

}  // namespace

extern "C" int afis_graph_filter_packed(
    const float* val, const float* gl, const float* gr, const int* li,
    const int* ri, const unsigned char* valid, float* out, int N, int K,
    int lookup, int dist_iters, int stages, int stage2_cap, void* stream) {
  if (N <= 0 || K <= 0 || K > kMaxK || dist_iters < 0 || stage2_cap < 0)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)filter_words(K) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      graph_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  graph_filter_kernel<<<N, kThreads, bytes, (cudaStream_t)stream>>>(
      val, gl, gr, li, ri, valid, out, K, lookup, dist_iters, stages,
      stage2_cap);
  return (int)cudaGetLastError();
}
