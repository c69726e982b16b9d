// Whole minutiae-template match, one thread block per (template, entry).
//
// Replaces the JAX package's pallas_kernels.py fused_minutiae_match (:878)
// / _make_minutiae_match_kernel (:682) / _select_slots_batched (:612):
//   1. simi = relu(ldes . rdes) * valid  ([P, R], D-long dots in index
//      order from shared-memory tiles, 4 latent rows per thread);
//   2. mutual normalization s / (((rowsum + colsum) - s) + 1e-6), invalid
//      pairs -> -3;
//   3. row_cap rounds of per-row max extraction (first index on ties) into
//      the [row_cap, P] candidate table;
//   4. one bisect over [-1, 1.0000001] (26 steps); values above hi take
//      the first slots in table order (extraction round, then latent row),
//      the (lo, hi] band fills the rest in the spec's flat-index order
//      p * R + r. (The TPU kernel fills the band in table order too; on
//      pairs with fewer than K positive similarities that picks other
//      zero-similarity candidates than the spec and moves the score.)
//   5. filter_run with the float distance, 5 power iterations, tie keys
//      (normalized value, -(li R + ri)).
// The top-K is exact whenever no latent row holds more than row_cap of it,
// which is the semantics of the TPU kernel (row_cap = R is always exact).
//
// Bound: operations. At P = 64, R = 96, D = 96 the similarity is 1.2 MFLOP
// and the filter O(K^2) with K = 120, against 62 KB read. The descriptor
// tiles (62 KB) are dead once simi exists, so the normalized matrix, the
// candidate table and the filter's vectors reuse their shared memory; the
// launcher opts in to the ~87 KB a block needs.
#include "filter_body.cuh"

namespace {

using namespace afis;

struct MinuLayout {
  int simi, u, a_words, b_words, filter_off;
};

__host__ __device__ inline MinuLayout minu_layout(int P, int R, int D, int K,
                                                  int row_cap) {
  MinuLayout m;
  const int C = row_cap * P;
  m.simi = P * R;
  m.a_words = (P + R) * (D + 1);                       // descriptor tiles
  m.filter_off = P * R + 5 * C + P + R;                // after phase-B data
  m.b_words = m.filter_off + filter_words(K);
  m.u = m.a_words > m.b_words ? m.a_words : m.b_words;
  return m;
}

__global__ void __launch_bounds__(kThreads) minutiae_match_kernel(
    const float* __restrict__ ldes, const float* __restrict__ lvalid,
    const float* __restrict__ rdes, const float* __restrict__ rvalid,
    const float* __restrict__ lpack, const float* __restrict__ rpack,
    float* __restrict__ out, int NT, int P, int B, int R, int D, int K,
    int row_cap, int lookup, int dist_iters) {
  extern __shared__ uint32_t smem[];
  const float SENT = -3.f;
  // template fastest: consecutive blocks share the rolled entry in L2
  const int t = blockIdx.x % NT, b = blockIdx.x / NT;
  const MinuLayout L = minu_layout(P, R, D, K, row_cap);
  const int C = row_cap * P, DP = D + 1;
  float* simi = reinterpret_cast<float*>(smem);            // [P, R]
  uint32_t* U = smem + L.simi;
  // phase A: descriptor tiles
  float* lds = reinterpret_cast<float*>(U);                // [P, DP]
  float* rds = lds + P * DP;                               // [R, DP]
  // phase B (overwrites phase A)
  float* normm = reinterpret_cast<float*>(U);              // [P, R]
  float* cv = normm + P * R;                               // [C] values
  float* cs = cv + C;                                      // [C] raw simi
  int* cr = reinterpret_cast<int*>(cs + C);                // [C] columns
  int* rank_hi = cr + C;                                   // [C]
  int* rank_tie = rank_hi + C;                             // [C]
  float* rowsum = reinterpret_cast<float*>(rank_tie + C);  // [P]
  float* colsum = rowsum + P;                              // [R]

  const float* lv = lvalid + (size_t)t * P;
  const float* rv = rvalid + (size_t)b * R;
  for (int idx = threadIdx.x; idx < P * D; idx += blockDim.x) {
    const int p = idx / D, d = idx - p * D;
    lds[p * DP + d] = ldes[((size_t)t * P + p) * D + d];
  }
  for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
    const int r = idx / D, d = idx - r * D;
    rds[r * DP + d] = rdes[((size_t)b * R + r) * D + d];
  }
  __syncthreads();

  const int PG = (P + 3) / 4;
  for (int item = threadIdx.x; item < PG * R; item += blockDim.x) {
    const int pg = item / R, r = item - pg * R;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < D; ++d) {
      const float rd = rds[r * DP + d];
      for (int q = 0; q < 4; ++q) {
        const int p = pg * 4 + q;
        if (p < P) acc[q] = __fadd_rn(acc[q], __fmul_rn(lds[p * DP + d], rd));
      }
    }
    for (int q = 0; q < 4; ++q) {
      const int p = pg * 4 + q;
      if (p < P) simi[p * R + r] = fmaxf(acc[q], 0.f) * (lv[p] * rv[r]);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < P + R; i += blockDim.x) {
    float s = 0.f;
    if (i < P) {
      for (int r = 0; r < R; ++r) s = s + simi[i * R + r];
      rowsum[i] = s;
    } else {
      const int r = i - P;
      for (int p = 0; p < P; ++p) s = s + simi[p * R + r];
      colsum[r] = s;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < P * R; idx += blockDim.x) {
    const int p = idx / R, r = idx - p * R;
    const float s = simi[idx];
    const float nrm = s / (((rowsum[p] + colsum[r]) - s) + 1e-6f);
    normm[idx] = (lv[p] > 0.5f && rv[r] > 0.5f) ? nrm : SENT;
  }
  __syncthreads();

  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    float* row = normm + p * R;
    for (int c = 0; c < row_cap; ++c) {
      float m = row[0];
      int am = 0;
      for (int r = 1; r < R; ++r)
        if (row[r] > m) { m = row[r]; am = r; }
      cv[c * P + p] = m;
      cr[c * P + p] = am;
      cs[c * P + p] = simi[p * R + am];
      row[am] = SENT;
    }
  }
  __syncthreads();

  float lo = -1.f, hi = 1.0000001f;
  for (int it = 0; it < 26; ++it) {
    const float mid = 0.5f * (lo + hi);
    const int cnt = block_count(C, [&](int i) { return cv[i] > mid; });
    if (cnt > K) lo = mid; else hi = mid;
  }
  Filter f = carve_filter(U + L.filter_off, K, 2);
  const int n_hi = scan_count(C, [&](int i) { return cv[i] > hi; },
                              rank_hi, f.iscratch);
  // the (lo, hi] band fills in the spec's candidate order, flat index
  // p * R + r (distinct within the band): rank = band members before it
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    if (!(cv[i] > lo) || cv[i] > hi) continue;
    const int fi = (i % P) * R + cr[i];
    int rank = 0;
    for (int j = 0; j < C; ++j)
      rank += (cv[j] > lo && !(cv[j] > hi) && (j % P) * R + cr[j] < fi);
    rank_tie[i] = rank;
  }
  __syncthreads();

  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    f.val[k] = 0.f; f.tie0[k] = 0.f; f.li[k] = 0; f.ri[k] = 0; f.vf[k] = 0;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    int k = -1;
    if (cv[i] > hi) k = rank_hi[i];
    else if (cv[i] > lo && rank_tie[i] < K - n_hi) k = n_hi + rank_tie[i];
    if (k >= 0) {
      f.val[k] = cs[i]; f.tie0[k] = cv[i];
      f.li[k] = i % P; f.ri[k] = cr[i]; f.vf[k] = 1;
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int l = f.li[k], r = f.ri[k];
    const float* lp = lpack + ((size_t)t * P + l) * 4;
    const float* rp = rpack + ((size_t)b * R + r) * 4;
    f.lx[k] = lp[0]; f.ly[k] = lp[1]; f.lc[k] = lp[2]; f.ls[k] = lp[3];
    f.rx[k] = rp[0]; f.ry[k] = rp[1]; f.rc[k] = rp[2]; f.rs[k] = rp[3];
    f.tie1[k] = -((float)l * (float)R + (float)r);   // spec flat index, negated
  }
  __syncthreads();
  const float score = filter_run(f, lookup != 0, dist_iters);
  if (threadIdx.x == 0) out[(size_t)t * B + b] = score;
}

}  // namespace

extern "C" int afis_minutiae_match(const float* ldes, const float* lvalid,
                                   const float* rdes, const float* rvalid,
                                   const float* lpack, const float* rpack,
                                   float* out, int NT, int P, int B, int R,
                                   int D, int K, int row_cap, int lookup,
                                   int dist_iters, void* stream) {
  if (NT <= 0 || P <= 0 || B <= 0 || R <= 0 || D <= 0 || K <= 0
      || K > kMaxK || K > P * R || row_cap <= 0 || dist_iters < 0)
    return (int)cudaErrorInvalidValue;
  const MinuLayout L = minu_layout(P, R, D, K, row_cap);
  const size_t bytes = (size_t)(L.simi + L.u) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      minutiae_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  minutiae_match_kernel<<<NT * B, kThreads, bytes, (cudaStream_t)stream>>>(
      ldes, lvalid, rdes, rvalid, lpack, rpack, out, NT, P, B, R, D, K,
      row_cap, lookup, dist_iters);
  return (int)cudaGetLastError();
}
