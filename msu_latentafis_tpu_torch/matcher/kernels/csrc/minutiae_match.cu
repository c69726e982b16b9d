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
// and the filter O(K^2) with K = 120, against 62 KB read. Two stores, one
// arithmetic:
//   - shared (the pair fits in the 227 KB a block may opt in to, e.g. ~87 KB
//     at 64 / 96): simi, the descriptor tiles, and after them the
//     normalized matrix, the candidate table and the filter's vectors, all
//     in shared memory, one block per pair;
//   - workspace (a large print, up to the reference's 1000 rolled minutiae,
//     or a wide row_cap): simi, the normalized matrix, the sums and the
//     candidate table in a per-block slice of a global workspace that the
//     wrapper allocates on the launch's stream; the descriptors stream
//     through shared memory in 64 x 64 tiles and the filter's vectors take
//     their place. As many blocks as the card holds at once walk the pairs.
// The band rank counts, per band member, the members of earlier latent rows
// (a prefix over rows) and those of its own row with a smaller column.
// Modes (dtypes.cuh): the latent descriptors are f32 or bf16 (any int8
// scale folded in), the gallery's the latent's type or int8; both widen to
// f32 as they enter the tiles, as the TPU kernel casts the gallery tile
// and accumulates in f32.
#include <algorithm>

#include "dtypes.cuh"
#include "filter_body.cuh"

namespace {

using namespace afis;
using afis_t::widen;

// Offsets (floats) of one pair's arrays: in shared memory, or in the
// block's workspace slice when ``global``.
struct MinuLayout {
  int global;
  int TP, TR;                 // descriptor tile rows (latent, rolled)
  size_t smem_words, ws_words;
  size_t simi, normm, cv, cs, cr, rank_hi, rank_tie, rowsum, colsum, bandpre;
  size_t tiles, filter;       // shared memory
};

inline MinuLayout minu_layout(int P, int R, int D, int K, int row_cap,
                              size_t limit_words) {
  MinuLayout m;
  const size_t C = (size_t)row_cap * P, PR = (size_t)P * R;
  const int DP = D + 1;
  // shared: simi, then the descriptor tiles overlaid by everything after
  m.global = 0;
  m.TP = P;
  m.TR = R;
  m.simi = 0;
  m.tiles = m.normm = PR;
  m.cv = m.normm + PR;
  m.cs = m.cv + C;
  m.cr = m.cs + C;
  m.rank_hi = m.cr + C;
  m.rank_tie = m.rank_hi + C;
  m.rowsum = m.rank_tie + C;
  m.colsum = m.rowsum + P;
  m.bandpre = m.colsum + R;
  m.filter = m.bandpre + P;
  m.smem_words = PR + std::max((size_t)(P + R) * DP,
                               m.filter - PR + filter_words(K));
  m.ws_words = 0;
  if (m.smem_words <= limit_words) return m;
  // workspace: every per-pair array there; tiles and filter share memory
  m.global = 1;
  m.simi = 0;
  m.normm = PR;
  m.cv = 2 * PR;
  m.cs = m.cv + C;
  m.cr = m.cs + C;
  m.rank_hi = m.cr + C;
  m.rank_tie = m.rank_hi + C;
  m.rowsum = m.rank_tie + C;
  m.colsum = m.rowsum + P;
  m.bandpre = m.colsum + R;
  m.ws_words = m.bandpre + P;
  m.TP = std::min(P, 64);
  m.TR = std::min(R, 64);
  while ((size_t)(m.TP + m.TR) * DP > limit_words && m.TP + m.TR > 2) {
    m.TP = std::max(1, m.TP / 2);
    m.TR = std::max(1, m.TR / 2);
  }
  m.tiles = m.filter = 0;
  m.smem_words = std::max((size_t)(m.TP + m.TR) * DP,
                          (size_t)filter_words(K));
  return m;
}

template <class LT, class RT>
__global__ void __launch_bounds__(kThreads) minutiae_match_kernel(
    const LT* __restrict__ ldes, const float* __restrict__ lvalid,
    const RT* __restrict__ rdes, const float* __restrict__ rvalid,
    const float* __restrict__ lpack, const float* __restrict__ rpack,
    float* __restrict__ out, float* __restrict__ ws, const MinuLayout L,
    int NT, int P, int B, int R, int D, int K, int row_cap, int lookup,
    int dist_iters) {
  extern __shared__ uint32_t smem[];
  const float SENT = -3.f;
  const int C = row_cap * P, DP = D + 1;
  float* sm = reinterpret_cast<float*>(smem);
  float* arr = L.global ? ws + (size_t)blockIdx.x * L.ws_words : sm;
  float* simi = arr + L.simi;                              // [P, R]
  float* normm = arr + L.normm;                            // [P, R]
  float* cv = arr + L.cv;                                  // [C] values
  float* cs = arr + L.cs;                                  // [C] raw simi
  int* cr = reinterpret_cast<int*>(arr + L.cr);            // [C] columns
  int* rank_hi = reinterpret_cast<int*>(arr + L.rank_hi);  // [C]
  int* rank_tie = reinterpret_cast<int*>(arr + L.rank_tie);  // [C]
  float* rowsum = arr + L.rowsum;                          // [P]
  float* colsum = arr + L.colsum;                          // [R]
  int* bandpre = reinterpret_cast<int*>(arr + L.bandpre);  // [P]
  float* lds = sm + L.tiles;                               // [TP, DP]
  float* rds = lds + (size_t)L.TP * DP;                    // [TR, DP]

  // template fastest: consecutive pairs share the rolled entry in L2
  for (int pair = blockIdx.x; pair < NT * B; pair += gridDim.x) {
    const int t = pair % NT, b = pair / NT;
    const float* lv = lvalid + (size_t)t * P;
    const float* rv = rvalid + (size_t)b * R;

    for (int p0 = 0; p0 < P; p0 += L.TP) {
      const int np = min(L.TP, P - p0);
      __syncthreads();
      for (int idx = threadIdx.x; idx < np * D; idx += blockDim.x) {
        const int p = idx / D, d = idx - p * D;
        lds[p * DP + d] = widen(ldes[((size_t)t * P + p0 + p) * D + d]);
      }
      for (int r0 = 0; r0 < R; r0 += L.TR) {
        const int nr = min(L.TR, R - r0);
        __syncthreads();
        for (int idx = threadIdx.x; idx < nr * D; idx += blockDim.x) {
          const int r = idx / D, d = idx - r * D;
          rds[r * DP + d] = widen(rdes[((size_t)b * R + r0 + r) * D + d]);
        }
        __syncthreads();
        const int PG = (np + 3) / 4;
        for (int item = threadIdx.x; item < PG * nr; item += blockDim.x) {
          const int pg = item / nr, r = item - pg * nr;
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          for (int d = 0; d < D; ++d) {
            const float rd = rds[r * DP + d];
            for (int q = 0; q < 4; ++q) {
              const int p = pg * 4 + q;
              if (p < np)
                acc[q] = __fadd_rn(acc[q], __fmul_rn(lds[p * DP + d], rd));
            }
          }
          for (int q = 0; q < 4; ++q) {
            const int p = pg * 4 + q;
            if (p < np)
              simi[(size_t)(p0 + p) * R + r0 + r] =
                  fmaxf(acc[q], 0.f) * (lv[p0 + p] * rv[r0 + r]);
          }
        }
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < P + R; i += blockDim.x) {
      float s = 0.f;
      if (i < P) {
        for (int r = 0; r < R; ++r) s = s + simi[(size_t)i * R + r];
        rowsum[i] = s;
      } else {
        const int r = i - P;
        for (int p = 0; p < P; ++p) s = s + simi[(size_t)p * R + r];
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
      float* row = normm + (size_t)p * R;
      for (int c = 0; c < row_cap; ++c) {
        float m = row[0];
        int am = 0;
        for (int r = 1; r < R; ++r)
          if (row[r] > m) { m = row[r]; am = r; }
        cv[c * P + p] = m;
        cr[c * P + p] = am;
        cs[c * P + p] = simi[(size_t)p * R + am];
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
    Filter f = carve_filter(smem + L.filter, K, 2);
    const int n_hi = scan_count(C, [&](int i) { return cv[i] > hi; },
                                rank_hi, f.iscratch);
    // the (lo, hi] band fills in the spec's candidate order, flat index
    // p * R + r (distinct within the band): rank = band members of earlier
    // latent rows + those of its own row with a smaller column
    auto in_band = [&](int i) { return cv[i] > lo && !(cv[i] > hi); };
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      int n = 0;
      for (int c = 0; c < row_cap; ++c) n += in_band(c * P + p);
      bandpre[p] = n;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int run = 0;
      for (int p = 0; p < P; ++p) {
        const int n = bandpre[p];
        bandpre[p] = run;
        run += n;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < C; i += blockDim.x) {
      if (!in_band(i)) continue;
      const int p = i % P, r = cr[i];
      int rank = bandpre[p];
      for (int c = 0; c < row_cap; ++c) {
        const int j = c * P + p;
        rank += in_band(j) && cr[j] < r;
      }
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
}

size_t optin_limit_words() {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&limit,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev) != cudaSuccess)
    return 0;
  return (size_t)limit / 4;
}

bool valid_args(int P, int R, int D, int K, int row_cap) {
  return P > 0 && R > 0 && D > 0 && K > 0 && K <= kMaxK
      && (long long)K <= (long long)P * R && row_cap > 0;
}

}  // namespace

// Workspace floats per block a launch at these sizes needs: 0 when a pair
// fits in shared memory, -1 for arguments no launch takes.
extern "C" long long afis_minutiae_match_workspace(int P, int R, int D,
                                                   int K, int row_cap) {
  if (!valid_args(P, R, D, K, row_cap)) return -1;
  const MinuLayout L = minu_layout(P, R, D, K, row_cap, optin_limit_words());
  return L.global ? (long long)L.ws_words : 0;
}

// Blocks of the workspace store the card runs at once (the grid of such a
// launch and the number of workspace slices) for the descriptor types
// ltype / rtype (dtypes.cuh); 0 on error.
extern "C" int afis_minutiae_match_blocks(int P, int R, int D, int K,
                                          int row_cap, int ltype, int rtype) {
  if (!valid_args(P, R, D, K, row_cap) || !afis_t::valid_pair(ltype, rtype))
    return 0;
  const MinuLayout L = minu_layout(P, R, D, K, row_cap, optin_limit_words());
  const size_t bytes = L.smem_words * 4;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
          != cudaSuccess)
    return 0;
  const int per_sm = afis_t::dispatch_pair(ltype, rtype, [&](auto lt,
                                                             auto rt) {
    using LT = typename decltype(lt)::type;
    using RT = typename decltype(rt)::type;
    int n = 0;
    if (cudaFuncSetAttribute(minutiae_match_kernel<LT, RT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes) != cudaSuccess
        || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &n, minutiae_match_kernel<LT, RT>, kThreads, bytes)
            != cudaSuccess)
      return 0;
    return n;
  });
  return per_sm * sms;
}

// ``ws`` holds ``ws_blocks`` slices of afis_minutiae_match_workspace()
// floats when that is not 0 (the grid is then ws_blocks); else it is unused.
// ltype / rtype: the descriptors' type codes (dtypes.cuh).
extern "C" int afis_minutiae_match(const void* ldes, const float* lvalid,
                                   const void* rdes, const float* rvalid,
                                   const float* lpack, const float* rpack,
                                   float* out, float* ws, int ws_blocks,
                                   int NT, int P, int B, int R, int D, int K,
                                   int row_cap, int lookup, int dist_iters,
                                   int ltype, int rtype, void* stream) {
  if (NT <= 0 || B <= 0 || dist_iters < 0
      || !valid_args(P, R, D, K, row_cap))
    return (int)cudaErrorInvalidValue;
  const MinuLayout L = minu_layout(P, R, D, K, row_cap, optin_limit_words());
  const size_t bytes = L.smem_words * 4;
  if (bytes > optin_limit_words() * 4
      || (L.global && (ws == nullptr || ws_blocks <= 0)))
    return (int)cudaErrorInvalidValue;
  const int grid = L.global ? std::min(ws_blocks, NT * B) : NT * B;
  return afis_t::dispatch_pair(ltype, rtype, [&](auto lt, auto rt) {
    using LT = typename decltype(lt)::type;
    using RT = typename decltype(rt)::type;
    cudaError_t e = cudaFuncSetAttribute(
        minutiae_match_kernel<LT, RT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    minutiae_match_kernel<LT, RT>
        <<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
            static_cast<const LT*>(ldes), lvalid,
            static_cast<const RT*>(rdes), rvalid, lpack, rpack, out, ws, L,
            NT, P, B, R, D, K, row_cap, lookup, dist_iters);
    return (int)cudaGetLastError();
  });
}
