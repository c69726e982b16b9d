// Whole minutiae-template match, one thread block per (template, entry).
//
// Replaces the JAX package's pallas_kernels.py fused_minutiae_match (:878)
// / _make_minutiae_match_kernel (:682) / _select_slots_batched (:612):
//   1. simi = relu(ldes . rdes) * valid  ([P, R], D-long dots in index
//      order from shared-memory tiles);
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
// and the filter O(K^2) with K = 120, against 62 KB read. A launch of a
// few hundred pairs is one to three waves of blocks, so its time is one
// block's critical path; the design keeps every stage parallel over the
// block and every rounded operation in the plain version's order:
//   - the similarity: each warp computes 8 latent rows x up to 128 rolled
//     columns (lanes on columns, 8 x 4 sums in registers, the latent
//     values broadcast), so a shared load feeds up to 8 products; the
//     tiles load 16 bytes a thread and the sums read 16 bytes a load when
//     D is a multiple of 4 (tile rows of D + 4 floats, else D + 1); the
//     latent tile's rows are padded to a multiple of 8;
//   - the row and column sums read a [P, R] matrix whose row stride is odd
//     (no bank holds two rows' elements of one step); the sums stay serial
//     in index order, one thread per row or column, their terms fetched
//     ahead of the dependent adds;
//   - the extraction gives each latent row 8 lanes that hold its columns,
//     normalized as they load, in registers (R <= 128, shared store; else
//     one warp per row over its normalized values in shared memory, staged
//     there row by row in the workspace): a lane's
//     argmax, then a shuffle argmax whose ties go to the lower column, the
//     serial first-index scan's result exactly, rounds after a row runs
//     out of valid values included (they take column 0 again);
//   - the bisect runs in registers on the (K + 1)-th largest candidate
//     value, found by a radix select (filter_body.cuh kth_largest): no
//     block barrier in its 26 steps; the slot ranks are block scans;
//   - filter_run (filter_body.cuh) keeps the full H1 matrix in the dead
//     [P, R] region (K = 120: 57 KB), so a power-iteration step is one
//     shared load at a fixed stride.
// Two stores:
//   - shared (the pair fits in the 227 KB a block may opt in to, e.g. ~88 KB
//     at 64 / 96): simi, the descriptor tiles, and after them the
//     normalized matrix, the candidate table and the filter's vectors, all
//     in shared memory, one block per pair;
//   - workspace (a large print, up to the reference's 1000 rolled minutiae,
//     or a wide row_cap): simi, the normalized matrix, the sums and the
//     candidate table in a per-block slice of a global workspace that the
//     wrapper allocates on the launch's stream; the descriptors stream
//     through shared memory in 64 x 64 tiles, each tile's similarities are
//     summed into the row and column sums from shared memory as the tile
//     is written out, and the filter's vectors take the tiles' place. As
//     many blocks as the card holds at once walk the pairs.
// The band rank counts, per band member, the members of earlier latent rows
// (a prefix over rows) and those of its own row with a smaller column.
// Modes (dtypes.cuh): the latent descriptors are f32 or bf16 (any int8
// scale folded in), the gallery's the latent's type or int8; both widen to
// f32 as they enter the tiles, as the TPU kernel casts the gallery tile
// and accumulates in f32.
#include <algorithm>

#include "dtypes.cuh"
#include "filter_body.cuh"

// The graph filter's counts over every launch made with count != 0 since
// the last reset (filter_body.cuh's count_set).
__device__ unsigned long long g_minu_filter_counts[3];

namespace {

using namespace afis;
using afis_t::widen;

// Offsets (floats) of one pair's arrays: in shared memory, or in the
// block's workspace slice when ``global``.
struct MinuLayout {
  int global;
  int TP, TR;                 // descriptor tile rows (latent, rolled)
  int RS, TS;                 // row strides of simi / normm and of a tile
  int DP;                     // row stride of a descriptor tile
  int h1_full;                // H1 as the full matrix (else the half table)
  size_t smem_words, ws_words;
  size_t simi, normm, cv, cs, cr, rank_hi, rank_tie, rowsum, colsum, bandpre;
  size_t tiles, stile, filter, h1;    // shared memory
};

inline MinuLayout minu_layout(int P, int R, int D, int K, int row_cap,
                              size_t limit_words) {
  MinuLayout m;
  const size_t C = (size_t)row_cap * P;
  // a multiple of 4 (16-byte rows) when D is, else odd
  const int DP = m.DP = D % 4 == 0 ? D + 4 : D + 1;
  // shared: simi, then the descriptor tiles overlaid by everything after;
  // the H1 matrix (or, where that does not fit, its half table) overlays
  // simi and normm once the candidates are taken
  m.global = 0;
  m.TP = P;
  m.TR = R;
  m.RS = m.TS = R | 1;
  const size_t PR = (size_t)P * m.RS;
  m.simi = m.stile = m.h1 = 0;
  m.normm = PR;
  m.tiles = (PR + 3) & ~(size_t)3;
  for (m.h1_full = 1; m.h1_full >= 0; --m.h1_full) {
    m.cv = std::max(2 * PR, (size_t)(m.h1_full ? h1_full_words(K)
                                               : h1_words(K)));
    m.cs = m.cv + C;
    m.cr = m.cs + C;
    m.rank_hi = m.cr + C;
    m.rank_tie = m.rank_hi + C;
    m.rowsum = m.rank_tie + C;
    m.colsum = m.rowsum + P;
    m.bandpre = m.colsum + R;
    m.filter = m.bandpre + P;
    m.smem_words = std::max(m.tiles + (size_t)(((P + 7) & ~7) + R) * DP,
                            m.filter + filter_words(K));
    m.ws_words = 0;
    if (m.smem_words <= limit_words) return m;
  }
  // workspace: every per-pair array there; tiles and filter share memory
  m.global = 1;
  m.RS = R;
  m.simi = 0;
  m.normm = (size_t)P * R;
  m.cv = 2 * m.normm;
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
  auto tile_words = [&]() {
    return (size_t)(((m.TP + 7) & ~7) + m.TR) * DP
        + (size_t)m.TP * (m.TR | 1);
  };
  while (tile_words() > limit_words && m.TP + m.TR > 2) {
    m.TP = std::max(1, m.TP / 2);
    m.TR = std::max(1, m.TR / 2);
  }
  m.TS = m.TR | 1;
  m.tiles = m.filter = 0;
  m.stile = (size_t)(((m.TP + 7) & ~7) + m.TR) * DP;
  m.h1 = filter_words(K);
  m.h1_full = m.h1 + h1_full_words(K) <= limit_words;
  m.smem_words = std::max(tile_words(), m.h1 + (m.h1_full ? h1_full_words(K)
                                                          : h1_words(K)));
  return m;
}

// Similarities of latent tile rows 8g .. 8g + 7 against rolled tile rows
// c0 + 32c (c < NC; c0 = chunk start + lane), written to out[p * ostride +
// r] for the rows and columns inside the tile (np x nr). Each dot runs over
// d in index order, one rounding per product and per sum.
template <int NC>
__device__ __forceinline__ void sim_item(const float* lds, const float* rds,
                                         int DP, int D, int g, int c0,
                                         int np, int nr, float* out,
                                         int ostride, const float* lv,
                                         const float* rv) {
  const float* l0 = lds + g * 8 * DP;    // rows past np: padding, unused
  int ro[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) ro[c] = min(c0 + 32 * c, nr - 1) * DP;
  float acc[8][NC];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[q][c] = 0.f;
  for (int d = 0; d < D; ++d) {
    float l[8], r[NC];
#pragma unroll
    for (int q = 0; q < 8; ++q) l[q] = l0[q * DP + d];
#pragma unroll
    for (int c = 0; c < NC; ++c) r[c] = rds[ro[c] + d];
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        acc[q][c] = __fadd_rn(acc[q][c], __fmul_rn(l[q], r[c]));
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int p = g * 8 + q;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int r = c0 + 32 * c;
      if (p < np && r < nr)
        out[(size_t)p * ostride + r] = fmaxf(acc[q][c], 0.f) * (lv[p] * rv[r]);
    }
  }
}

// Four consecutive descriptors widened to f32, in one load.
__device__ __forceinline__ float4 widen4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 widen4(const afis_t::bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 widen4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}

// n rows of D descriptors from src (contiguous) into a tile of row stride
// DP, widened to f32; eight loads in flight per thread, of four values each
// when D and DP are multiples of 4.
template <class T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int n,
                                          int D, int DP) {
  if (D % 4 == 0 && DP % 4 == 0) {
    const int D4 = D / 4, total = n * D4;
    for (int base = threadIdx.x; base < total; base += 8 * kThreads) {
      float4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = base + u * kThreads;
        if (i < total) v[u] = widen4(src + 4 * i);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = base + u * kThreads;
        if (i < total) {
          const int r = i / D4;
          *reinterpret_cast<float4*>(dst + r * DP + 4 * (i - r * D4)) = v[u];
        }
      }
    }
    return;
  }
  const int total = n * D;
  for (int base = threadIdx.x; base < total; base += 8 * kThreads) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = base + u * kThreads;
      v[u] = i < total ? widen(src[i]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = base + u * kThreads;
      if (i < total) dst[(i / D) * DP + i % D] = v[u];
    }
  }
}

// sim_item with 16-byte shared loads (D and DP multiples of 4): four d
// steps per load, the sums still in d order.
template <int NC>
__device__ __forceinline__ void sim_item4(const float* lds, const float* rds,
                                          int DP, int D, int g, int c0,
                                          int np, int nr, float* out,
                                          int ostride, const float* lv,
                                          const float* rv) {
  const int DP4 = DP / 4;
  const float4* l0 = reinterpret_cast<const float4*>(lds) + g * 8 * DP4;
  const float4* r4 = reinterpret_cast<const float4*>(rds);
  int ro[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) ro[c] = min(c0 + 32 * c, nr - 1) * DP4;
  float acc[8][NC];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[q][c] = 0.f;
  for (int d4 = 0; d4 < D / 4; ++d4) {
    float4 l[8], r[NC];
#pragma unroll
    for (int q = 0; q < 8; ++q) l[q] = l0[q * DP4 + d4];
#pragma unroll
    for (int c = 0; c < NC; ++c) r[c] = r4[ro[c] + d4];
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float a = acc[q][c];
        a = __fadd_rn(a, __fmul_rn(l[q].x, r[c].x));
        a = __fadd_rn(a, __fmul_rn(l[q].y, r[c].y));
        a = __fadd_rn(a, __fmul_rn(l[q].z, r[c].z));
        acc[q][c] = __fadd_rn(a, __fmul_rn(l[q].w, r[c].w));
      }
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int p = g * 8 + q;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int r = c0 + 32 * c;
      if (p < np && r < nr)
        out[(size_t)p * ostride + r] = fmaxf(acc[q][c], 0.f) * (lv[p] * rv[r]);
    }
  }
}

template <int NC>
__device__ __forceinline__ void sim_item_any(const float* lds,
                                             const float* rds, int DP, int D,
                                             int g, int c0, int np, int nr,
                                             float* out, int ostride,
                                             const float* lv,
                                             const float* rv) {
  if (DP % 4 == 0)
    sim_item4<NC>(lds, rds, DP, D, g, c0, np, nr, out, ostride, lv, rv);
  else
    sim_item<NC>(lds, rds, DP, D, g, c0, np, nr, out, ostride, lv, rv);
}

// One np x nr tile of similarities, warp by warp: items of 8 latent rows x
// a chunk of 32 * cpl rolled columns (cpl <= 4 per lane).
__device__ inline void sim_tile(const float* lds, const float* rds, int DP,
                                int D, int np, int nr, float* out,
                                int ostride, const float* lv,
                                const float* rv) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cpl = min(4, (nr + 31) / 32), cw = 32 * cpl;
  const int ngr = (np + 7) / 8, ncc = (nr + cw - 1) / cw;
  for (int item = warp; item < ngr * ncc; item += kWarps) {
    const int g = item / ncc, cc = item - g * ncc;
    const int nc = min(cpl, (nr - cc * cw + 31) / 32);
    const int c0 = cc * cw + lane;
    if (nc == 4)
      sim_item_any<4>(lds, rds, DP, D, g, c0, np, nr, out, ostride, lv,
                        rv);
    else if (nc == 3)
      sim_item_any<3>(lds, rds, DP, D, g, c0, np, nr, out, ostride, lv,
                        rv);
    else if (nc == 2)
      sim_item_any<2>(lds, rds, DP, D, g, c0, np, nr, out, ostride, lv,
                        rv);
    else
      sim_item_any<1>(lds, rds, DP, D, g, c0, np, nr, out, ostride, lv,
                        rv);
  }
}

constexpr int kRegCols = 16;   // columns a lane holds in the register path

// One level of the argmax tree: entry k takes the larger of 2k and 2k + 1,
// the left (lower u) on ties.
template <int N>
__device__ __forceinline__ void argmax_level(float (&tv)[kRegCols],
                                             int (&tu)[kRegCols]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const bool t = tv[2 * k + 1] > tv[2 * k];
    tv[k] = t ? tv[2 * k + 1] : tv[2 * k];
    tu[k] = t ? tu[2 * k + 1] : tu[2 * k];
  }
}

// The largest v[u] and its u, the lowest u on ties.
__device__ __forceinline__ void lane_argmax(const float (&v)[kRegCols],
                                            float& bv, int& bu) {
  static_assert(kRegCols == 16, "the tree has four levels");
  float tv[kRegCols];
  int tu[kRegCols];
#pragma unroll
  for (int u = 0; u < kRegCols; ++u) { tv[u] = v[u]; tu[u] = u; }
  argmax_level<8>(tv, tu);
  argmax_level<4>(tv, tu);
  argmax_level<2>(tv, tu);
  argmax_level<1>(tv, tu);
  bv = tv[0];
  bu = tu[0];
}

// The largest (bv, bi) over the G lanes of an aligned group, the lower
// column on ties; every lane of the group ends with it.
__device__ __forceinline__ void group_argmax(float& bv, int& bi, int G) {
  for (int off = G / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, bv, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
  }
}

template <class LT, class RT>
__global__ void __launch_bounds__(kThreads, 2) minutiae_match_kernel(
    const LT* __restrict__ ldes, const float* __restrict__ lvalid,
    const RT* __restrict__ rdes, const float* __restrict__ rvalid,
    const float* __restrict__ lpack, const float* __restrict__ rpack,
    float* __restrict__ out, float* __restrict__ ws, const MinuLayout L,
    int NT, int P, int B, int R, int D, int K, int row_cap, int lookup,
    int dist_iters, unsigned long long* __restrict__ counts) {
  extern __shared__ uint32_t smem[];
  const float SENT = -3.f;
  const int C = row_cap * P, DP = L.DP, RS = L.RS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sm = reinterpret_cast<float*>(smem);
  float* arr = L.global ? ws + (size_t)blockIdx.x * L.ws_words : sm;
  float* simi = arr + L.simi;                              // [P, RS]
  float* normm = arr + L.normm;                            // [P, RS]
  float* cv = arr + L.cv;                                  // [C] values
  float* cs = arr + L.cs;                                  // [C] raw simi
  int* cr = reinterpret_cast<int*>(arr + L.cr);            // [C] columns
  int* rank_hi = reinterpret_cast<int*>(arr + L.rank_hi);  // [C]
  int* rank_tie = reinterpret_cast<int*>(arr + L.rank_tie);  // [C]
  float* rowsum = arr + L.rowsum;                          // [P]
  float* colsum = arr + L.colsum;                          // [R]
  int* bandpre = reinterpret_cast<int*>(arr + L.bandpre);  // [P]
  float* lds = sm + L.tiles;                               // [TP, DP]
  float* rds = lds + (size_t)((L.TP + 7) & ~7) * DP;       // [TR, DP]
  float* stile = sm + L.stile;                             // [TP, TS]

  // template fastest: consecutive pairs share the rolled entry in L2
  for (int pair = blockIdx.x; pair < NT * B; pair += gridDim.x) {
    const int t = pair % NT, b = pair / NT;
    const float* lv = lvalid + (size_t)t * P;
    const float* rv = rvalid + (size_t)b * R;

    // ---- 1. similarities (and, in the workspace, the sums tile by tile)
    for (int p0 = 0; p0 < P; p0 += L.TP) {
      const int np = min(L.TP, P - p0);
      __syncthreads();
      load_tile(lds, ldes + ((size_t)t * P + p0) * D, np, D, DP);
      for (int r0 = 0; r0 < R; r0 += L.TR) {
        const int nr = min(L.TR, R - r0);
        __syncthreads();
        load_tile(rds, rdes + ((size_t)b * R + r0) * D, nr, D, DP);
        __syncthreads();
        sim_tile(lds, rds, DP, D, np, nr, stile, L.TS, lv + p0, rv + r0);
        if (!L.global) continue;
        __syncthreads();
        // the tile to the workspace; the row sums continue over columns
        // r0 .., the column sums over rows p0 .., each in index order
        for (int p = warp; p < np; p += kWarps)
          for (int r = lane; r < nr; r += 32)
            simi[(size_t)(p0 + p) * RS + r0 + r] = stile[p * L.TS + r];
        for (int i = threadIdx.x; i < np + nr; i += blockDim.x) {
          if (i < np) {
            rowsum[p0 + i] = ordered_sum(
                nr, [&](int r) { return stile[i * L.TS + r]; },
                r0 == 0 ? 0.f : rowsum[p0 + i]);
          } else {
            const int r = i - np;
            colsum[r0 + r] = ordered_sum(
                np, [&](int p) { return stile[p * L.TS + r]; },
                p0 == 0 ? 0.f : colsum[r0 + r]);
          }
        }
      }
    }
    __syncthreads();

    // ---- 2. sums (shared store), 3. mutual normalization and extraction
    if (!L.global) {
      for (int i = threadIdx.x; i < P + R; i += blockDim.x) {
        if (i < P) {
          rowsum[i] = ordered_sum(
              R, [&](int r) { return simi[(size_t)i * RS + r]; });
        } else {
          const int r = i - P;
          colsum[r] = ordered_sum(
              P, [&](int p) { return simi[(size_t)p * RS + r]; });
        }
      }
      __syncthreads();
    }
    auto normalized = [&](int p, int r, float rsum, bool lok) {
      const float s = simi[(size_t)p * RS + r];
      const float nrm = s / (((rsum + colsum[r]) - s) + 1e-6f);
      return (lok && rv[r] > 0.5f) ? nrm : SENT;
    };
    if (!L.global && R <= kRegCols * 8) {
      // 8 lanes per latent row, each holding its columns lg + 8u
      // normalized in registers
      const int lg = lane & 7, sub = lane >> 3;
      for (int pb = warp * 4; pb < P; pb += kWarps * 4) {
        const int p = pb + sub;
        const bool act = p < P;
        const int pp = act ? p : 0;
        const float rsum = rowsum[pp];
        const bool lok = lv[pp] > 0.5f;
        float v[kRegCols];
#pragma unroll
        for (int u = 0; u < kRegCols; ++u) {
          const int r = lg + 8 * u;
          v[u] = act && r < R ? normalized(pp, r, rsum, lok) : -INFINITY;
        }
        for (int c = 0; c < row_cap; ++c) {
          float bv;
          int bi;
          lane_argmax(v, bv, bi);
          bi = lg + 8 * bi;
          group_argmax(bv, bi, 8);
          if (act && lg == 0) {
            cv[c * P + p] = bv;
            cr[c * P + p] = bi;
            cs[c * P + p] = simi[(size_t)p * RS + bi];
          }
#pragma unroll
          for (int u = 0; u < kRegCols; ++u)
            if (lg + 8 * u == bi) v[u] = SENT;
        }
      }
    } else {
      // one warp per latent row over its normalized values: in the
      // workspace, staged row by row in the warp's slice of the dead tile
      // space of shared memory where it fits; else normm
      const bool staged = L.global && (size_t)kWarps * R <= L.smem_words;
      if (!staged) {
        for (int p = warp; p < P; p += kWarps) {
          const float rsum = rowsum[p];
          const bool lok = lv[p] > 0.5f;
          for (int r = lane; r < R; r += 32)
            normm[(size_t)p * RS + r] = normalized(p, r, rsum, lok);
        }
        __syncthreads();
      }
      for (int p = warp; p < P; p += kWarps) {
        float* row = staged ? sm + (size_t)warp * R : normm + (size_t)p * RS;
        if (staged) {                  // eight loads in flight a lane
          const float rsum = rowsum[p];
          const bool lok = lv[p] > 0.5f;
          for (int r0 = lane; r0 < R; r0 += 256) {
            float x[8];
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (r0 + 32 * u < R) x[u] = normalized(p, r0 + 32 * u, rsum, lok);
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (r0 + 32 * u < R) row[r0 + 32 * u] = x[u];
          }
          __syncwarp();
        }
        for (int c = 0; c < row_cap; ++c) {
          float bv = -INFINITY;
          int bi = R;
          for (int r0 = lane; r0 < R; r0 += 256) {
            float x[8];
#pragma unroll
            for (int u = 0; u < 8; ++u)
              x[u] = r0 + 32 * u < R ? row[r0 + 32 * u] : -INFINITY;
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (x[u] > bv) { bv = x[u]; bi = r0 + 32 * u; }
          }
          group_argmax(bv, bi, 32);
          if (lane == 0) {
            cv[c * P + p] = bv;
            cr[c * P + p] = bi;
            row[bi] = SENT;
          }
          __syncwarp();
        }
        // the raw similarities of the row's candidates, off the rounds' path
        for (int c = lane; c < row_cap; c += 32)
          cs[c * P + p] = simi[(size_t)p * RS + cr[c * P + p]];
      }
    }
    __syncthreads();

    // ---- 4. the bisect on the (K + 1)-th largest value, the slot ranks
    Filter f = carve_filter(smem + L.filter, K, 2, sm + L.h1, L.h1_full);
    const float kth = kth_largest(C, K, [&](int i) { return cv[i]; }, f.hist);
    float lo = -1.f, hi = 1.0000001f;
    bisect_window(kth, lo, hi);
    const int n_hi = block_scan_count(C, [&](int i) { return cv[i] > hi; },
                                      rank_hi, f.hist);
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
    block_scan_excl(bandpre, P, f.hist);
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

    // ---- 5. the slots and the filter
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
    const float score = filter_run(f, lookup != 0, dist_iters, 6, 0,
                                   counts);
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
// ltype / rtype: the descriptors' type codes (dtypes.cuh). count != 0
// counts the graph filter's sets into g_minu_filter_counts.
extern "C" int afis_minutiae_match(const void* ldes, const float* lvalid,
                                   const void* rdes, const float* rvalid,
                                   const float* lpack, const float* rpack,
                                   float* out, float* ws, int ws_blocks,
                                   int NT, int P, int B, int R, int D, int K,
                                   int row_cap, int lookup, int dist_iters,
                                   int ltype, int rtype, int count,
                                   void* stream) {
  if (NT <= 0 || B <= 0 || dist_iters < 0
      || !valid_args(P, R, D, K, row_cap))
    return (int)cudaErrorInvalidValue;
  const MinuLayout L = minu_layout(P, R, D, K, row_cap, optin_limit_words());
  const size_t bytes = L.smem_words * 4;
  if (bytes > optin_limit_words() * 4
      || (L.global && (ws == nullptr || ws_blocks <= 0)))
    return (int)cudaErrorInvalidValue;
  const int grid = L.global ? std::min(ws_blocks, NT * B) : NT * B;
  unsigned long long* counts = nullptr;
  if (count) {
    const cudaError_t ce = cudaGetSymbolAddress(
        reinterpret_cast<void**>(&counts), g_minu_filter_counts);
    if (ce != cudaSuccess) return (int)ce;
  }
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
            NT, P, B, R, D, K, row_cap, lookup, dist_iters, counts);
    return (int)cudaGetLastError();
  });
}

// out [3] = the counts of g_minu_filter_counts: sets, sum of k_valid^2 and sum
// of n_stage1^2 (count_set in filter_body.cuh); reset != 0 zeroes them.
extern "C" int afis_minutiae_match_counts(long long* out, int reset) {
  unsigned long long h[3] = {0, 0, 0};
  cudaError_t e = cudaMemcpyFromSymbol(h, g_minu_filter_counts, sizeof h);
  if (e == cudaSuccess && reset) {
    const unsigned long long z[3] = {0, 0, 0};
    e = cudaMemcpyToSymbol(g_minu_filter_counts, z, sizeof z);
  }
  for (int i = 0; i < 3; ++i) out[i] = (long long)h[i];
  return (int)e;
}
