// Graph-consistency filter over one correspondence set, run by one thread
// block, and the block-wide selection helpers of the two match kernels.
// Shared by texture_match.cu, minutiae_match.cu, graph_filter.cu and
// graph_filter_infuse.cu.
//
// Replaces the JAX package's pallas_kernels.py helpers _filter_body (:189),
// _greedy_rounds (:116), _power_iter (:162) and _blockers (:170). The plain
// specification is matcher/graph_filter.py; both take every sum in index
// order and every product and sum as its own rounding (the library is built
// with --fmad=false), so the two agree bit for bit.
//
// Bound: operations. Per set the work is O(K^2) pairwise tests for
// K <= 200 slots, far more than the few KB the set reads. What costs time
// on Hopper is one block's critical path, so the design removes recomputed
// work, serial sections and block barriers from it:
//   - H1 is computed once per set into shared memory. H1(a, b) equals
//     H1(b, a) bit for bit (the operands differ only by sign before fabsf
//     or squaring), so each pair is evaluated once: into the full K x (K
//     | 1) matrix where the caller has room (a power-iteration step is
//     then one load at a fixed stride), else into a circulant half table
//     of K x S floats, row i holding the pairs (i, i + d mod K) for d = 1
//     .. K / 2. A half-table read falls on row i (stride 1) or on row j
//     (stride S - 1, odd), so a warp's 32 rows meet at most two to a bank;
//     the row sums read it with a running index between the three zones
//     where a warp's rows switch rows (h1_row_dot). The row sums stay
//     serial in index order, one thread per row, their terms fetched ahead
//     of the dependent adds.
//   - The greedy selection (greedy()) sorts the candidates by the greedy
//     order (a bitonic sort in registers, the in-warp exchanges by
//     shuffles), builds the blockers in rank space (one warp per rank, a
//     ballot per word) and decides the ranks in order in one warp, 32 at a
//     time: a candidate is selected when none of its blockers is, the
//     unique fixpoint of the plain version's parallel rounds (a candidate's
//     blockers all precede it), with no block barrier per round.
//   - The stage-2 angle matrix is built on the pairs b > a and mirrored
//     (the test is symmetric but where exactly one side's points coincide,
//     which are tested directly), one warp per row with ballots.
// H2 and the blockers are K x K bit masks (8 KB each at K = 256). Stage 2
// runs on the compacted list of stage-1 survivors; dropping the
// non-survivor slots removes only zero terms from its sums and keeps the
// rank order, so the result equals the uncompacted body.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ordered_sum.cuh"

namespace afis {

using afis_sum::ordered_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 256;
constexpr int kHist = 256;              // radix-select bins (8-bit digits)
constexpr unsigned kFull = 0xffffffffu;
constexpr float kCosPi4 = (float)0.7071067811865476;   // float32(cos(pi/4))
constexpr float kCosPi6 = (float)0.8660254037844387;   // float32(cos(pi/6))

// Slot vectors and masks of one set, carved from dynamic shared memory;
// the H1 table is carved by the caller (it may overlay dead arrays).
struct Filter {
  int K, ntie;
  int h1_full;                                     // h1: [K, K | 1] matrix
  float *scratch;                                  // [8]
  float *val, *lx, *ly, *lc, *ls, *rx, *ry, *rc, *rs;
  float *tie0, *tie1;                              // stage-1 tie keys
  float *s1, *b, *c;                               // supports, power vectors
  float *cosv, *sinv, *key0, *key1, *key2;         // compacted stage 2
  float *clx, *cly, *crx, *cry;
  float *h1;                                       // [K, h1_stride(K)]
  int *li, *ri, *cidx, *pos, *ord;
  int *hist;                                       // [kHist + 8] scratch
  unsigned char *vf, *elig;
  uint32_t *blk, *h2, *sel;                        // bit masks
};

// Row stride of the H1 table: >= K / 2 and even, so that S - 1 is odd.
__host__ __device__ inline int h1_stride(int K) {
  const int half = K / 2;
  return half + (half & 1);
}

__host__ __device__ inline int h1_words(int K) { return K * h1_stride(K); }

// The full matrix, rows of K | 1 floats (odd: conflict-free columns).
__host__ __device__ inline int h1_full_words(int K) { return K * (K | 1); }

__host__ __device__ inline int filter_words(int K) {
  const int W = (K + 31) / 32;
  return 8 + 23 * K + 5 * K + kHist + 8 + (2 * K + 3) / 4 + 2 * K * W + W;
}

// One set's shared memory when a block holds nothing else: the full H1
// matrix where two blocks still fit on an SM (K <= 160), else the half
// table.
__host__ __device__ inline bool h1_full(int K) {
  return filter_words(K) + h1_full_words(K) <= 28 * 1024;
}

__host__ __device__ inline int set_words(int K) {
  return filter_words(K) + (h1_full(K) ? h1_full_words(K) : h1_words(K));
}

__device__ inline Filter carve_filter(uint32_t* base, int K, int ntie,
                                      float* h1, bool h1_full = false) {
  const int W = (K + 31) / 32;
  Filter f;
  f.K = K;
  f.ntie = ntie;
  f.h1 = h1;
  f.h1_full = h1_full;
  f.scratch = reinterpret_cast<float*>(base);
  float* p = reinterpret_cast<float*>(base + 8);
  f.val = p;  p += K;  f.lx = p;   p += K;  f.ly = p;   p += K;
  f.lc = p;   p += K;  f.ls = p;   p += K;  f.rx = p;   p += K;
  f.ry = p;   p += K;  f.rc = p;   p += K;  f.rs = p;   p += K;
  f.tie0 = p; p += K;  f.tie1 = p; p += K;  f.s1 = p;   p += K;
  f.b = p;    p += K;  f.c = p;    p += K;  f.cosv = p; p += K;
  f.sinv = p; p += K;  f.key0 = p; p += K;  f.key1 = p; p += K;
  f.key2 = p; p += K;  f.clx = p;  p += K;  f.cly = p;  p += K;
  f.crx = p;  p += K;  f.cry = p;  p += K;             // 23 float vectors
  int* q = reinterpret_cast<int*>(p);
  f.li = q; q += K;
  f.ri = q; q += K;
  f.cidx = q; q += K;
  f.pos = q; q += K;
  f.ord = q; q += K;
  f.hist = q; q += kHist + 8;
  unsigned char* u = reinterpret_cast<unsigned char*>(q);
  f.vf = u;
  f.elig = u + K;
  uint32_t* m = reinterpret_cast<uint32_t*>(q) + (2 * K + 3) / 4;
  f.blk = m; m += K * W;
  f.h2 = m; m += K * W;
  f.sel = m;
  return f;
}

// ---------------------------------------------------------------------------
// warp and block helpers (every thread of the block must call the block
// ones; blockDim.x == kThreads)

__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

// Exclusive prefix count of pred in index order into pos[i] (written where
// pred(i) holds); returns the total. Each warp scans one contiguous chunk
// with ballots, after a first pass that counts the chunks. red: >= kWarps.
template <class Pred>
__device__ int block_scan_count(int n, const Pred& pred, int* pos, int* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per = ((n + kWarps - 1) / kWarps + 31) & ~31;
  const int beg = min(n, warp * per), end = min(n, beg + per);
  int tot = 0;
  for (int base = beg; base < end; base += 32) {
    const int i = base + lane;
    tot += __popc(__ballot_sync(kFull, i < end && pred(i)));
  }
  if (lane == 0) red[warp] = tot;
  __syncthreads();
  int run = 0, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    run += w < warp ? red[w] : 0;
    all += red[w];
  }
  for (int base = beg; base < end; base += 32) {
    const int i = base + lane;
    const bool p = i < end && pred(i);
    const unsigned m = __ballot_sync(kFull, p);
    if (p) pos[i] = run + __popc(m & ((1u << lane) - 1u));
    run += __popc(m);
  }
  __syncthreads();
  return all;
}

// In-place exclusive prefix sum of the ints a[0, n); returns the total.
__device__ inline int block_scan_excl(int* a, int n, int* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per = ((n + kWarps - 1) / kWarps + 31) & ~31;
  const int beg = min(n, warp * per), end = min(n, beg + per);
  int tot = 0;
  for (int base = beg; base < end; base += 32) {
    const int i = base + lane;
    int v = i < end ? a[i] : 0;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    tot += v;
  }
  if (lane == 0) red[warp] = tot;
  __syncthreads();
  int run = 0, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    run += w < warp ? red[w] : 0;
    all += red[w];
  }
  for (int base = beg; base < end; base += 32) {
    const int i = base + lane;
    const int v = i < end ? a[i] : 0;
    const int incl = warp_incl_scan(v);
    if (i < end) a[i] = run + incl - v;
    run += __shfl_sync(kFull, incl, 31);
  }
  __syncthreads();
  return all;
}

// Block-wide min and max of one value per thread (red: >= 64 floats).
__device__ inline void block_minmax(float vmin, float vmax, float* red,
                                    float* out_min, float* out_max) {
  for (int off = 16; off > 0; off >>= 1) {
    vmin = fminf(vmin, __shfl_xor_sync(kFull, vmin, off));
    vmax = fmaxf(vmax, __shfl_xor_sync(kFull, vmax, off));
  }
  const int warp = threadIdx.x >> 5, nwarps = (blockDim.x + 31) >> 5;
  if ((threadIdx.x & 31) == 0) { red[warp] = vmin; red[32 + warp] = vmax; }
  __syncthreads();
  float a = red[0], b = red[32];
  for (int w = 1; w < nwarps; ++w) { a = fminf(a, red[w]); b = fmaxf(b, red[32 + w]); }
  __syncthreads();
  *out_min = a;
  *out_max = b;
}

// Total order on floats as unsigned keys (-0 just below +0); NaN is 0, the
// bottom, where no "v > mid" can count it.
__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t u = __float_as_uint(x);
  if (x != x) return 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// The (k + 1)-th largest of v(0), ..., v(n - 1) (k counted from 0), NaN
// when n <= k. count(v > mid) > k holds exactly when this value is > mid,
// so a bisect that keeps count(> lo) > k >= count(> hi) can run on it in
// registers. A radix select over the order keys, 8 bits a pass: each pass
// histograms the values whose higher digits match (warp-aggregated shared
// atomics) and one warp finds the digit that holds the target.
// hist: >= kHist + 2 ints.
template <class V>
__device__ float kth_largest(int n, int k, const V& v, int* hist) {
  if (n <= k) return __int_as_float(0x7fffffff);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t prefix = 0u, pmask = 0u;
  int t = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < kHist; i += blockDim.x) hist[i] = 0;
    __syncthreads();
    for (int base = 0; base < n; base += blockDim.x) {
      const int i = base + threadIdx.x;
      int digit = -1;
      if (i < n) {
        const uint32_t key = order_key(v(i));
        if ((key & pmask) == prefix) digit = (int)((key >> shift) & 255u);
      }
      const unsigned peers = __match_any_sync(kFull, digit);
      if (digit >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&hist[digit], __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {            // lane l holds bins 255 - 8l - q, q < 8
      int c[8], s = 0;
      for (int q = 0; q < 8; ++q) { c[q] = hist[255 - 8 * lane - q]; s += c[q]; }
      const int incl = warp_incl_scan(s), before = incl - s;
      if (before <= t && t < incl) {
        int tt = t - before, q = 0;
        while (tt >= c[q]) { tt -= c[q]; ++q; }
        hist[kHist] = 255 - 8 * lane - q;
        hist[kHist + 1] = tt;
      }
    }
    __syncthreads();
    prefix |= (uint32_t)hist[kHist] << shift;
    pmask |= 255u << shift;
    t = hist[kHist + 1];
  }
  return key_value(prefix);
}

// 26 steps of mid = 0.5 (lo + hi), keeping count(> lo) > K >= count(> hi),
// from the (K + 1)-th largest value ``kth``: the plain version's bisect
// (ops.select_slots), step for step.
__device__ __forceinline__ void bisect_window(float kth, float& lo,
                                              float& hi) {
  for (int it = 0; it < 26; ++it) {
    const float mid = 0.5f * (lo + hi);
    if (kth > mid) lo = mid; else hi = mid;
  }
}

__device__ __forceinline__ bool bit_of(const uint32_t* row, int j) {
  return (row[j >> 5] >> (j & 31)) & 1u;
}

// ---------------------------------------------------------------------------
// filter stages

// Gated H1 = clip((30 - |d1 - d2|) / 25, 0, 1) between slots a and b.
struct H1Eval {
  const float *lx, *ly, *rx, *ry;
  const unsigned char* vf;
  bool lookup;
  // every operand loaded and every term computed, the gates applied last
  __device__ float operator()(int a, int b) const {
    const bool on = a != b && vf[a] && vf[b];
    float dxl = lx[a] - lx[b], dyl = ly[a] - ly[b];
    float dxr = rx[a] - rx[b], dyr = ry[a] - ry[b];
    float d1, d2;
    bool near = true;
    if (lookup) {   // quantized coordinates: |dx|, |dy| < 50, 16 * hypot
      dxl = fabsf(dxl); dyl = fabsf(dyl); dxr = fabsf(dxr); dyr = fabsf(dyr);
      near = dxl < 50.f && dyl < 50.f && dxr < 50.f && dyr < 50.f;
      d1 = 16.f * sqrtf(dxl * dxl + dyl * dyl);
      d2 = 16.f * sqrtf(dxr * dxr + dyr * dyr);
    } else {
      d1 = sqrtf(dxl * dxl + dyl * dyl);
      d2 = sqrtf(dxr * dxr + dyr * dyr);
    }
    const float h = fminf(fmaxf((30.f - fabsf(d1 - d2)) / 25.f, 0.f), 1.f);
    return on && near ? h : 0.f;
  }
};

// H1(i, j) from the circulant half table (0 on the diagonal). With i
// fixed and j running over a warp's lanes, or with j fixed and i running,
// the reads fall on strides 1 and S - 1 (odd): at most two to a bank.
// The half table's index of H1(i, j), i != j.
__device__ __forceinline__ int h1_index(int K, int S, int i, int j) {
  int d = j - i;
  if (d < 0) d += K;
  return d <= K / 2 ? i * S + d - 1 : j * S + (K - d) - 1;
}

__device__ __forceinline__ float h1_at(const Filter& f, int i, int j) {
  const int K = f.K;
  if (f.h1_full) return f.h1[i * (K | 1) + j];
  const float h = f.h1[i == j ? 0 : h1_index(K, h1_stride(K), i, j)];
  return i == j ? 0.f : h;
}

// Every H1 entry once: row i, column d - 1 holds H1(i, i + d mod K) (in
// the full matrix, entries (i, j) and (j, i), the diagonal 0). The flat
// index walks (i, d) by a fixed step, so no division per entry.
__device__ inline void build_h1(Filter& f, bool lookup) {
  const int K = f.K, half = K / 2, S = h1_stride(K), KP = K | 1;
  if (f.h1_full)
    for (int i = threadIdx.x; i < K; i += blockDim.x) f.h1[i * KP + i] = 0.f;
  if (half > 0) {
    const H1Eval H{f.lx, f.ly, f.rx, f.ry, f.vf, lookup};
    const int qi = blockDim.x / half, qd = blockDim.x - qi * half;
    int i = threadIdx.x / half, dm = threadIdx.x - (threadIdx.x / half) * half;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < K * half; idx += blockDim.x) {
      const int j = i + dm + 1 < K ? i + dm + 1 : i + dm + 1 - K;
      const float h = H(i, j);
      if (f.h1_full) {
        f.h1[i * KP + j] = h;
        f.h1[j * KP + i] = h;
      } else {
        f.h1[i * S + dm] = h;
      }
      i += qi;
      dm += qd;
      if (dm >= half) { dm -= half; ++i; }
    }
  }
  __syncthreads();
}

// acc + sum over j in [j0, j1) of table[a + (j - j0) inc] b[j], in order.
__device__ __forceinline__ float strided_dot(float acc, const float* table,
                                             int a, int inc, const float* b,
                                             int j0, int j1) {
  return ordered_sum(j1 - j0, [&](int u) {
    return table[a + u * inc] * b[j0 + u]; }, acc);
}

// sum_j H1(i, j) b[j] over j = 0 .. K - 1 in index order, the diagonal's
// 0 * b[i] included; every lane of a warp on the same j. In the half table
// a lane's reads follow row i (stride 1) while 0 < j - i <= K / 2 (mod K),
// else row j (stride S - 1); a warp's 32 rows switch between the two in
// three 32-step zones around j = i - K / 2, j = i and j = i + K / 2.
// Outside them one running index per lane with the warp's stride serves;
// inside, each read takes its own index. (K < 64: the zones overlap, every
// read takes its own.)
__device__ inline float h1_row_dot(const Filter& f, int i, const float* b) {
  const int K = f.K;
  if (f.h1_full) {
    const float* row = f.h1 + i * (K | 1);
    return ordered_sum(K, [&](int j) { return row[j] * b[j]; });
  }
  const int half = K / 2, S = h1_stride(K);
  if (K < 64)
    return ordered_sum(K, [&](int j) { return h1_at(f, i, j) * b[j]; });
  const int i0 = i & ~31, i1 = min(i0 + 31, K - 1);
  float acc = 0.f;
  int j = 0;
  // zone ends: rows i0 .. i1 leave row-i reads (j = i + half - K + 1),
  // reach the diagonal (j = i), leave it (i + 1), leave row-i reads again
  // (i + half + 1); zones odd z, the runs between them even z
#pragma unroll 1
  for (int z = 0; z < 7; ++z) {
    const int off = z < 2 ? half - K + 1 : z < 4 ? (z & 1) : half + 1;
    const int end = z == 6 ? K
        : min(max(((z & 1) ? i1 : i0) + off, 0), K);
    if (j >= end) continue;
    if (z & 1) {                       // a zone: each read its own index
      acc = ordered_sum(end - j, [&](int u) {
        return h1_at(f, i, j + u) * b[j + u]; }, acc);
    } else {                           // rows i (z = 0, 4) or j (z = 2, 6)
      acc = strided_dot(acc, f.h1, h1_index(K, S, i, j),
                        (z & 2) ? S - 1 : 1, b, j, end);
    }
    j = end;
  }
  return acc;
}

// Stage-2 compatibility bit between compacted survivors a and b.
struct H2Eval {
  const uint32_t* h2;
  int W;
  __device__ float operator()(int a, int b) const {
    return bit_of(h2 + a * W, b) ? 1.f : 0.f;
  }
};

// The three trig-free angle tests (matcher.cpp:1471-1647) for survivors
// a != b: cos(v_a - v_b) >= cos(pi/4), cos(v_a - u) >= cos(pi/6) and
// cos(v_b - u) >= cos(pi/6), v = lori - rori, u = line_l - line_r.
// Swapping a and b negates both line vectors, exactly, so u and the
// result stay the same, unless exactly one side's points coincide
// (asymmetric()): its line vector is (1, 0) either way.
__device__ inline bool angle_ok(const Filter& f, int a, int b) {
  const float ca = f.cosv[a], sa_ = f.sinv[a], cb = f.cosv[b], sb_ = f.sinv[b];
  const bool t1 = (ca * cb + sa_ * sb_) >= kCosPi4;
  const float dxl = f.clx[a] - f.clx[b], dyl = f.cly[a] - f.cly[b];
  const float dxr = f.crx[a] - f.crx[b], dyr = f.cry[a] - f.cry[b];
  const float r2l = dxl * dxl + dyl * dyl, r2r = dxr * dxr + dyr * dyr;
  const bool zl = r2l == 0.f, zr = r2r == 0.f;    // atan2(0, 0) = 0
  // __frcp_rn: the correctly rounded 1 / x, the division's own result
  const float invl = __frcp_rn(sqrtf(zl ? 1.f : r2l));
  const float invr = __frcp_rn(sqrtf(zr ? 1.f : r2r));
  const float cLl = zl ? 1.f : dxl * invl, sLl = zl ? 0.f : -dyl * invl;
  const float cLr = zr ? 1.f : dxr * invr, sLr = zr ? 0.f : -dyr * invr;
  const float cu = cLl * cLr + sLl * sLr;
  const float su = sLl * cLr - cLl * sLr;
  const bool t2 = (ca * cu + sa_ * su) >= kCosPi6;
  const bool t3 = (cb * cu + sb_ * su) >= kCosPi6;
  return t1 && t2 && t3;
}

__device__ __forceinline__ bool asymmetric(const Filter& f, int a, int b) {
  const float dxl = f.clx[a] - f.clx[b], dyl = f.cly[a] - f.cly[b];
  const float dxr = f.crx[a] - f.crx[b], dyr = f.cry[a] - f.cry[b];
  return (dxl * dxl + dyl * dyl == 0.f) != (dxr * dxr + dyr * dyr == 0.f);
}

// b <- H b / (sum(H b) + 1e-5), iters times, over n entries of f.b;
// row(i) is sum_j H(i, j) b[j] in index order.
template <class RowF>
__device__ void power_iter(Filter& f, int n, int iters, const RowF& row) {
  for (int it = 0; it < iters; ++it) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) f.c[i] = row(i);
    __syncthreads();
    if (threadIdx.x == 0)
      f.scratch[0] = ordered_sum(n, [&](int i) { return f.c[i]; }) + 1e-5f;
    __syncthreads();
    const float den = f.scratch[0];
    for (int i = threadIdx.x; i < n; i += blockDim.x) f.b[i] = f.c[i] / den;
    __syncthreads();
  }
}

// The greedy order's keys: support, then up to three tie keys, each
// descending, then the slot ascending.
struct Keys {
  const float* S;
  const float* k[3];
  int nk;
};

// One candidate of the greedy order's sort: eligibility, support and up
// to three tie keys (larger first), then the slot (smaller first): the
// spec's candidate-list order (matcher.cpp:1184-1220). Slots past n are
// padding, after every candidate.
struct SortKey {
  int idx;
  float e, s, k0, k1, k2;
};

__device__ __forceinline__ SortKey sort_key(const Filter& f, const Keys& o,
                                            int i, int n) {
  if (i >= n) return SortKey{i, -1.f, 0.f, 0.f, 0.f, 0.f};
  return SortKey{i, f.elig[i] ? 1.f : 0.f, o.S[i],
                 o.nk > 0 ? o.k[0][i] : 0.f, o.nk > 1 ? o.k[1][i] : 0.f,
                 o.nk > 2 ? o.k[2][i] : 0.f};
}

// a goes before b. For keys without NaN this is the plain version's
// lex_outranks; every pair is ordered (the slot decides last), as a
// sorting network needs. Selects from the last key up, so the lanes of a
// warp do not diverge.
__device__ __forceinline__ bool goes_first(const SortKey& a,
                                           const SortKey& b) {
  bool r = a.idx < b.idx;
  r = a.k2 > b.k2 || (!(b.k2 > a.k2) && r);
  r = a.k1 > b.k1 || (!(b.k1 > a.k1) && r);
  r = a.k0 > b.k0 || (!(b.k0 > a.k0) && r);
  r = a.s > b.s || (!(b.s > a.s) && r);
  return a.e > b.e || (!(b.e > a.e) && r);
}

__device__ __forceinline__ SortKey shfl_xor_key(const SortKey& a, int j) {
  return SortKey{__shfl_xor_sync(kFull, a.idx, j),
                 __shfl_xor_sync(kFull, a.e, j),
                 __shfl_xor_sync(kFull, a.s, j),
                 __shfl_xor_sync(kFull, a.k0, j),
                 __shfl_xor_sync(kFull, a.k1, j),
                 __shfl_xor_sync(kFull, a.k2, j)};
}

// f.ord[0, ne) = the eligible candidates in the greedy order, f.pos[c] =
// the rank of eligible candidate c; returns ne. A bitonic sort, one
// candidate per thread in registers (n <= kThreads): the exchanges within
// a warp by shuffles, the wider ones through f.hist with two barriers.
// The order is strict, so the result is the plain version's ranking.
__device__ inline int greedy_order(Filter& f, int n, const Keys& keys) {
  int N2 = 1;
  while (N2 < n) N2 <<= 1;
  const int t = threadIdx.x;
  SortKey me = sort_key(f, keys, t, n);
  for (int k = 2; k <= N2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      SortKey other;
      if (j >= 32) {
        f.hist[t] = me.idx;
        __syncthreads();
        other = sort_key(f, keys, f.hist[t ^ j], n);
        __syncthreads();
      } else {
        other = shfl_xor_key(me, j);
      }
      const bool want_first = ((t & j) == 0) == ((t & k) == 0);
      if (goes_first(me, other) != want_first) me = other;
    }
  }
  const int lane = t & 31;
  int ne = 0;
  for (int base = 0; base < n; base += 32)
    ne += __popc(__ballot_sync(kFull, base + lane < n && f.elig[base + lane]));
  if (t < ne) {
    f.ord[t] = me.idx;
    f.pos[me.idx] = t;
  }
  __syncthreads();
  return ne;
}

// The greedy selection over the n candidates of f (elig set):
//   1. the eligible candidates' order (greedy_order);
//   2. blk row r in rank space, bit r' < r: the candidate of rank r' blocks
//      that of rank r (bad(i, j)); one warp per rank, a ballot per word;
//   3. warp 0 decides 32 ranks at a time: a rank is selected when no
//      selected earlier rank blocks it. The masks of earlier chunks are
//      tested lane by lane, the chunk's own ranks in order through
//      shuffles. This is the sequential greedy in rank order, the unique
//      fixpoint of the plain version's parallel rounds (a candidate's
//      blockers all precede it);
//   4. f.sel, in slot space.
template <class BadF>
__device__ void greedy(Filter& f, int n, const Keys& keys, const BadF& bad) {
  const int W = (n + 31) / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ne = greedy_order(f, n, keys);
  for (int r = warp; r < ne; r += kWarps) {
    const int i = f.ord[r];
#pragma unroll 4
    for (int w = 0; w * 32 < r; ++w) {
      const int rr = w * 32 + lane;
      const int j = f.ord[min(rr, r - 1)];
      const unsigned word = __ballot_sync(kFull, rr < r && bad(i, j));
      if (lane == 0) f.blk[r * W + w] = word;
    }
  }
  __syncthreads();
  if (warp == 0) {
    uint32_t* selr = reinterpret_cast<uint32_t*>(f.hist);   // rank space
    for (int c = 0; c * 32 < ne; ++c) {
      const int r = c * 32 + lane;
      const bool live = r < ne;
      bool hit = false;
      uint32_t m = 0u;
      if (live) {
        for (int w = 0; w < c; ++w) hit |= (f.blk[r * W + w] & selr[w]) != 0u;
        m = f.blk[r * W + c] & ((1u << lane) - 1u);
      }
      const unsigned blocked = __ballot_sync(kFull, hit || !live);
      uint32_t S = 0u;
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const uint32_t mk = __shfl_sync(kFull, m, k);
        if (!((blocked >> k) & 1u) && (mk & S) == 0u) S |= 1u << k;
      }
      if (lane == 0) selr[c] = S;
      __syncwarp();
    }
    __syncwarp();
    for (int w = 0; w < W; ++w) {
      const int s = w * 32 + lane;
      bool on = false;
      if (s < n && f.elig[s]) {
        const int r = f.pos[s];
        on = (selr[r >> 5] >> (r & 31)) & 1u;
      }
      const unsigned word = __ballot_sync(kFull, on);
      if (lane == 0) f.sel[w] = word;
    }
  }
  __syncthreads();
}

// Sum of v(0), ..., v(n - 1) in index order, one rounding per term, in
// every thread.
template <class V>
__device__ float seq_total(Filter& f, int n, const V& v) {
  __syncthreads();
  if (threadIdx.x == 0) f.scratch[1] = ordered_sum(n, v);
  __syncthreads();
  const float total = f.scratch[1];
  __syncthreads();
  return total;
}

// Both stages over the K slots of f (filled, vf = 0 on empty slots, ties
// set, block synchronized). Returns the score in every thread.
//
// ``stages`` < 6 is the JAX package's bench hook (_filter_body :213-381):
// it returns a partial sum instead of the score, 0 the I/O floor sum(val *
// vf) + sum(lx + ly + lc + ls) + sum(rx + ry + rc + rs) + sum(li + ri), 1
// sum(H1), 2 sum(S1), 3 the stage-1 survivors' similarities, 4 the number
// of compatible stage-2 pairs, 5 sum(S2). With 0 < stage2_cap < K stage 2
// runs on the first stage2_cap survivors in rank order (a survivor past
// the cap is dropped) while its seed 1 / n2 still counts every survivor.
__device__ inline float filter_run(Filter& f, bool lookup, int dist_iters,
                                   int stages = 6, int stage2_cap = 0) {
  const int K = f.K;

  if (stages <= 0) {
    const float a = seq_total(f, K, [&](int k) {
      return f.val[k] * (f.vf[k] ? 1.f : 0.f); });
    const float l = seq_total(f, K, [&](int k) {
      return ((f.lx[k] + f.ly[k]) + f.lc[k]) + f.ls[k]; });
    const float r = seq_total(f, K, [&](int k) {
      return ((f.rx[k] + f.ry[k]) + f.rc[k]) + f.rs[k]; });
    const float ix = seq_total(f, K, [&](int k) {
      return (float)f.li[k] + (float)f.ri[k]; });
    return ((a + l) + r) + ix;
  }
  build_h1(f, lookup);
  if (stages == 1) {
    for (int i = threadIdx.x; i < K; i += blockDim.x)
      f.c[i] = ordered_sum(K, [&](int j) { return h1_at(f, i, j); });
    return seq_total(f, K, [&](int i) { return f.c[i]; });
  }

  // ---- stage 1: distance consistency, support seeded with similarities
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    f.b[k] = f.vf[k] ? f.val[k] : 0.f;
  __syncthreads();
  power_iter(f, K, dist_iters, [&](int i) { return h1_row_dot(f, i, f.b); });
  if (stages == 2) return seq_total(f, K, [&](int k) { return f.b[k]; });
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    f.s1[k] = f.b[k];
    f.elig[k] = f.vf[k] && f.b[k] >= 1e-4f;
  }
  __syncthreads();
  greedy(f, K, Keys{f.s1, {f.tie0, f.tie1, f.tie1}, f.ntie},
         [&](int i, int j) {
    const float h = h1_at(f, i, j);
    return f.li[i] == f.li[j] || f.ri[i] == f.ri[j] || h < 1e-5f;
  });
  if (stages == 3)
    return seq_total(f, K, [&](int k) {
      return bit_of(f.sel, k) ? f.val[k] : 0.f; });

  // ---- compact the stage-1 survivors (rank order kept), at most
  // stage2_cap of them when 0 < stage2_cap < K
  const int n2 = block_scan_count(K, [&](int i) { return bit_of(f.sel, i); },
                                  f.pos, f.hist);
  const int nc = (stage2_cap > 0 && stage2_cap < K && n2 > stage2_cap)
      ? stage2_cap : n2;
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    if (bit_of(f.sel, k) && f.pos[k] < nc) f.cidx[f.pos[k]] = k;
  __syncthreads();
  const float b2 = 1.f / fmaxf((float)n2, 1.f);
  for (int m = threadIdx.x; m < nc; m += blockDim.x) {
    const int s = f.cidx[m];
    f.cosv[m] = f.lc[s] * f.rc[s] + f.ls[s] * f.rs[s];
    f.sinv[m] = f.ls[s] * f.rc[s] - f.lc[s] * f.rs[s];
    f.key0[m] = f.s1[s];
    f.key1[m] = f.tie0[s];
    f.key2[m] = f.tie1[s];
    f.clx[m] = f.lx[s];
    f.cly[m] = f.ly[s];
    f.crx[m] = f.rx[s];
    f.cry[m] = f.ry[s];
    f.b[m] = b2;
  }
  __syncthreads();

  // ---- stage 2: angle consistency over the survivors, uniform seed
  // the pairs b > a, then b < a mirrored (or tested where asymmetric)
  const int W2 = (nc + 31) / 32;
  {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int a = warp; a < nc; a += kWarps) {
      for (int w = (a + 1) >> 5; w < W2; ++w) {
        {
          const int bb = w * 32 + lane;
          const unsigned word = __ballot_sync(
              kFull, bb < nc && bb > a && angle_ok(f, a, min(bb, nc - 1)));
          if (lane == 0) f.h2[a * W2 + w] = word;
        }
      }
    }
    __syncthreads();
    for (int a = warp; a < nc; a += kWarps) {
      for (int w = 0; w * 32 < a; ++w) {
        {
          const int bb = min(w * 32 + lane, a);
          bool on = false;
          if (bb < a)
            on = asymmetric(f, a, bb) ? angle_ok(f, a, bb)
                                      : bit_of(f.h2 + bb * W2, a);
          const unsigned word = __ballot_sync(kFull, on);
          if (lane == 0)
            f.h2[a * W2 + w] = w * 32 + 31 > a ? f.h2[a * W2 + w] | word
                                               : word;
        }
      }
    }
  }
  __syncthreads();
  if (stages == 4)
    return seq_total(f, nc, [&](int a) {
      int n = 0;
      for (int w = 0; w < W2; ++w) n += __popc(f.h2[a * W2 + w]);
      return (float)n; });
  const H2Eval H2{f.h2, W2};
  power_iter(f, nc, 5, [&](int a) {
    return ordered_sum(nc, [&](int j) { return H2(a, j) * f.b[j]; });
  });
  if (stages == 5) return seq_total(f, nc, [&](int m) { return f.b[m]; });
  for (int m = threadIdx.x; m < nc; m += blockDim.x) f.elig[m] = f.b[m] >= 1e-3f;
  __syncthreads();
  greedy(f, nc, Keys{f.b, {f.key0, f.key1, f.key2}, f.ntie + 1},
         [&](int a, int b) {
    const int sa = f.cidx[a], sb = f.cidx[b];
    return f.li[sa] == f.li[sb] || f.ri[sa] == f.ri[sb]
        || !bit_of(f.h2 + a * W2, b);
  });
  return seq_total(f, nc, [&](int m) {
    return bit_of(f.sel, m) ? f.val[f.cidx[m]] : 0.f; });
}

}  // namespace afis
