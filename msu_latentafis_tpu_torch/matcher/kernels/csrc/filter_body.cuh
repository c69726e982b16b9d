// Graph-consistency filter over one correspondence set, run by one thread
// block. Shared by texture_match.cu and minutiae_match.cu.
//
// Replaces the JAX package's pallas_kernels.py helpers _filter_body (:189),
// _greedy_rounds (:116), _power_iter (:162) and _blockers (:170). The plain
// specification is matcher/graph_filter.py; both take every sum in index
// order and every product and sum as its own rounding (the library is built
// with --fmad=false), so the two agree bit for bit.
//
// Bound: operations. Per set the work is O(K^2) pairwise tests for
// K <= 200 slots, far more than the few KB the set reads. At K = 200 the
// f32 matrices H1, H2 and the blocker matrix are 160 KB each and cannot all
// sit in shared memory, so this routine keeps only [K] slot vectors there:
// H1 entries are recomputed from the slot coordinates wherever they are
// needed, and the blockers and H2 are K x K bit masks (5 KB each). Stage 2
// runs on the compacted list of stage-1 survivors; dropping the non-survivor
// slots removes only zero terms from its sums and keeps the rank order, so
// the result equals the uncompacted body.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace afis {

constexpr int kThreads = 256;
constexpr int kMaxK = 256;
constexpr float kCosPi4 = (float)0.7071067811865476;   // float32(cos(pi/4))
constexpr float kCosPi6 = (float)0.8660254037844387;   // float32(cos(pi/6))

// Slot vectors and masks of one set, carved from dynamic shared memory.
struct Filter {
  int K, ntie;
  float *scratch;                                  // [4]
  int *iscratch;                                   // [4]
  float *val, *lx, *ly, *lc, *ls, *rx, *ry, *rc, *rs;
  float *tie0, *tie1;                              // stage-1 tie keys
  float *s1, *b, *c;                               // supports, power vectors
  float *cosv, *sinv, *key0, *key1, *key2;         // compacted stage 2
  int *li, *ri, *cidx, *pos;
  unsigned char *vf, *elig, *dec;
  uint32_t *blk, *h2, *sel, *rej;                  // bit masks
};

__host__ __device__ inline int filter_words(int K) {
  const int W = (K + 31) / 32;
  return 8 + 19 * K + 4 * K + (3 * K + 3) / 4 + 2 * K * W + 2 * W;
}

__device__ inline Filter carve_filter(uint32_t* base, int K, int ntie) {
  const int W = (K + 31) / 32;
  Filter f;
  f.K = K;
  f.ntie = ntie;
  f.scratch = reinterpret_cast<float*>(base);
  f.iscratch = reinterpret_cast<int*>(base + 4);
  float* p = reinterpret_cast<float*>(base + 8);
  f.val = p;  p += K;  f.lx = p;   p += K;  f.ly = p;   p += K;
  f.lc = p;   p += K;  f.ls = p;   p += K;  f.rx = p;   p += K;
  f.ry = p;   p += K;  f.rc = p;   p += K;  f.rs = p;   p += K;
  f.tie0 = p; p += K;  f.tie1 = p; p += K;  f.s1 = p;   p += K;
  f.b = p;    p += K;  f.c = p;    p += K;  f.cosv = p; p += K;
  f.sinv = p; p += K;  f.key0 = p; p += K;  f.key1 = p; p += K;
  f.key2 = p; p += K;                                  // 19 float vectors
  int* q = reinterpret_cast<int*>(p);
  f.li = q; q += K;
  f.ri = q; q += K;
  f.cidx = q; q += K;
  f.pos = q; q += K;
  unsigned char* u = reinterpret_cast<unsigned char*>(q);
  f.vf = u;
  f.elig = u + K;
  f.dec = u + 2 * K;
  uint32_t* m = reinterpret_cast<uint32_t*>(q) + (3 * K + 3) / 4;
  f.blk = m; m += K * W;
  f.h2 = m; m += K * W;
  f.sel = m; m += W;
  f.rej = m;
  return f;
}

// ---------------------------------------------------------------------------
// block-wide helpers (every thread of the block must call them)

// Number of i in [0, n) with pred(i).
template <class Pred>
__device__ int block_count(int n, const Pred& pred) {
  int total = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    total += __syncthreads_count(i < n && pred(i));
  }
  return total;
}

// Exclusive prefix count of pred in index order into pos[i] (written where
// pred(i) holds); returns the total. Warp 0 scans 32 elements per step.
template <class Pred>
__device__ int scan_count(int n, const Pred& pred, int* pos, int* slot) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int run = 0;
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      const bool p = i < n && pred(i);
      const unsigned m = __ballot_sync(0xffffffffu, p);
      if (p) pos[i] = run + __popc(m & ((1u << lane) - 1u));
      run += __popc(m);
    }
    if (lane == 0) *slot = run;
  }
  __syncthreads();
  const int total = *slot;
  __syncthreads();
  return total;
}

// Block-wide min and max of one value per thread (red: >= 64 floats).
__device__ inline void block_minmax(float vmin, float vmax, float* red,
                                    float* out_min, float* out_max) {
  for (int off = 16; off > 0; off >>= 1) {
    vmin = fminf(vmin, __shfl_xor_sync(0xffffffffu, vmin, off));
    vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, off));
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
  __device__ float operator()(int a, int b) const {
    if (a == b || !vf[a] || !vf[b]) return 0.f;
    float dxl = lx[a] - lx[b], dyl = ly[a] - ly[b];
    float dxr = rx[a] - rx[b], dyr = ry[a] - ry[b];
    float d1, d2;
    if (lookup) {   // quantized coordinates: |dx|, |dy| < 50, 16 * hypot
      dxl = fabsf(dxl); dyl = fabsf(dyl); dxr = fabsf(dxr); dyr = fabsf(dyr);
      if (!(dxl < 50.f && dyl < 50.f && dxr < 50.f && dyr < 50.f)) return 0.f;
      d1 = 16.f * sqrtf(dxl * dxl + dyl * dyl);
      d2 = 16.f * sqrtf(dxr * dxr + dyr * dyr);
    } else {
      d1 = sqrtf(dxl * dxl + dyl * dyl);
      d2 = sqrtf(dxr * dxr + dyr * dyr);
    }
    const float h = (30.f - fabsf(d1 - d2)) / 25.f;
    return fminf(fmaxf(h, 0.f), 1.f);
  }
};

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
__device__ inline bool angle_ok(const Filter& f, int a, int b) {
  const int sa = f.cidx[a], sb = f.cidx[b];
  const float ca = f.cosv[a], sa_ = f.sinv[a], cb = f.cosv[b], sb_ = f.sinv[b];
  const bool t1 = (ca * cb + sa_ * sb_) >= kCosPi4;
  const float dxl = f.lx[sa] - f.lx[sb], dyl = f.ly[sa] - f.ly[sb];
  const float dxr = f.rx[sa] - f.rx[sb], dyr = f.ry[sa] - f.ry[sb];
  const float r2l = dxl * dxl + dyl * dyl, r2r = dxr * dxr + dyr * dyr;
  const bool zl = r2l == 0.f, zr = r2r == 0.f;    // atan2(0, 0) = 0
  const float invl = 1.f / sqrtf(zl ? 1.f : r2l);
  const float invr = 1.f / sqrtf(zr ? 1.f : r2r);
  const float cLl = zl ? 1.f : dxl * invl, sLl = zl ? 0.f : -dyl * invl;
  const float cLr = zr ? 1.f : dxr * invr, sLr = zr ? 0.f : -dyr * invr;
  const float cu = cLl * cLr + sLl * sLr;
  const float su = sLl * cLr - cLl * sLr;
  const bool t2 = (ca * cu + sa_ * su) >= kCosPi6;
  const bool t3 = (cb * cu + sb_ * su) >= kCosPi6;
  return t1 && t2 && t3;
}

// b <- H b / (sum(H b) + 1e-5), iters times, over n entries of f.b.
template <class HF>
__device__ void power_iter(Filter& f, int n, int iters, const HF& H) {
  for (int it = 0; it < iters; ++it) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc = acc + H(i, j) * f.b[j];
      f.c[i] = acc;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int i = 0; i < n; ++i) s = s + f.c[i];
      f.scratch[0] = s + 1e-5f;
    }
    __syncthreads();
    const float den = f.scratch[0];
    for (int i = threadIdx.x; i < n; i += blockDim.x) f.b[i] = f.c[i] / den;
    __syncthreads();
  }
}

// j precedes i: support descending, then each tie key descending, then
// slot ascending (the spec's candidate-list order, matcher.cpp:1184-1220).
__device__ inline bool outranks(int i, int j, const float* S,
                                const float* const* keys, int nk) {
  if (S[j] > S[i]) return true;
  if (!(S[j] == S[i])) return false;
  for (int t = 0; t < nk; ++t) {
    const float a = keys[t][j], b = keys[t][i];
    if (a > b) return true;
    if (!(a == b)) return false;
  }
  return j < i;
}

// blk row i, bit j: j blocks i (both eligible, j outranks i, bad(i, j)).
template <class BadF>
__device__ void build_blockers(Filter& f, int n, const float* S,
                               const float* const* keys, int nk,
                               const BadF& bad) {
  const int W = (n + 31) / 32;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    for (int w = 0; w < W; ++w) {
      uint32_t word = 0u;
      if (f.elig[i]) {
        for (int bit = 0; bit < 32; ++bit) {
          const int j = w * 32 + bit;
          if (j < n && j != i && f.elig[j] && outranks(i, j, S, keys, nk)
              && bad(i, j))
            word |= 1u << bit;
        }
      }
      f.blk[i * W + w] = word;
    }
  }
  __syncthreads();
}

// Greedy one-to-one selection as parallel rounds; result in f.sel.
// Each round selects every undecided candidate with no live blocker and
// rejects every one with a selected blocker. The highest-ranked undecided
// candidate has only decided blockers (they all outrank it), so each round
// decides at least one candidate: n rounds always reach the fixpoint, and
// the loop stops as soon as nothing is undecided.
__device__ inline void greedy(Filter& f, int n) {
  const int W = (n + 31) / 32;
  for (int w = threadIdx.x; w < W; w += blockDim.x) { f.sel[w] = 0u; f.rej[w] = 0u; }
  __syncthreads();
  for (int round = 0; round < n; ++round) {
    int undecided = 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      unsigned char d = 0;
      if (f.elig[i] && !bit_of(f.sel, i) && !bit_of(f.rej, i)) {
        undecided = 1;
        bool by_sel = false, live = false;
        for (int w = 0; w < W; ++w) {
          const uint32_t bw = f.blk[i * W + w];
          by_sel |= (bw & f.sel[w]) != 0u;
          live |= (bw & ~f.rej[w]) != 0u;
        }
        d = !live ? 1 : (by_sel ? 2 : 0);
      }
      f.dec[i] = d;
    }
    if (!__syncthreads_or(undecided)) break;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      if (f.dec[i] == 1) atomicOr(&f.sel[i >> 5], 1u << (i & 31));
      else if (f.dec[i] == 2) atomicOr(&f.rej[i >> 5], 1u << (i & 31));
    }
    __syncthreads();
  }
}

// Sum of v(0), ..., v(n - 1) in index order, one rounding per term, in
// every thread.
template <class V>
__device__ float seq_total(Filter& f, int n, const V& v) {
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int i = 0; i < n; ++i) acc = acc + v(i);
    f.scratch[1] = acc;
  }
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
  const H1Eval H1{f.lx, f.ly, f.rx, f.ry, f.vf, lookup};

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
  if (stages == 1) {
    for (int i = threadIdx.x; i < K; i += blockDim.x) {
      float acc = 0.f;
      for (int j = 0; j < K; ++j) acc = acc + H1(i, j);
      f.c[i] = acc;
    }
    return seq_total(f, K, [&](int i) { return f.c[i]; });
  }

  // ---- stage 1: distance consistency, support seeded with similarities
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    f.b[k] = f.vf[k] ? f.val[k] : 0.f;
  __syncthreads();
  power_iter(f, K, dist_iters, H1);
  if (stages == 2) return seq_total(f, K, [&](int k) { return f.b[k]; });
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    f.s1[k] = f.b[k];
    f.elig[k] = f.vf[k] && f.b[k] >= 1e-4f;
  }
  __syncthreads();
  const float* keys1[2] = {f.tie0, f.tie1};
  build_blockers(f, K, f.s1, keys1, f.ntie, [&](int i, int j) {
    return f.li[i] == f.li[j] || f.ri[i] == f.ri[j] || H1(i, j) < 1e-5f;
  });
  greedy(f, K);
  if (stages == 3)
    return seq_total(f, K, [&](int k) {
      return bit_of(f.sel, k) ? f.val[k] : 0.f; });

  // ---- compact the stage-1 survivors (rank order kept), at most
  // stage2_cap of them when 0 < stage2_cap < K
  const int n2 = scan_count(K, [&](int i) { return bit_of(f.sel, i); },
                            f.pos, f.iscratch);
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
    f.b[m] = b2;
  }
  __syncthreads();

  // ---- stage 2: angle consistency over the survivors, uniform seed
  const int W2 = (nc + 31) / 32;
  for (int a = threadIdx.x; a < nc; a += blockDim.x) {
    for (int w = 0; w < W2; ++w) {
      uint32_t word = 0u;
      for (int bit = 0; bit < 32; ++bit) {
        const int bb = w * 32 + bit;
        if (bb < nc && bb != a && angle_ok(f, a, bb)) word |= 1u << bit;
      }
      f.h2[a * W2 + w] = word;
    }
  }
  __syncthreads();
  if (stages == 4)
    return seq_total(f, nc, [&](int a) {
      int n = 0;
      for (int w = 0; w < W2; ++w) n += __popc(f.h2[a * W2 + w]);
      return (float)n; });
  power_iter(f, nc, 5, H2Eval{f.h2, W2});
  if (stages == 5) return seq_total(f, nc, [&](int m) { return f.b[m]; });
  for (int m = threadIdx.x; m < nc; m += blockDim.x) f.elig[m] = f.b[m] >= 1e-3f;
  __syncthreads();
  const float* keys2[3] = {f.key0, f.key1, f.key2};
  build_blockers(f, nc, f.b, keys2, f.ntie + 1, [&](int a, int b) {
    const int sa = f.cidx[a], sb = f.cidx[b];
    return f.li[sa] == f.li[sb] || f.ri[sa] == f.ri[sb]
        || !bit_of(f.h2 + a * W2, b);
  });
  greedy(f, nc);
  return seq_total(f, nc, [&](int m) {
    return bit_of(f.sel, m) ? f.val[f.cidx[m]] : 0.f; });
}

}  // namespace afis
