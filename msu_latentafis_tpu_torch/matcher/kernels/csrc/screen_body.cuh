// The bodies of the ADC screens and of the ADC row max, shared by the
// predecoded screen (adc_screen.cu), the codes-resident screen
// (adc_screen_codes.cu), the experiment's transposed bf16 screen
// (screen_t.cu) and the row max over predecoded or codes columns
// (adc_rowmax.cu). Each takes the maxima over one entry's Rt rolled
// columns of the dots of many latent rows against them; persistent blocks
// (about one per SM) walk the work items (entry, row group):
//
//   - screen_tc_kernel<Src, Rows>: bf16 latent rows on the tensor cores,
//     mma.sync.m16n8k16 bf16 x bf16 -> f32 (mma.cuh). A group is up to 512
//     latent rows, 64 per warp, whose A fragments stay in registers; the
//     entry's columns arrive in tiles of 128 stored [n][kLd] bf16 in shared
//     memory and feed ldmatrix; each warp folds its rows' values from the
//     accumulators (Rows::Fold: the maximum for a screen, the three largest
//     with the columns of the first two for the row max), then a quad
//     shuffle and a fold over the warps that split the columns.
//   - screen_f32_kernel<Src, Rows>: f32 on the CUDA cores, each dot in
//     index order with one rounding per product and per sum
//     (--fmad=false), bit for bit the plain version. The entry's column
//     tile is staged once, widened to f32 and stored d-major; the latent
//     rows stream from L2 in 64-row cp.async tiles against it; 256 threads
//     hold 4 x 8 register tiles (float4 reads); the running row maxima (and
//     the row max's first argmax) sit in shared memory.
//
// The column source (Src) says where a tile comes from: decoded from PQ
// codes (codes_src.cuh), or copied from predecoded descriptors (CopyTC /
// CopyF32 below: bf16 as it is, int8 widened exactly, f32 as it is). The
// rows (Rows) say what the latent side is and what a row maximum becomes:
// LatRows, the screen's latents [NL, Lt, D], rows rounded to x's type and
// summed into per-latent terms (finish_group); TRows, the transposed
// experiment's xt [Da, M] and its raw maxima [B, M]; ArgRows, the row
// max's latents [NL, Lt, D] and its best / bestj [NL, B, Lt], which on the
// tensor cores keeps a few candidates per row and decides between them
// with exact dots in index order (bit for bit the plain version).
//
// Sources with the same tile and the same rows run the same instructions
// in the same order, so the codes and predecoded screens give the same bits
// on the same entry in bf16 (tensor cores) as in f32 (CUDA cores).
#pragma once

#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "dtypes.cuh"
#include "mma.cuh"

namespace afis_screen {

using afis_t::bf16;
using namespace afis_mma;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCT = 128;                  // rolled columns per tile
constexpr int kDMax = kMaxKSteps * kK;    // 96 features on the tensor cores
constexpr int kLd = kDMax + 8;            // bf16 tile row, 13 x 16 bytes
constexpr int kWarpRows = 64;             // latent rows per warp (4 m-tiles)
constexpr int kRowsTC = kWarps * kWarpRows;   // rows per tensor-core group
constexpr int kRowTile = 64;              // latent rows per f32 tile
constexpr int kLdx = kRowTile + 4;        // f32 row tile stride (no conflicts)
constexpr int kMaxRowsF32 = 4096;         // running maxima an f32 block holds
constexpr int kStages = 3;                // copied tiles: one in use, two in flight

__host__ __device__ inline size_t padded(size_t bytes) {
  return (bytes + 15) & ~static_cast<size_t>(15);
}

// The next `bytes` of shared memory at sm (16-byte aligned); advances sm.
__device__ __forceinline__ unsigned char* carve(unsigned char*& sm,
                                                size_t bytes) {
  unsigned char* p = sm;
  sm += padded(bytes);
  return p;
}

// Eight consecutive values of a row, widened to f32: one 16-byte (bf16,
// two for f32) or 8-byte (int8) load where p is aligned to it, else eight.
template <class T>
__device__ __forceinline__ void load8(const T* p, float v[8]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if constexpr (std::is_same<T, bf16>::value) {
    if ((a & 15) == 0) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
      const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[2 * k] = __uint_as_float(wd[k] << 16);
        v[2 * k + 1] = __uint_as_float(wd[k] & 0xffff0000u);
      }
      return;
    }
  } else if constexpr (std::is_same<T, int8_t>::value) {
    if ((a & 7) == 0) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[k] = (float)(int8_t)(((k < 4 ? u.x : u.y) >> (8 * (k & 3))) & 0xff);
      return;
    }
  } else {
    if ((a & 15) == 0) {
      const float4 f0 = __ldg(reinterpret_cast<const float4*>(p));
      const float4 f1 = __ldg(reinterpret_cast<const float4*>(p) + 1);
      v[0] = f0.x; v[1] = f0.y; v[2] = f0.z; v[3] = f0.w;
      v[4] = f1.x; v[5] = f1.y; v[6] = f1.z; v[7] = f1.w;
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = afis_t::widen(p[k]);
}

// ---------------------------------------------------------------------------
// the walk: which (entry, row group, column tile) a block takes next
// ---------------------------------------------------------------------------

// Column tile t of entry b against row group g; j counts the entries the
// block has taken.
struct Step {
  int b, g, t, j;
};

// With `fixed`, block k keeps row group k % ngroups for its life and takes
// that group's entries E at a time, in turn with the group's other blocks;
// otherwise every block walks every group of each entry it takes (entries
// grid-strided, E = 1).
struct Walk {
  int B, Rt, ct, ntiles, ngroups, E;
  bool fixed;

  __device__ int entry(int j) const {
    const int per = gridDim.x / ngroups, k = blockIdx.x / ngroups;
    return (j / E) * per * E + k * E + j % E;
  }
  __device__ Step first() const {
    if (!fixed) return Step{(int)blockIdx.x, 0, 0, 0};
    return Step{entry(0), (int)blockIdx.x % ngroups, 0, 0};
  }
  __device__ Step next(Step s) const {
    if (++s.t < ntiles) return s;
    s.t = 0;
    if (fixed) {
      s.b = entry(++s.j);
      return s;
    }
    if (++s.g < ngroups) return s;
    s.g = 0;
    s.b += gridDim.x;
    return s;
  }
  __device__ int ncols(int t) const { return min(ct, Rt - t * ct); }
};

// ---------------------------------------------------------------------------
// the screens' fold on the tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ int vmax(int a, int b) { return max(a, b); }
__device__ __forceinline__ void set_lowest(float& v) { v = -INFINITY; }
__device__ __forceinline__ void set_lowest(int& v) { v = INT_MIN; }

// How a block's warps split a group of gn rows: wr row slots of kWarpRows
// rows x wc column slots; this warp takes row slot rw of column slot cw
// (idle where cw >= wc).
struct WarpSplit {
  int wr, wc, rw, cw;

  __device__ void set(int gn) {
    const int warp = threadIdx.x >> 5;
    wr = (gn + kWarpRows - 1) / kWarpRows;
    wc = kWarps / wr;
    rw = warp % wr;
    cw = warp / wr;
  }
};

// The running maximum (V: float, or int for the int8 screen) of each of a
// lane's 8 rows (rows g, g + 8 of its warp's 4 m-tiles); at a group's end
// the quad lanes, which hold the same rows, reduce, and one lane per
// column slot writes the slot's maxima.
template <class V>
struct MaxFoldT {
  V mx[4][2];

  __device__ void reset() {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      set_lowest(mx[m][0]);
      set_lowest(mx[m][1]);
    }
  }
  __device__ void add(int m, int h, V v0, int, V v1, int) {
    mx[m][h] = vmax(mx[m][h], vmax(v0, v1));
  }
  // part[cw * wr * kWarpRows + r]: group row r's maximum over slot cw.
  __device__ void to_part(V* part, const WarpSplit& sp) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        V v = mx[m][h];
        v = vmax(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = vmax(v, __shfl_xor_sync(0xffffffffu, v, 2));
        const int r = sp.rw * kWarpRows + m * 16 + (lane >> 2) + 8 * h;
        if (sp.cw < sp.wc && (lane & 3) == 0)
          part[sp.cw * sp.wr * kWarpRows + r] = v;
      }
  }
};
using MaxFold = MaxFoldT<float>;

// Group row r's maximum over the nslot column slots of part (slot rows a
// slot).
template <class V>
__device__ __forceinline__ V slot_max(const V* part, int slot, int nslot,
                                      int r) {
  V v = part[r];
  for (int q = 1; q < nslot; ++q) v = vmax(v, part[q * slot + r]);
  return v;
}

// ---------------------------------------------------------------------------
// the screen's latent rows and its epilogue
// ---------------------------------------------------------------------------

// After a group's last tile: the row maxima max_of(r) (r < rows in the
// group) become terms max(2 raw + ((6 - lsq) - tau), 0) lvalid, raw rounded
// to XT, and the terms add into the per-latent sums in row order; a latent
// whose last row is in the group writes its score, any other carries its
// partial sum in lsum to the entry's next group. Every thread calls it;
// term may alias the maxima.
template <class XT, class P, class MaxOf>
__device__ void finish_group(const MaxOf& max_of, float* term, float* lsum,
                             int b, int g, const P& p) {
  const int g0 = g * p.group, gn = min(p.group, p.rows - g0);
  __syncthreads();
  for (int r = threadIdx.x; r < gn; r += kThreads) {
    const int row = g0 + r;
    const float raw = afis_t::round_to<XT>(max_of(r));
    const float t6 = (6.f - p.lsq[row]) - p.tau;
    term[r] = fmaxf(2.f * raw + t6, 0.f) * p.lvalid[row];
  }
  __syncthreads();
  const int n_lo = g0 / p.Lt, n_hi = (g0 + gn - 1) / p.Lt;
  for (int n = n_lo + threadIdx.x; n <= n_hi; n += kThreads) {
    const int first = n * p.Lt, last = first + p.Lt;
    const int a = max(first, g0), e = min(last, g0 + gn);
    float s = a == first ? 0.f : lsum[n];
    for (int r = a; r < e; ++r) s = s + term[r - g0];
    if (e == last)
      p.out[(size_t)n * p.B + b] = s;
    else
      lsum[n] = s;
  }
}

// The screen's latent side x [rows = NL Lt, D] (XT f32 or bf16) and its
// output out [NL, B]: v = (dot + a1) + a2 per column (a1 = -inf past Rt),
// then finish_group.
template <class XT>
struct LatRows {
  const XT* x;
  const float* lsq;
  const float* lvalid;
  float* out;
  int NL, Lt, B, D, rows, group;
  float tau;
  float* term;     // [kRowsTC] in shared memory (tensor-core body)
  float* lsum;     // [NL]
  float* rmax;     // [group] running row maxima (f32 body)

  using Fold = MaxFold;
  static constexpr bool kKeepA = true;   // fragments kept across entries

  // Tensor-core groups: whole latents where a latent fits in 512 rows (a
  // block keeps its group; no partial sums cross blocks), else 512 rows
  // walked in order by every block.
  void plan_tc(Walk& w) {
    w.fixed = Lt <= kRowsTC;
    group = w.fixed ? min(kRowsTC / Lt * Lt, rows) : kRowsTC;
    w.ngroups = (rows + group - 1) / group;
  }
  size_t smem_bytes() const { return padded(kRowsTC * 4) + padded(NL * 4); }
  __device__ void init(unsigned char*& sm) {
    term = reinterpret_cast<float*>(carve(sm, kRowsTC * 4));
    lsum = reinterpret_cast<float*>(carve(sm, NL * 4));
  }
  __device__ int group_rows(int g) const { return min(group, rows - g * group); }

  struct RowState {};
  // The A fragments of rows r0 .. r0 + 63 (zero past rows and past D).
  __device__ void load(uint32_t a[4][kMaxKSteps][4], RowState&, int r0) const {
    const auto one = [](int) { return 1.f; };
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int ks = 0; ks < kMaxKSteps; ++ks)
        load_a(a[m][ks], x, rows, D, r0 + 16 * m, ks, one);
  }
  __device__ float value(float c, float2 u, const RowState&, int, int,
                         bool) const {
    return (c + u.x) + u.y;
  }
  __device__ void finish(const float* part, int slot, int nslot,
                         Step st) const {
    finish_group<XT>([&](int r) { return slot_max(part, slot, nslot, r); },
                     term, lsum, st.b, st.g, *this);
  }
  template <class Src>
  __device__ void finish(const MaxFold& f, float* part, const WarpSplit& sp,
                         Step st, const Src&, const Walk&) const {
    f.to_part(part, sp);
    finish(part, sp.wr * kWarpRows, sp.wc, st);
  }

  // f32 body: v = (dot + a1) + a2 folded into rmax, then finish_group.
  size_t f32_rows_bytes() const {
    return padded((size_t)group * 4) + padded((size_t)NL * 4);
  }
  __device__ void init_f32(unsigned char*& sm) {
    rmax = reinterpret_cast<float*>(carve(sm, (size_t)group * 4));
    lsum = reinterpret_cast<float*>(carve(sm, (size_t)NL * 4));
  }
  __device__ void begin_f32(Step, int gn) const {
    for (int r = threadIdx.x; r < gn; r += kThreads) rmax[r] = -INFINITY;
  }
  // The register tile acc of rows r0 + 4 tr .. of the group against
  // columns 4 tc .. and 64 + 4 tc .. of the step's tile.
  __device__ void fold_f32(const float (&acc)[4][8], const float2* av,
                           int r0, int gn, Step, const Walk&) const {
    const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 u = av[j < 4 ? tc * 4 + j : 64 + tc * 4 + j - 4];
        m = fmaxf(m, (acc[i][j] + u.x) + u.y);
      }
      for (int off = 8; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const int r = r0 + tr * 4 + i;
      if (tc == 0 && r < gn) rmax[r] = fmaxf(rmax[r], m);
    }
  }
  __device__ void finish_f32(Step st) const {
    finish_group<float>([&](int r) { return rmax[r]; }, rmax, lsum, st.b,
                        st.g, *this);
  }
};

// The transposed experiment's latent side xt [Da, M] bf16 (m contiguous)
// and its output raw [B, M] f32 = max_j sum_d dect[b, j, d] xt[d, m]: the
// first Dk = min(Da, 96) features on the tensor cores, then features Dk
// and Dk + 1 (the script's two aug rows, tail <= 2 of them) added in f32 in
// index order: v = (dot + u.x f.x) + u.y f.y with u the column's and f the
// row's two tail values (each product exact in f32).
struct TRows {
  const bf16* xt;
  float* raw;
  int M, Dk, tail, B, rows, group;

  using Fold = MaxFold;
  static constexpr bool kKeepA = true;

  void plan_tc(Walk& w) {
    w.fixed = true;
    group = kRowsTC;
    w.ngroups = (rows + group - 1) / group;
  }
  size_t smem_bytes() const { return 0; }
  __device__ void init(unsigned char*&) {}
  __device__ int group_rows(int g) const { return min(group, rows - g * group); }

  struct RowState {
    float2 f[4][2];   // tail values of rows g, g + 8 of each m-tile
  };
  __device__ float at(int k, int r) const {
    return k < Dk + tail && r < M ? __bfloat162float(xt[(size_t)k * M + r])
                                  : 0.f;
  }
  __device__ uint32_t pair(int k, int r) const {
    return pack(__float2bfloat16_rn(k < Dk ? at(k, r) : 0.f),
                __float2bfloat16_rn(k + 1 < Dk ? at(k + 1, r) : 0.f));
  }
  // A fragments of rows r0 .. r0 + 63 read from the transposed xt (each
  // element once per block), and their tail values.
  __device__ void load(uint32_t a[4][kMaxKSteps][4], RowState& rs,
                       int r0) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int ks = 0; ks < kMaxKSteps; ++ks) {
        const int k = ks * kK + 2 * c;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 16 * m + g + 8 * h;
          a[m][ks][h] = pair(k, r);
          a[m][ks][h + 2] = pair(k + 8, r);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 16 * m + g + 8 * h;
        rs.f[m][h] = make_float2(tail > 0 ? at(Dk, r) : 0.f,
                                 tail > 1 ? at(Dk + 1, r) : 0.f);
      }
    }
  }
  __device__ float value(float c, float2 u, const RowState& rs, int m, int h,
                         bool in) const {
    return in ? (c + u.x * rs.f[m][h].x) + u.y * rs.f[m][h].y : -INFINITY;
  }
  __device__ void finish(const float* part, int slot, int nslot,
                         Step st) const {
    const int g0 = st.g * group, gn = group_rows(st.g);
    __syncthreads();
    for (int r = threadIdx.x; r < gn; r += kThreads)
      raw[(size_t)st.b * M + g0 + r] = slot_max(part, slot, nslot, r);
  }
  template <class Src>
  __device__ void finish(const MaxFold& f, float* part, const WarpSplit& sp,
                         Step st, const Src&, const Walk&) const {
    f.to_part(part, sp);
    finish(part, sp.wr * kWarpRows, sp.wc, st);
  }
};

// ---------------------------------------------------------------------------
// the row max's latent rows: best / bestj, exact
// ---------------------------------------------------------------------------

// The three largest values of a row over some columns, with the columns of
// the first two; a value reached by several columns counts once for each,
// so three columns tied at the top give v3 == v1.
struct Top3 {
  float v1, v2, v3;
  int j1, j2;
};

// The three largest of the values in a and b, with the first two's columns.
__device__ __forceinline__ Top3 merge_top(Top3 a, Top3 b) {
  if (b.v1 > a.v1) {
    const Top3 t = a;
    a = b;
    b = t;
  }
  if (b.v1 > a.v2) {
    a.v3 = fmaxf(a.v2, b.v2);
    a.v2 = b.v1;
    a.j2 = b.j1;
  } else {
    a.v3 = fmaxf(a.v3, b.v1);
  }
  return a;
}

__device__ __forceinline__ Top3 shfl_xor_top(const Top3& t, int off) {
  return Top3{__shfl_xor_sync(0xffffffffu, t.v1, off),
              __shfl_xor_sync(0xffffffffu, t.v2, off),
              __shfl_xor_sync(0xffffffffu, t.v3, off),
              __shfl_xor_sync(0xffffffffu, t.j1, off),
              __shfl_xor_sync(0xffffffffu, t.j2, off)};
}

// The row max's fold on the tensor cores: a Top3 for each of a lane's 8
// rows, branch-free.
struct ArgFold {
  Top3 t[4][2];

  __device__ void reset() {
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        t[m][h] = Top3{-INFINITY, -INFINITY, -INFINITY, 0, 0};
  }
  __device__ __forceinline__ static void put(Top3& a, float v, int j) {
    const bool up1 = v > a.v1, up2 = v > a.v2;
    a.j2 = up1 ? a.j1 : (up2 ? j : a.j2);
    a.j1 = up1 ? j : a.j1;
    a.v3 = fmaxf(a.v3, fminf(v, a.v2));
    a.v2 = fmaxf(a.v2, fminf(v, a.v1));
    a.v1 = fmaxf(a.v1, v);
  }
  __device__ void add(int m, int h, float v0, int j0, float v1, int j1) {
    put(t[m][h], v0, j0);
    put(t[m][h], v1, j1);
  }
};

// ops.rowmax_margin: e = (2^-21 (D + 32) |x_i|_1) max|c| bounds how far
// one column's value on the tensor cores, 2 dot + ((6 - lsq) - rsq), may
// lie from the plain version's before the epilogue's roundings
// (2 TC_SUM_ULPS (D + 32) S, S <= |x_i|_1 max|c| the sum of |products|;
// ops.py states the derivation).
__device__ __forceinline__ float rowmax_margin(float xl1, float cmax, int D) {
  return (ldexpf((float)(D + 32), -21) * xl1) * cmax;
}

// ops.rowmax_threshold: every column whose plain value can be the row's
// maximum has a tensor-core value >= t1 - 2 ((e + 2^-21 |t1|) + 2^-118),
// t1 the tensor-core maximum (the |t1| term covers the epilogue's
// roundings and this expression's own, 2^-118 subnormal products and
// values).
__device__ __forceinline__ float rowmax_threshold(float t1, float e) {
  const float m = (e + fabsf(t1) * 0x1p-21f) + 0x1p-118f;
  return t1 - (m + m);
}

// The row max's group: a work item is (entry, group of rows) and a block
// keeps its group, taking that group's entries in turn with the group's
// other blocks (Walk::fixed, plan_grid), `blocks` blocks in all. Of the
// groups of at most max_group rows (64 rows times a power of two, or all
// the rows in one group, when pow2: the tensor cores' warps split a group
// of 64 w rows evenly only for w a power of two; else any multiple of 64),
// the largest whose share of the blocks' time spent on rows,
// rows B / (waves blocks group), is within 0.02 of the best share.
inline int rowmax_group(int rows, int B, int blocks, int max_group,
                        bool pow2) {
  const int all = (rows + 63) / 64 * 64;
  const auto share = [&](int g) {
    const int ng = (rows + g - 1) / g;
    const int per = max(1, min(B, blocks / ng));
    const int waves = (B + per - 1) / per;
    return (double)rows * B / ((double)waves * blocks * g);
  };
  const auto allowed = [&](int g) {
    return g <= max_group && (!pow2 || g == all || (g & (g - 1)) == 0);
  };
  double top = 0.0;
  for (int g = 64; g <= min(all, max_group); g += 64)
    if (allowed(g)) top = fmax(top, share(g));
  for (int g = min(all, max_group) / 64 * 64; g > 64; g -= 64)
    if (allowed(g) && share(g) >= top - 0.02) return g;
  return 64;
}

// The number of SMs of the current device (1 if it cannot be asked).
inline int sm_count() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess)
    return 1;
  return max(v, 1);
}

// The row max's latent side x [rows = NL Lt, D] (XT f32 or bf16) and its
// outputs best / bestj [NL, B, Lt]: the maximum over an entry's columns j of
//   s_j = (2 dot_j + ((6 - lsq_i) - rsq_j)) + (rvalid_j - 1) 1e30
// and the first j reaching it. The column source's epilogue values are
// (rsq_j, rvalid_j). A work item is (entry, row group); rows do not add
// across a group, so groups are sized to fill the card (rowmax_group) and
// a block keeps its group (a fixed walk).
//   - f32 body: each s_j as the plain version computes it; a thread folds
//     its 8 columns in column order with a strict >, a half-warp merges
//     with the smaller column on equal values, and the running (value,
//     column) of each row sits in shared memory, updated with a strict >
//     (tiles arrive in column order): the first argmax, bit for bit.
//   - tensor cores: s_j with the tensor cores' dot (only the order of its
//     f32 sum differs), invalid columns -inf; each lane keeps a Top3 per
//     row, merged over the quad and the column slots. Then per row, with
//     thr = rowmax_threshold(t1, rowmax_margin(...)): no valid column
//     (t1 = -inf) gives (-1e30, 0), the plain version's value and index
//     for every column at -1e30 (|2 dot + ((6 - lsq) - rsq)| < 2^75, far
//     beyond the matcher's values); v3 >= thr (three or more candidates)
//     sends the row to an exact pass over all its columns by the whole
//     block;
//     else the candidates j1 and, if v2 >= thr, j2 are recomputed in index
//     order (Src::dot_exact) with the plain epilogue and the larger taken,
//     the smaller column on equal values. The exact maximum's column
//     always lies at or above thr, so every path gives the plain version's
//     bits. counts[0..2] add the rows resolved between two candidates, the
//     rows sent to the exact pass and the rows with no valid column.
template <class XT>
struct ArgRows {
  const XT* x;
  const float* lsq;           // [rows]
  const float* rsq;           // [B, Rt]
  const float* rvalid;        // [B, Rt] 0 / 1
  const float* xl1;           // [rows] |x_r|_1 (tensor cores)
  const float* cmax;          // [B] max |c| of each entry (tensor cores)
  float* best;
  int* bestj;
  unsigned long long* counts;  // [3] (tensor cores)
  int NL, Lt, B, Rt, D, rows, group;
  float* sv;                  // [3][kRowsTC] slots' Top3 values
  int* sj;                    // [2][kRowsTC] and columns
  int* over;                  // [kRowsTC] rows for the exact pass, count
  float* rmax;                // [group] running maxima (f32 body)
  int* rarg;                  // [group] and their columns
  float* t6s;                 // [group] 6 - lsq

  using Fold = ArgFold;
  // The fragments are reloaded for every entry (from L2), so that they are
  // dead, and their registers free, while finish refines the rows.
  static constexpr bool kKeepA = false;
  struct RowState {
    float t6[4][2];           // 6 - lsq of rows g, g + 8 of each m-tile
  };

  // Fixed groups of rowmax_group rows.
  void plan(Walk& w, int blocks, int max_group, bool pow2) {
    group = rowmax_group(rows, B, blocks, max_group, pow2);
    w.fixed = true;
    w.E = 1;
    w.ngroups = (rows + group - 1) / group;
  }

  __device__ size_t out_at(int row, int b) const {
    const int n = row / Lt;
    return ((size_t)n * B + b) * Lt + (row - n * Lt);
  }
  // The plain version's s for a dot computed in index order.
  __device__ float simi(float dot, float t6, int b, int j) const {
    const size_t o = (size_t)b * Rt + j;
    return (2.f * dot + (t6 - rsq[o])) + (rvalid[o] - 1.f) * 1e30f;
  }
  __device__ int group_rows(int g) const { return min(group, rows - g * group); }

  // --- tensor cores --------------------------------------------------------
  size_t smem_bytes() const {
    return padded(3 * kRowsTC * 4) + padded(2 * kRowsTC * 4)
        + padded((kRowsTC + 1) * 4);
  }
  __device__ void init(unsigned char*& sm) {
    sv = reinterpret_cast<float*>(carve(sm, 3 * kRowsTC * 4));
    sj = reinterpret_cast<int*>(carve(sm, 2 * kRowsTC * 4));
    over = reinterpret_cast<int*>(carve(sm, (kRowsTC + 1) * 4));
  }
  // The A fragments of rows r0 .. r0 + 63 and 6 - lsq of the lane's rows.
  __device__ void load(uint32_t a[4][kMaxKSteps][4], RowState& rs,
                       int r0) const {
    const auto one = [](int) { return 1.f; };
    const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int ks = 0; ks < kMaxKSteps; ++ks)
        load_a(a[m][ks], x, rows, D, r0 + 16 * m, ks, one);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 16 * m + g + 8 * h;
        rs.t6[m][h] = r < rows ? 6.f - lsq[r] : 0.f;
      }
    }
  }
  __device__ float value(float c, float2 u, const RowState& rs, int m, int h,
                         bool in) const {
    return in && u.y == 1.f ? 2.f * c + (rs.t6[m][h] - u.x) : -INFINITY;
  }
  // Row `row` over all of entry b's columns in index order, by the whole
  // block (thread t takes columns t, t + 256, ..), the first maximum;
  // sv[0..7] / sj[0..7] hold the warps' results. Every thread calls it.
  template <class Src>
  __device__ void exact_row(int row, int b, const Src& src,
                            const Walk& w) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const float t6 = 6.f - lsq[row];
    const XT* xr = x + (size_t)row * D;
    float bv = -INFINITY;
    int bi = 0;
    for (int j = threadIdx.x; j < Rt; j += kThreads) {
      const float s = simi(src.dot_exact(xr, b, j, w), t6, b, j);
      if (s > bv) {
        bv = s;
        bi = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      sv[warp] = bv;
      sj[warp] = bi;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int q = 1; q < kWarps; ++q)
        if (sv[q] > bv || (sv[q] == bv && sj[q] < bi)) {
          bv = sv[q];
          bi = sj[q];
        }
      const size_t o = out_at(row, b);
      best[o] = bv;
      bestj[o] = bi;
    }
    __syncthreads();
  }
  template <class Src>
  __device__ void finish(const ArgFold& f, float*, const WarpSplit& sp,
                         Step st, const Src& src, const Walk& w) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int rw = sp.rw, cw = sp.cw, wc = sp.wc;
    const int slot = sp.wr * kWarpRows;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        Top3 t = f.t[m][h];
        t = merge_top(t, shfl_xor_top(t, 1));
        t = merge_top(t, shfl_xor_top(t, 2));
        const int k = cw * slot + rw * kWarpRows + m * 16 + (lane >> 2)
            + 8 * h;
        if (cw < wc && (lane & 3) == 0) {
          sv[k] = t.v1;
          sv[kRowsTC + k] = t.v2;
          sv[2 * kRowsTC + k] = t.v3;
          sj[k] = t.j1;
          sj[kRowsTC + k] = t.j2;
        }
      }
    if (threadIdx.x == 0) over[kRowsTC] = 0;
    __syncthreads();
    const int g0 = st.g * group, gn = group_rows(st.g), b = st.b;
    unsigned refined = 0, empty = 0;
    for (int r = threadIdx.x; r < gn; r += kThreads) {
      Top3 t{sv[r], sv[kRowsTC + r], sv[2 * kRowsTC + r], sj[r],
             sj[kRowsTC + r]};
      for (int q = 1; q < wc; ++q) {
        const int k = q * slot + r;
        t = merge_top(t, Top3{sv[k], sv[kRowsTC + k], sv[2 * kRowsTC + k],
                              sj[k], sj[kRowsTC + k]});
      }
      const int row = g0 + r;
      const size_t o = out_at(row, b);
      if (t.v1 == -INFINITY) {
        best[o] = -1e30f;
        bestj[o] = 0;
        ++empty;
        continue;
      }
      const float thr = rowmax_threshold(
          t.v1, rowmax_margin(xl1[row], cmax[b], D));
      if (t.v3 >= thr) {
        over[atomicAdd(&over[kRowsTC], 1)] = row;
        continue;
      }
      const float t6 = 6.f - lsq[row];
      const XT* xr = x + (size_t)row * D;
      float s = simi(src.dot_exact(xr, b, t.j1, w), t6, b, t.j1);
      int j = t.j1;
      if (t.v2 >= thr) {
        ++refined;
        const float s2 = simi(src.dot_exact(xr, b, t.j2, w), t6, b, t.j2);
        if (s2 > s || (s2 == s && t.j2 < j)) {
          s = s2;
          j = t.j2;
        }
      }
      best[o] = s;
      bestj[o] = j;
    }
    __syncthreads();
    const int n_over = over[kRowsTC];
    for (int k = 0; k < n_over; ++k) exact_row(over[k], b, src, w);
    refined = __reduce_add_sync(0xffffffffu, refined);
    empty = __reduce_add_sync(0xffffffffu, empty);
    if (lane == 0 && refined) atomicAdd(&counts[0], (unsigned long long)refined);
    if (lane == 0 && empty) atomicAdd(&counts[2], (unsigned long long)empty);
    if (threadIdx.x == 0 && n_over)
      atomicAdd(&counts[1], (unsigned long long)n_over);
  }

  // --- f32 body ------------------------------------------------------------
  size_t f32_rows_bytes() const { return 3 * padded((size_t)group * 4); }
  __device__ void init_f32(unsigned char*& sm) {
    rmax = reinterpret_cast<float*>(carve(sm, (size_t)group * 4));
    rarg = reinterpret_cast<int*>(carve(sm, (size_t)group * 4));
    t6s = reinterpret_cast<float*>(carve(sm, (size_t)group * 4));
  }
  __device__ void begin_f32(Step st, int gn) const {
    for (int r = threadIdx.x; r < gn; r += kThreads) {
      rmax[r] = -INFINITY;
      rarg[r] = 0;
      t6s[r] = 6.f - lsq[st.g * group + r];
    }
  }
  __device__ void fold_f32(const float (&acc)[4][8], const float2* av,
                           int r0, int gn, Step st, const Walk& w) const {
    const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
    const int ncols = w.ncols(st.t), c0 = st.t * w.ct;
    float cr[8], mk[8];
    int col[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      col[j] = j < 4 ? tc * 4 + j : 64 + tc * 4 + j - 4;
      const float2 u = av[col[j]];
      cr[j] = u.x;
      mk[j] = (u.y - 1.f) * 1e30f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + tr * 4 + i;
      const float t6 = t6s[min(r, gn - 1)];
      float bv = -INFINITY;
      int bi = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float s = (2.f * acc[i][j] + (t6 - cr[j])) + mk[j];
        if (col[j] < ncols && s > bv) {
          bv = s;
          bi = c0 + col[j];
        }
      }
      for (int off = 8; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (tc == 0 && r < gn && bv > rmax[r]) {
        rmax[r] = bv;
        rarg[r] = bi;
      }
    }
  }
  __device__ void finish_f32(Step st) const {
    const int g0 = st.g * group, gn = group_rows(st.g);
    for (int r = threadIdx.x; r < gn; r += kThreads) {
      const size_t o = out_at(g0 + r, st.b);
      best[o] = rmax[r];
      bestj[o] = rarg[r];
    }
  }
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// Src: smem_bytes(), init(sm), a register state In, begin(in, st, w) and
// stage(in, i, st, nx, w) -> Tile {dt: the step's bf16 tile [n][kLd];
// aug(col): the column's two f32 epilogue values}, the tile complete and
// visible to every thread when stage returns.
template <class Src, class Rows>
__global__ void __launch_bounds__(kThreads, 1) screen_tc_kernel(
    Src src, Rows rows, Walk w) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sm = smem;
  float* part = reinterpret_cast<float*>(carve(sm, kRowsTC * 4));
  rows.init(sm);
  src.init(sm);
  Step st = w.first();
  if (st.b >= w.B) return;
  const int lane = threadIdx.x & 31;
  typename Src::In in;
  src.begin(in, st, w);

  uint32_t a[4][kMaxKSteps][4];   // this warp's 64 rows, all of D
  typename Rows::RowState rs;
  typename Rows::Fold fo;         // rows g, g + 8 of each m-tile
  int loaded = -1;
  WarpSplit sp{0, 0, 0, 0};
  for (int i = 0; st.b < w.B; ++i) {
    const Step nx = w.next(st);
    const auto tl = src.stage(in, i, st, nx, w);
    if (st.t == 0) {
      sp.set(rows.group_rows(st.g));
      if (!Rows::kKeepA || st.g != loaded) {
        rows.load(a, rs, st.g * rows.group + sp.rw * kWarpRows);
        loaded = w.fixed || w.ngroups == 1 ? st.g : -1;
      }
      fo.reset();
    }
    if (sp.cw < sp.wc) {
      const int ncols = w.ncols(st.t);
      const int nn = (ncols + 7) >> 3;
      const int cq = lane & 3;
      for (int n = 2 * sp.cw; n < nn; n += 2 * sp.wc) {   // n, n + 1
        const bool two = n + 1 < nn;
        uint32_t b[2][3][4];
        float acc[2][4][4];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (q == 1 && !two) break;
#pragma unroll
          for (int j = 0; j < 3; ++j)
            load_b2(b[q][j], tl.dt, kLd, (n + q) * 8, j);
#pragma unroll
          for (int m = 0; m < 4; ++m)
            acc[q][m][0] = acc[q][m][1] = acc[q][m][2] = acc[q][m][3] = 0.f;
        }
#pragma unroll
        for (int ks = 0; ks < kMaxKSteps; ++ks)
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int j = ks >> 1, h = (ks & 1) * 2;
            mma_bf16(acc[0][m], a[m][ks], b[0][j][h], b[0][j][h + 1]);
            if (two) mma_bf16(acc[1][m], a[m][ks], b[1][j][h], b[1][j][h + 1]);
          }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (q == 1 && !two) break;
          const int col = (n + q) * 8 + 2 * cq;
          const int j = st.t * w.ct + col;           // the entry's column
          const float2 u0 = tl.aug(col), u1 = tl.aug(col + 1);
          const bool in0 = col < ncols, in1 = col + 1 < ncols;
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const float* c = acc[q][m];
            fo.add(m, 0, rows.value(c[0], u0, rs, m, 0, in0), j,
                   rows.value(c[1], u1, rs, m, 0, in1), j + 1);
            fo.add(m, 1, rows.value(c[2], u0, rs, m, 1, in0), j,
                   rows.value(c[3], u1, rs, m, 1, in1), j + 1);
          }
        }
      }
    }
    if (st.t == w.ntiles - 1)
      rows.finish(fo, part, sp, st, src, w);
    st = nx;
  }
}

// Columns copied from predecoded descriptors dec [B, Rt, Ds] (T bf16, or
// int8 widened to bf16 exactly: |v| <= 128 fits bf16's 8-bit significand)
// into a ring of kStages stages by cp.async, `chunk` bytes a copy (16 when
// the rows allow it, else 8 or 4; 0: plain loads, for rows of odd length),
// so two tiles load while one runs on the tensor cores. The first Dk
// features of a column go to the tile; its epilogue values are, with
// kTail, features Dk and Dk + 1 (TRows; kept as a bf16 pair), else a1 / a2
// [B, Rt] (LatRows; a1 = -inf past Rt). A bf16 stage is the tile itself;
// an int8 stage is converted into one of two bf16 tiles once it has
// arrived.
template <class T, bool kTail>
struct CopyTC {
  static constexpr bool kWide = std::is_same<T, int8_t>::value;
  const T* dec;
  const float* a1;
  const float* a2;
  int Ds, Dk, tail, chunk;
  unsigned char* raw;    // [kStages][kCT][ldr()]
  float2* av;            // [kStages][kCT] (!kTail)
  uint32_t* tw;          // [kStages][kCT] (kTail)
  bf16* tile;            // [2][kCT][kLd] (int8)

  __host__ __device__ int ldr() const {
    return kWide ? (int)padded(Dk) : kLd * 2;
  }
  size_t smem_bytes() const {
    return padded((size_t)kStages * kCT * ldr())
        + padded((size_t)kStages * kCT * (kTail ? 4 : 8))
        + (kWide ? padded(2 * kCT * kLd * 2) : 0);
  }
  __device__ void init(unsigned char*& sm) {
    raw = carve(sm, (size_t)kStages * kCT * ldr());
    if (kTail)
      tw = reinterpret_cast<uint32_t*>(carve(sm, kStages * kCT * 4));
    else
      av = reinterpret_cast<float2*>(carve(sm, kStages * kCT * 8));
    if (kWide) tile = reinterpret_cast<bf16*>(carve(sm, 2 * kCT * kLd * 2));
    // features past Dk (and columns never copied) stay zero in every tile
    bf16* z = kWide ? tile : reinterpret_cast<bf16*>(raw);
    const int n = (kWide ? 2 : kStages) * kCT * kLd;
    for (int i = threadIdx.x; i < n; i += kThreads)
      z[i] = __float2bfloat16_rn(0.f);
  }

  struct In {
    Step ahead;          // the next step to issue
  };
  struct Tile {
    const bf16* dt;
    const float2* av;
    const uint32_t* tw;
    __device__ float2 aug(int col) const {
      if (!kTail) return av[col];
      const uint32_t v = tw[col];
      return make_float2(__uint_as_float(v << 16),
                         __uint_as_float(v & 0xffff0000u));
    }
  };

  // Starts the copies of step s into stage `stage` (plain stores for the
  // padding and the plain path); nothing past the last entry.
  __device__ void issue(Step s, int stage, const Walk& w) {
    if (s.b >= w.B) return;
    const int c0 = s.t * w.ct, ncols = w.ncols(s.t);
    const T* src = dec + ((size_t)s.b * w.Rt + c0) * Ds;
    unsigned char* dst = raw + (size_t)stage * kCT * ldr();
    if (chunk) {
      const int per = Dk * (int)sizeof(T) / chunk;
      for (int e = threadIdx.x; e < ncols * per; e += kThreads) {
        const int n = e / per, q = e - n * per;
        cp_async(dst + n * ldr() + q * chunk,
                 reinterpret_cast<const unsigned char*>(src + (size_t)n * Ds)
                     + q * chunk, chunk);
      }
    } else {
      for (int e = threadIdx.x; e < ncols * Dk; e += kThreads) {
        const int n = e / Dk, k = e - n * Dk;
        reinterpret_cast<T*>(dst + n * ldr())[k] = src[(size_t)n * Ds + k];
      }
    }
    for (int n = threadIdx.x; n < kCT; n += kThreads) {
      if (kTail) {
        uint32_t* t = tw + stage * kCT + n;
        if (n >= ncols || tail == 0) {
          *t = 0u;
        } else if (chunk && tail == 2) {
          cp_async(t, src + (size_t)n * Ds + Dk, 4);
        } else {
          const bf16* r = reinterpret_cast<const bf16*>(src) + (size_t)n * Ds;
          *t = pack(r[Dk], tail > 1 ? r[Dk + 1] : __float2bfloat16_rn(0.f));
        }
      } else {
        float2* u = av + stage * kCT + n;
        if (n < ncols) {
          const size_t o = (size_t)s.b * w.Rt + c0 + n;
          cp_async(&u->x, a1 + o, 4);
          cp_async(&u->y, a2 + o, 4);
        } else {
          *u = make_float2(-INFINITY, 0.f);
        }
      }
    }
  }

  // The dot of latent row xr with column j of entry b in index order, one
  // rounding per product and per sum (the plain version's order).
  template <class XT>
  __device__ float dot_exact(const XT* xr, int b, int j,
                             const Walk& w) const {
    const T* c = dec + ((size_t)b * w.Rt + j) * Ds;
    float acc = 0.f;
    int d = 0;
#pragma unroll 4
    for (; d + 8 <= Dk; d += 8) {      // 8 at a time: the loads run ahead
      float xv[8], cv[8];
      load8(xr + d, xv);
      load8(c + d, cv);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        acc = __fadd_rn(acc, __fmul_rn(xv[k], cv[k]));
    }
    for (; d < Dk; ++d)
      acc = __fadd_rn(acc, __fmul_rn(afis_t::widen(xr[d]),
                                     afis_t::widen(c[d])));
    return acc;
  }

  __device__ void begin(In& in, Step st, const Walk& w) {
    __syncthreads();                    // the zeroed tiles
    in.ahead = st;
#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) {
      issue(in.ahead, k, w);
      cp_commit();
      in.ahead = w.next(in.ahead);
    }
  }

  __device__ Tile stage(In& in, int i, Step st, Step, const Walk& w) {
    cp_wait<kStages - 2>();             // this thread's copies of step i
    __syncthreads();                    // everyone's; step i - 1 is done
    issue(in.ahead, (i + kStages - 1) % kStages, w);
    cp_commit();
    in.ahead = w.next(in.ahead);
    const int s = i % kStages;
    const unsigned char* rs = raw + (size_t)s * kCT * ldr();
    Tile tl{reinterpret_cast<const bf16*>(rs), av + s * kCT, tw + s * kCT};
    if (kWide) {
      bf16* dt = tile + (i & 1) * kCT * kLd;
      const int ncols = w.ncols(st.t);
      if ((Dk & 15) == 0) {
        const int per = Dk >> 4;
        for (int e = threadIdx.x; e < ncols * per; e += kThreads) {
          const int n = e / per, q = e - n * per;
          const uint4 v = *reinterpret_cast<const uint4*>(rs + n * ldr()
                                                          + 16 * q);
          const uint32_t wv[4] = {v.x, v.y, v.z, v.w};
          uint32_t o[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const uint32_t word = wv[k >> 1] >> (16 * (k & 1));
            o[k] = pack(__float2bfloat16_rn((float)(int8_t)(word & 0xff)),
                        __float2bfloat16_rn((float)(int8_t)(word >> 8)));
          }
          uint4* d = reinterpret_cast<uint4*>(dt + n * kLd + 16 * q);
          d[0] = make_uint4(o[0], o[1], o[2], o[3]);
          d[1] = make_uint4(o[4], o[5], o[6], o[7]);
        }
      } else {
        for (int e = threadIdx.x; e < ncols * Dk; e += kThreads) {
          const int n = e / Dk, k = e - n * Dk;
          dt[n * kLd + k] = __float2bfloat16_rn(
              (float)reinterpret_cast<const int8_t*>(rs + n * ldr())[k]);
        }
      }
      __syncthreads();
      tl.dt = dt;
    }
    return tl;
  }
};

// ---------------------------------------------------------------------------
// f32: CUDA cores, bit for bit the plain version
// ---------------------------------------------------------------------------

// Starts copying latent rows row0 .. row0 + n - 1 (of [rows, D]) into
// xs[d][r] (stride kLdx), zero past n; 8 neighbouring threads copy 8
// neighbouring features of one row (one 32-byte sector). The copies are
// asynchronous, so the first tile of a step loads while the block stages
// its columns.
__device__ __forceinline__ void fetch_rows(float* xs, const float* x,
                                           int row0, int n, int D) {
  const int d8 = (D + 7) >> 3;
  for (int e = threadIdx.x; e < kRowTile * d8 * 8; e += kThreads) {
    const int lo = e & 7, r = (e >> 3) % kRowTile, hi = (e >> 3) / kRowTile;
    const int d = hi * 8 + lo;
    if (d >= D) continue;
    float* dst = xs + d * kLdx + r;
    if (r < n)
      cp_async(dst, x + (size_t)(row0 + r) * D + d, 4);
    else
      *dst = 0.f;
  }
  cp_commit();
}

// Shared memory of the f32 body beside the source's own: the column tile,
// a row tile, the tile's epilogue values and the rows' running state.
template <class Rows>
size_t f32_smem_bytes(const Rows& rows) {
  return padded((size_t)rows.D * kCT * 4) + padded((size_t)rows.D * kLdx * 4)
      + padded(kCT * 8) + rows.f32_rows_bytes();
}

// f32 groups: up to kMaxRowsF32 rows, walked in order by every block.
inline void plan_f32(LatRows<float>& p, Walk& w) {
  p.group = min((p.rows + kRowTile - 1) / kRowTile * kRowTile, kMaxRowsF32);
  w.ngroups = (p.rows + p.group - 1) / p.group;
  w.fixed = false;
}

// Src: smem_bytes(), init(sm), a register state In, fetch(in, st, w) (the
// next tile's inputs, while the current one computes) and store(in, ds, av,
// st, w) (the step's tile, widened to f32, into ds [D][kCT], and a1 / a2
// into av, a1 = -inf past Rt; the caller synchronizes). Rows: x [rows, D]
// f32, group, f32_rows_bytes(), init_f32(sm), begin_f32(st, gn) (a
// group's first tile), fold_f32(acc, av, r0, gn, st, w) (a register tile) and
// finish_f32(st) (the group's last tile).
template <class Src, class Rows>
__global__ void __launch_bounds__(kThreads, 1) screen_f32_kernel(
    Src src, Rows p, Walk w) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sm = smem;
  float* ds = reinterpret_cast<float*>(carve(sm, (size_t)p.D * kCT * 4));
  float* xs = reinterpret_cast<float*>(carve(sm, (size_t)p.D * kLdx * 4));
  float2* av = reinterpret_cast<float2*>(carve(sm, kCT * 8));
  p.init_f32(sm);
  src.init(sm);

  Step st = w.first();
  if (st.b >= w.B) return;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  typename Src::In in;
  src.fetch(in, st, w);

  while (st.b < w.B) {
    const int g0 = st.g * p.group, gn = min(p.group, p.rows - g0);
    __syncthreads();     // the source's set-up, or the last tile's readers
    if (st.t == 0) p.begin_f32(st, gn);
    fetch_rows(xs, p.x, g0, min(kRowTile, gn), p.D);
    src.store(in, ds, av, st, w);
    const Step nx = w.next(st);
    if (nx.b < w.B) src.fetch(in, nx, w);
    for (int r0 = 0; r0 < gn; r0 += kRowTile) {
      if (r0 > 0) fetch_rows(xs, p.x, g0 + r0, min(kRowTile, gn - r0), p.D);
      cp_wait<0>();
      __syncthreads();   // the row tile, the column tile and av are in place
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < p.D; ++d) {
        const float4 xv = *reinterpret_cast<const float4*>(
            xs + d * kLdx + tr * 4);
        const float4 c0 = *reinterpret_cast<const float4*>(
            ds + d * kCT + tc * 4);
        const float4 c1 = *reinterpret_cast<const float4*>(
            ds + d * kCT + 64 + tc * 4);
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
        const float dc[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(xr[i], dc[j]));
      }
      p.fold_f32(acc, av, r0, gn, st, w);
      __syncthreads();   // readers of the row tile are done
    }
    if (st.t == w.ntiles - 1) p.finish_f32(st);
    st = nx;
  }
}

// Columns copied from predecoded descriptors dec [B, Rt, D] (T f32, or
// int8 widened exactly) at the top of their step, each thread 4 features
// of one column at a time (neighbouring threads take neighbouring columns,
// so the d-major stores hit distinct banks), with plain loads: a 512-row
// step computes for ~100 us against the tile's ~2 us.
template <class T>
struct CopyF32 {
  const T* dec;
  const float* a1;
  const float* a2;
  int D;
  bool vec;      // 4 features per load (D % 4 == 0, aligned)

  size_t smem_bytes() const { return 0; }
  __device__ void init(unsigned char*&) {}
  struct In {};
  __device__ void fetch(In&, Step, const Walk&) {}
  __device__ void store(In&, float* ds, float2* av, Step st,
                        const Walk& w) const {
    const int c0 = st.t * w.ct, ncols = w.ncols(st.t);
    const T* src = dec + ((size_t)st.b * w.Rt + c0) * D;
    if (vec) {
      const int per = D >> 2;
      for (int e = threadIdx.x; e < ncols * per; e += kThreads) {
        const int n = e % ncols, q = e / ncols;
        float v[4];
        if constexpr (std::is_same<T, float>::value) {
          const float4 f = *reinterpret_cast<const float4*>(
              src + (size_t)n * D + 4 * q);
          v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
        } else {
          const char4 f = *reinterpret_cast<const char4*>(
              src + (size_t)n * D + 4 * q);
          v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) ds[(4 * q + k) * kCT + n] = v[k];
      }
    } else {
      for (int e = threadIdx.x; e < ncols * D; e += kThreads) {
        const int n = e % ncols, d = e / ncols;
        ds[d * kCT + n] = afis_t::widen(src[(size_t)n * D + d]);
      }
    }
    for (int n = threadIdx.x; n < kCT; n += kThreads) {
      const size_t o = (size_t)st.b * w.Rt + c0 + n;
      av[n] = n < ncols ? make_float2(a1[o], a2[o])
                        : make_float2(-INFINITY, 0.f);
    }
  }
};

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// The widest cp.async (16, 8 or 4 bytes) that every row of Ds elements of
// dec, and its first Dk, start and end on; 0 when none does.
template <class T>
int copy_chunk(const T* dec, int Ds, int Dk) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dec);
  for (int c = 16; c >= 4; c >>= 1)
    if ((Ds * sizeof(T)) % c == 0 && (Dk * sizeof(T)) % c == 0 && a % c == 0)
      return c;
  return 0;
}

// The shared memory a block may opt in to on the current device (0 if the
// device cannot be asked).
inline size_t smem_optin() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev) != cudaSuccess)
    return 0;
  return (size_t)v;
}

template <class Src, class Rows>
size_t tc_smem_bytes(const Src& src, const Rows& rows) {
  return padded(kRowsTC * 4) + rows.smem_bytes() + src.smem_bytes();
}

// Opts the kernel in to `smem` bytes and sets the grid: with w.fixed,
// ngroups x (blocks per group), the blocks per group as many as fit
// beside the other groups' (at least one, at most one per E entries);
// else one block per entry up to what the card holds at once.
template <class Kernel>
int plan_grid(Kernel kernel, size_t smem, const Walk& w, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long cap = (long long)sms * per_sm;
  if (w.fixed) {
    const long long per = max(1LL, min((long long)(w.B + w.E - 1) / w.E,
                                       cap / w.ngroups));
    if (per * w.ngroups > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    *grid = (int)(per * w.ngroups);
  } else {
    *grid = (int)min((long long)w.B, cap);
  }
  return (int)cudaSuccess;
}

template <class Src, class Rows>
int launch_tc(Src src, Rows rows, Walk w, void* stream) {
  const size_t smem = tc_smem_bytes(src, rows);
  int grid = 0;
  const int e = plan_grid(screen_tc_kernel<Src, Rows>, smem, w, &grid);
  if (e != (int)cudaSuccess) return e;
  screen_tc_kernel<Src, Rows><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      src, rows, w);
  return (int)cudaGetLastError();
}

template <class Src, class Rows>
int launch_f32(Src src, Rows rows, Walk w, void* stream) {
  const size_t smem = f32_smem_bytes(rows) + src.smem_bytes();
  int grid = 0;
  const int e = plan_grid(screen_f32_kernel<Src, Rows>, smem, w, &grid);
  if (e != (int)cudaSuccess) return e;
  screen_f32_kernel<Src, Rows>
      <<<grid, kThreads, smem, (cudaStream_t)stream>>>(src, rows, w);
  return (int)cudaGetLastError();
}

}  // namespace afis_screen
