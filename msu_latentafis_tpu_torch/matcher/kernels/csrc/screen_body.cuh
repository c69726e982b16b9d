// The bodies of the ADC screens, shared by the predecoded screen
// (adc_screen.cu), the codes-resident screen (adc_screen_codes.cu) and the
// experiment's transposed bf16 screen (screen_t.cu). Each screen takes the
// maxima over one entry's Rt rolled columns of the dots of many latent rows
// against them; persistent blocks (about one per SM) walk the entries:
//
//   - screen_tc_kernel<Src, Rows>: bf16 latent rows on the tensor cores,
//     mma.sync.m16n8k16 bf16 x bf16 -> f32 (mma.cuh). A group is up to 512
//     latent rows, 64 per warp, whose A fragments stay in registers; the
//     entry's columns arrive in tiles of 128 stored [n][kLd] bf16 in shared
//     memory and feed ldmatrix; each warp folds its row maxima from the
//     accumulators, then a quad shuffle and a maximum over the warps that
//     split the columns.
//   - screen_f32_kernel<Src>: f32 on the CUDA cores, each dot in index
//     order with one rounding per product and per sum (--fmad=false), bit
//     for bit the plain version. The entry's column tile is staged once,
//     widened to f32 and stored d-major; the latent rows stream from L2 in
//     64-row cp.async tiles against it; 256 threads hold 4 x 8 register
//     tiles (float4 reads); the running row maxima sit in shared memory.
//
// The column source (Src) says where a tile comes from: decoded from PQ
// codes (adc_screen_codes.cu), or copied from predecoded descriptors
// (CopyTC / CopyF32 below: bf16 as it is, int8 widened exactly, f32 as it
// is). The rows (Rows) say what the latent side is and what a row maximum
// becomes: LatRows, the screen's latents [NL, Lt, D], rows rounded to x's
// type and summed into per-latent terms (finish_group); TRows, the
// transposed experiment's xt [Da, M] and its raw maxima [B, M].
//
// Sources with the same tile and the same rows run the same instructions
// in the same order, so the codes and predecoded screens give the same bits
// on the same entry in bf16 (tensor cores) as in f32 (CUDA cores).
#pragma once

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

// ---------------------------------------------------------------------------
// cp.async
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const uint32_t d = smem_addr(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
    finish_group<XT>([&](int r) {
      float v = part[r];
      for (int q = 1; q < nslot; ++q) v = fmaxf(v, part[q * slot + r]);
      return v;
    }, term, lsum, st.b, st.g, *this);
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
    for (int r = threadIdx.x; r < gn; r += kThreads) {
      float v = part[r];
      for (int q = 1; q < nslot; ++q) v = fmaxf(v, part[q * slot + r]);
      raw[(size_t)st.b * M + g0 + r] = v;
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
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  typename Src::In in;
  src.begin(in, st, w);

  uint32_t a[4][kMaxKSteps][4];   // this warp's 64 rows, all of D
  typename Rows::RowState rs;
  float mx[4][2];                 // running maxima of rows g, g + 8
  int loaded = -1, wr = 0, wc = 0, rw = 0, cw = 0;
  for (int i = 0; st.b < w.B; ++i) {
    const Step nx = w.next(st);
    const auto tl = src.stage(in, i, st, nx, w);
    if (st.t == 0) {
      // warps split a group as wr row slots x wc column slots
      const int gn = rows.group_rows(st.g);
      wr = (gn + kWarpRows - 1) / kWarpRows;
      wc = kWarps / wr;
      rw = warp % wr;
      cw = warp / wr;
      if (st.g != loaded) {
        rows.load(a, rs, st.g * rows.group + rw * kWarpRows);
        loaded = w.fixed || w.ngroups == 1 ? st.g : -1;
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) mx[m][0] = mx[m][1] = -INFINITY;
    }
    if (cw < wc) {
      const int ncols = w.ncols(st.t);
      const int nn = (ncols + 7) >> 3;
      const int cq = lane & 3;
      for (int n = 2 * cw; n < nn; n += 2 * wc) {   // n-tiles n, n + 1
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
          const float2 u0 = tl.aug(col), u1 = tl.aug(col + 1);
          const bool in0 = col < ncols, in1 = col + 1 < ncols;
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const float* c = acc[q][m];
            mx[m][0] = fmaxf(mx[m][0],
                             fmaxf(rows.value(c[0], u0, rs, m, 0, in0),
                                   rows.value(c[1], u1, rs, m, 0, in1)));
            mx[m][1] = fmaxf(mx[m][1],
                             fmaxf(rows.value(c[2], u0, rs, m, 1, in0),
                                   rows.value(c[3], u1, rs, m, 1, in1)));
          }
        }
      }
    }
    if (st.t == w.ntiles - 1) {
      // quad lanes hold the same rows: reduce, then one max per column slot
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = mx[m][h];
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
          const int r = rw * kWarpRows + m * 16 + (lane >> 2) + 8 * h;
          if (cw < wc && (lane & 3) == 0) part[cw * wr * kWarpRows + r] = v;
        }
      rows.finish(part, wr * kWarpRows, wc, st);
    }
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

// Shared memory of the f32 body beside the source's own.
inline size_t f32_smem_bytes(int D, int group, int NL) {
  return padded((size_t)D * kCT * 4) + padded((size_t)D * kLdx * 4)
      + padded(kCT * 8) + padded((size_t)group * 4) + padded((size_t)NL * 4);
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
// into av, a1 = -inf past Rt; the caller synchronizes).
template <class Src>
__global__ void __launch_bounds__(kThreads, 1) screen_f32_kernel(
    Src src, LatRows<float> p, Walk w) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sm = smem;
  float* ds = reinterpret_cast<float*>(carve(sm, (size_t)p.D * kCT * 4));
  float* xs = reinterpret_cast<float*>(carve(sm, (size_t)p.D * kLdx * 4));
  float2* av = reinterpret_cast<float2*>(carve(sm, kCT * 8));
  float* rmax = reinterpret_cast<float*>(carve(sm, (size_t)p.group * 4));
  float* lsum = reinterpret_cast<float*>(carve(sm, (size_t)p.NL * 4));
  src.init(sm);

  Step st = w.first();
  if (st.b >= w.B) return;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  typename Src::In in;
  src.fetch(in, st, w);

  while (st.b < w.B) {
    const int g0 = st.g * p.group, gn = min(p.group, p.rows - g0);
    __syncthreads();     // the source's set-up, or the last tile's readers
    if (st.t == 0)
      for (int r = tid; r < gn; r += kThreads) rmax[r] = -INFINITY;
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
      __syncthreads();   // readers of the row tile are done
    }
    if (st.t == w.ntiles - 1)
      finish_group<float>([&](int r) { return rmax[r]; }, rmax, lsum, st.b,
                          st.g, p);
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

template <class Src>
int launch_f32(Src src, LatRows<float> rows, Walk w, void* stream) {
  const size_t smem = f32_smem_bytes(rows.D, rows.group, rows.NL)
      + src.smem_bytes();
  int grid = 0;
  const int e = plan_grid(screen_f32_kernel<Src>, smem, w, &grid);
  if (e != (int)cudaSuccess) return e;
  screen_f32_kernel<Src><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      src, rows, w);
  return (int)cudaGetLastError();
}

}  // namespace afis_screen
