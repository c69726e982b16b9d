// The bf16 ADC screens' body on Hopper's warpgroup tensor cores: the
// predecoded screen (adc_screen.cu, bf16 or int8 gallery) and the
// codes-resident screen (adc_screen_codes.cu, bf16 codebook), bf16 latents
// with D <= 96. It replaces, for these launches, screen_body.cuh's
// mma.sync body; with it the port's kernels stand in for the JAX package's
// pallas_kernels.py fused_adc_screen (:1106, pallas_call :1155) and
// fused_adc_screen_codes (:1213, pallas_call :1240) in the bf16 modes.
//
// What it computes (screen_body.cuh's LatRows): for every latent row i of
// a group and every column j of the entry, v = (x_i . c_j + a1_j) + a2_j
// (a1 = -inf past Rt), raw_i = max_j v rounded to bf16, then
// max(2 raw + ((6 - lsq) - tau), 0) lvalid summed per latent in row order
// (finish_group). Products are exact in f32 (bf16 x bf16, or int8 widened
// to bf16 exactly); only the order of the f32 sums differs from the plain
// version (ops.screen_slack).
//
// Bound: operations, 2 NL Lt Rt D flops per entry: 44 MFLOP at the
// serving prescreen (NL 8 x Lt 64, Rt 448, D 96), 4.40 TFLOP a batch over
// 100,000 entries, 4.45 ms at 989 TFLOP/s, against 4.3 GB of int8 gallery
// (1.3 ms at 3.35 TB/s); 7 KB of codes an entry at Rt 448.
//
// Design: a block of three warpgroups on each SM, persistent, walking
// (entry, row group) work items as before (Walk; a group is up to 512
// rows of whole latents, kept for the block's life, or 512 rows walked
// per entry for latents longer than that):
//   - the producer warpgroup (56 registers a thread, setmaxnreg): its warps
//     0-2 keep the entry's columns coming in tiles of 128. One thread
//     starts a 1-D bulk copy (cp.async.bulk) of the tile's raw bytes (int8
//     or bf16 rows, or uint8 codes) into a ring of four stages, completing
//     on an mbarrier; the 96 threads then widen int8 to bf16 exactly, copy
//     bf16, or decode codes from the block's codebook copy, straight into
//     the K-major core-matrix layout wgmma reads (8 columns x 16 bytes of
//     k a 128-byte core matrix), in a ring of four B stages with the
//     tile's a1 / a2 (read a tile ahead). Rows whose bytes are not 16-byte
//     multiples are copied by plain loads. Its warp 3 finishes groups: the
//     consumers hand it a group's row maxima through a double buffer, and
//     it rounds them, forms the terms and sums them per latent in row
//     order (finish_group) while the others convert the next tiles;
//   - two consumer warpgroups (224 registers) hold up to four 64-row tiles
//     each: the A fragments of all 96 features stay in registers for the
//     group's life (96 registers), and the running row maxima too. For
//     each 64 columns a warpgroup runs its tiles in turns: wgmma.mma_async
//     m64n64k16 (bf16 x bf16 -> f32, 6 k-steps a tile) into one of two
//     accumulator sets, then the fold of the previous tile's products,
//     which ran meanwhile: (acc + a1) + a2 into its row maxima, or acc + a1
//     where every a2 of the 64 columns is zero. The two warpgroups take
//     turns to issue (named barriers, ping-pong), so their products queue
//     on the tensor cores one warpgroup at a time.
// Groups are split over the two warpgroups by 64-row tiles (512 rows: 4 +
// 4, a 448-row latent: 4 + 3), so every warp is busy in both. On the same
// entry the codes and the predecoded screens write the same B tile and run
// the same instructions: the same bits.
//
// On an H100 SXM (700 W), one 16,384-entry chunk at the serving shapes:
// the folds are what keeps the body from its bound. Without them the same
// kernel reaches 51-72% of the bf16 peak; with them 32-45%: their ALU
// work does not hide under the other warpgroup's products.
#pragma once

#include "codes_src.cuh"
#include "wgmma.cuh"

namespace afis_screen {

using namespace afis_wg;

constexpr int kWgThreads = 384;     // producer warpgroup + two consumers
constexpr int kConvThreads = 96;    // producer warps 0-2 (warp 3 finishes)
constexpr int kConsThreads = 256;
constexpr int kProdRegs = 56, kConsRegs = 224;
constexpr int kSubCols = 64;        // columns a product (m64n64k16)
constexpr int kCore = 128;          // a core matrix: 8 columns x 16 bytes
constexpr int kGroupBytes = kDMax / 8 * kCore;     // 8 columns, all of k
constexpr int kStageBytes = kCT / 8 * kGroupBytes;  // a B stage: 24,576
constexpr int kBStages = 4;
constexpr int kRawStages = 4;
constexpr int kMTiles = 4;          // 64-row tiles a consumer warpgroup holds
constexpr int kGroupRows = 2 * kMTiles * 64;       // rows a group
constexpr int kBars = 2 * kBStages + kRawStages + 4;
enum { kBarProd = 1, kBarTurn = 2 };   // named barriers (turns: 2 and 3)

// Where feature k of column n sits in a B stage.
__device__ __forceinline__ int b_at(int n, int k) {
  return (n >> 3) * kGroupBytes + (k >> 3) * kCore + (n & 7) * 16
      + (k & 7) * 2;
}

// Eight int8 values widened to bf16, exactly (|v| <= 128): v + 128 put in
// the significand of 2^23, less 2^23 + 128 (exact in f32), and the f32's
// upper half (v has at most 8 significant bits).
__device__ __forceinline__ uint4 widen8(uint2 v) {
  const uint32_t w[2] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u};
  uint32_t o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t wd = w[k >> 1], sel = 0x7540u | (2u * (k & 1));
    const float lo =
        __uint_as_float(__byte_perm(wd, 0x4B000000u, sel)) - 8388736.f;
    const float hi =
        __uint_as_float(__byte_perm(wd, 0x4B000000u, sel + 1)) - 8388736.f;
    o[k] = __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// Predecoded columns dec [B, Rt, D]: T bf16, or int8 widened exactly.
template <class T>
struct WgDec {
  const T* dec;
  const float* a1;
  const float* a2;
  int D;
  bool bulk;           // rows of 16-byte multiples, dec 16-byte aligned

  __host__ __device__ int row_bytes() const { return D * (int)sizeof(T); }
  size_t smem_bytes() const { return 0; }
  __device__ void init(unsigned char*&) {}
  __device__ const void* cols(int b, int c0, const Walk& w) const {
    return dec + ((size_t)b * w.Rt + c0) * D;
  }
  // The raw tile's ncols columns into the B stage bt (producer thread tid):
  // 8 features a thread at a time where rows allow (neighbouring threads
  // write one core matrix), else one.
  __device__ void convert(const unsigned char* raw, unsigned char* bt,
                          int ncols, int tid) const {
    if ((D & 7) == 0) {
      const int per = D >> 3, n = ((ncols + 7) >> 3) * 8 * per;
#pragma unroll 4
      for (int u = tid; u < n; u += kConvThreads) {
        const int q = (u >> 3) % per, c = (u & 7) + (u >> 3) / per * 8;
        if (c >= ncols) continue;
        const unsigned char* p = raw + (size_t)(c * D + 8 * q) * sizeof(T);
        uint4 o;
        if constexpr (std::is_same<T, int8_t>::value)
          o = widen8(*reinterpret_cast<const uint2*>(p));
        else
          o = *reinterpret_cast<const uint4*>(p);
        *reinterpret_cast<uint4*>(bt + b_at(c, 8 * q)) = o;
      }
      return;
    }
    const T* r = reinterpret_cast<const T*>(raw);
    for (int e = tid; e < ncols * D; e += kConvThreads) {
      const int c = e / D, k = e - c * D;
      *reinterpret_cast<bf16*>(bt + b_at(c, k)) =
          __float2bfloat16_rn(afis_t::widen(r[e]));
    }
  }
};

// Columns decoded from uint8 PQ codes [B, Rt, S] and the bf16 codebook
// [S, C, sd], of which the block keeps one copy in shared memory, entries
// padded to 8 values at sd 6 so that four subspaces (24 features, three
// core-matrix rows) decode with four 16-byte reads and three 16-byte
// writes; other shapes value by value.
struct WgCodes {
  const uint8_t* codes;
  const bf16* codebook;
  const float* a1;
  const float* a2;
  int S, C, sd;
  bool bulk;           // S a multiple of 16, codes 16-byte aligned
  bf16* cb;

  __host__ __device__ int cbs() const { return sd == 6 ? 8 : sd; }
  __host__ __device__ int row_bytes() const { return S; }
  size_t smem_bytes() const { return padded((size_t)S * C * cbs() * 2); }
  __device__ void init(unsigned char*& sm) {     // every thread
    const int st = cbs(), n = S * C * st;
    cb = reinterpret_cast<bf16*>(carve(sm, (size_t)n * 2));
    for (int i = threadIdx.x; i < n; i += kWgThreads) {
      const int e = i / st, k = i - e * st;
      cb[i] = k < sd ? codebook[(size_t)e * sd + k] : __float2bfloat16_rn(0.f);
    }
  }
  __device__ const void* cols(int b, int c0, const Walk& w) const {
    return codes + ((size_t)b * w.Rt + c0) * S;
  }
  __device__ void convert(const unsigned char* raw, unsigned char* bt,
                          int ncols, int tid) const {
    if (sd == 6 && (S & 3) == 0) {
      const int per = S >> 2, n = ((ncols + 7) >> 3) * 8 * per;
      const uint4* e4 = reinterpret_cast<const uint4*>(cb);
      for (int u = tid; u < n; u += kConvThreads) {
        const int t = (u >> 3) % per, c = (u & 7) + (u >> 3) / per * 8;
        if (c >= ncols) continue;
        const uint32_t q4 =
            *reinterpret_cast<const uint32_t*>(raw + c * S + 4 * t);
        const uint4* e = e4 + (size_t)4 * t * C;
        const uint4 e0 = e[q4 & 0xff], e1 = e[C + ((q4 >> 8) & 0xff)];
        const uint4 e2 = e[2 * C + ((q4 >> 16) & 0xff)];
        const uint4 e3 = e[3 * C + (q4 >> 24)];
        unsigned char* d = bt + b_at(c, 24 * t);
        *reinterpret_cast<uint4*>(d) = make_uint4(e0.x, e0.y, e0.z, e1.x);
        *reinterpret_cast<uint4*>(d + kCore) =
            make_uint4(e1.y, e1.z, e2.x, e2.y);
        *reinterpret_cast<uint4*>(d + 2 * kCore) =
            make_uint4(e2.z, e3.x, e3.y, e3.z);
      }
      return;
    }
    for (int e = tid; e < ncols * S; e += kConvThreads) {
      const int c = e / S, s = e - c * S;
      const bf16* v = cb + ((size_t)s * C + raw[e]) * cbs();
      for (int k = 0; k < sd; ++k)
        *reinterpret_cast<bf16*>(bt + b_at(c, s * sd + k)) = v[k];
    }
  }
};

// The block's shared memory: B stages and their a1 / a2, raw stages, the
// handed-over row maxima, per-latent sums, barriers (then the source's).
struct WgSmem {
  unsigned char* bt;   // [kBStages][kStageBytes]
  float* a1s;          // [kBStages][kCT] a1 of the stage's columns
  float* a2s;          // [kBStages][kCT] a2
  int* zero;           // [kBStages][4] every a2 of 32 columns zero
  unsigned char* raw;  // [kRawStages][raw_bytes]
  size_t raw_bytes;
  float* rmax;         // [2][kGroupRows]
  uint64_t* full;      // [kBStages] B stage written (producer threads)
  uint64_t* empty;     // [kBStages] B stage read (consumer warps)
  uint64_t* rawf;      // [kRawStages] raw stage arrived
  uint64_t* rfull;     // [2] row maxima handed over (consumer warps)
  uint64_t* rempty;    // [2] row maxima taken (producer)
};

// The producer's warps 0-2: copies and conversion. Iteration i converts
// step i into B stage i % kBStages once the consumers are done with step
// i - kBStages; a thread's a1 / a2 (columns tid, tid + 96) are read a step
// ahead.
template <class Src>
__device__ __forceinline__ void wg_convert(const Src& src, const Walk& w,
                                           const WgSmem& m) {
  const int tid = threadIdx.x;
  const int rb = src.row_bytes();
  // Starts the copy of step s's raw columns into raw stage k.
  const auto fill = [&](Step s, int k) {
    if (s.b >= w.B) return;
    const unsigned char* g = static_cast<const unsigned char*>(
        src.cols(s.b, s.t * w.ct, w));
    unsigned char* d = m.raw + k * m.raw_bytes;
    const uint32_t bytes = (uint32_t)w.ncols(s.t) * rb;
    if (src.bulk) {
      if (tid == 0) {
        fence_async_smem();
        mbar_expect_tx(&m.rawf[k], bytes);
        bulk_copy(d, g, bytes, &m.rawf[k]);
      }
      return;
    }
    for (uint32_t e = tid; e < bytes; e += kConvThreads) d[e] = g[e];
    mbar_arrive(&m.rawf[k]);
  };
  // a1 / a2 of columns tid, tid + 96 of step s (-inf, 0 past its columns)
  const auto terms = [&](Step s, float2 (&u)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = tid + kConvThreads * h;
      u[h] = make_float2(-INFINITY, 0.f);
      if (s.b < w.B && col < w.ncols(s.t)) {
        const size_t o = (size_t)s.b * w.Rt + s.t * w.ct + col;
        u[h] = make_float2(src.a1[o], src.a2[o]);
      }
    }
  };
  Step cur = w.first(), ahead = cur;
  for (int k = 0; k < kRawStages - 1; ++k) {
    fill(ahead, k);
    ahead = w.next(ahead);
  }
  float2 u[2];
  terms(cur, u);
  for (int i = 0; cur.b < w.B; ++i) {
    const int s = i % kBStages, k = i % kRawStages;
    if (i >= kBStages) mbar_wait(&m.empty[s], ((i / kBStages) & 1) ^ 1);
    fill(ahead, (i + kRawStages - 1) % kRawStages);
    ahead = w.next(ahead);
    const Step nx = w.next(cur);
    float2 un[2];
    terms(nx, un);
    mbar_wait(&m.rawf[k], (i / kRawStages) & 1);
    src.convert(m.raw + k * m.raw_bytes, m.bt + (size_t)s * kStageBytes,
                w.ncols(cur.t), tid);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = tid + kConvThreads * h;
      if (col >= kCT) continue;                 // warp-uniform
      m.a1s[s * kCT + col] = u[h].x;
      m.a2s[s * kCT + col] = u[h].y;
      const bool zero = __all_sync(0xffffffffu, u[h].y == 0.f);
      if ((tid & 31) == 0) m.zero[s * 4 + (col >> 5)] = zero;
    }
    fence_async_smem();
    mbar_arrive(&m.full[s]);
    bar_sync(kBarProd, kConvThreads);   // raw stage k read before refilled
    u[0] = un[0];
    u[1] = un[1];
    cur = nx;
  }
}

// The producer's warp 3: at each group's last tile, the rows' maxima the
// consumers handed over become the group's terms and per-latent sums
// (finish_group), while the other warps convert the next tiles.
__device__ __forceinline__ void wg_finish(const LatRows<bf16>& rows,
                                          const Walk& w, const WgSmem& m) {
  const int lane = threadIdx.x & 31;
  int j = 0;
  for (Step st = w.first(); st.b < w.B; st = w.next(st)) {
    if (st.t != w.ntiles - 1) continue;
    const int buf = j & 1;
    mbar_wait(&m.rfull[buf], (j >> 1) & 1);
    float* mx = m.rmax + buf * kGroupRows;
    finish_group<bf16>([&](int r) { return mx[r]; }, mx, rows.lsum, st.b,
                       st.g, rows, lane, 32, [] { __syncwarp(); });
    __syncwarp();
    if (lane == 0) mbar_arrive(&m.rempty[buf]);
    ++j;
  }
}

// A consumer warpgroup's columns of one 64-column sub-tile: a1 of the
// thread's columns 8 c8 + 2c, + 1 (in registers), where a2 lies, and
// whether every a2 of the sub-tile is zero.
struct SubCols {
  float2 a1[kSubCols / 8];
  const float* a2;     // this thread's first column in the stage's a2s
  bool plain;

  __device__ void load(const WgSmem& m, int s, int q, int lane) {
    const float* a1s = m.a1s + s * kCT + q * kSubCols + 2 * (lane & 3);
#pragma unroll
    for (int c8 = 0; c8 < kSubCols / 8; ++c8)
      a1[c8] = *reinterpret_cast<const float2*>(a1s + 8 * c8);
    a2 = m.a2s + s * kCT + q * kSubCols + 2 * (lane & 3);
    plain = m.zero[s * 4 + 2 * q] && m.zero[s * 4 + 2 * q + 1];
  }
};

// Folds one tile's products acc (64 rows x 64 columns) into the running
// maxima lo (row g) and hi (row g + 8): v = (acc + a1) + a2. Where every
// a2 of the sub-tile is zero, (v + a1) + a2 is v + a1 (up to the sign of a
// zero, which no term keeps), one operation fewer a value.
__device__ __forceinline__ void wg_fold(float (&acc)[kSubCols / 2],
                                        const SubCols& c, float& lo,
                                        float& hi) {
#pragma unroll
  for (int e = 0; e < kSubCols / 2; ++e) fence_reg(acc[e]);
  if (c.plain) {
#pragma unroll
    for (int c8 = 0; c8 < kSubCols / 8; ++c8) {
      const float* v = &acc[4 * c8];
      const float2 u = c.a1[c8];
      lo = fmaxf(lo, fmaxf(v[0] + u.x, v[1] + u.y));
      hi = fmaxf(hi, fmaxf(v[2] + u.x, v[3] + u.y));
    }
    return;
  }
#pragma unroll
  for (int c8 = 0; c8 < kSubCols / 8; ++c8) {
    const float* v = &acc[4 * c8];
    const float2 u = c.a1[c8];
    const float2 w = *reinterpret_cast<const float2*>(c.a2 + 8 * c8);
    lo = fmaxf(lo, fmaxf((v[0] + u.x) + w.x, (v[1] + u.y) + w.y));
    hi = fmaxf(hi, fmaxf((v[2] + u.x) + w.x, (v[3] + u.y) + w.y));
  }
}

// One sub-tile (64 columns, descriptor d) on a consumer warpgroup with MT
// tiles: turn T runs tile T's products into accumulator set T & 1, then
// folds turn T - 1's, which ran meanwhile; the last fold waits for its own
// products only. The warpgroups take turns to issue (ping-pong): turn T of
// warpgroup 0, turn T of warpgroup 1, turn T + 1 of warpgroup 0, ..; mt0
// turns a sub-tile (warpgroup 0's tiles; warpgroup 1's may be one fewer),
// and `more` says whether another sub-tile follows (the last turn of
// warpgroup 1 has no taker).
template <int MT>
__device__ __forceinline__ void wg_sub(
    float (&acc)[2][kSubCols / 2], const uint32_t (&a)[kMTiles][kMaxKSteps][4],
    float (&mx)[kMTiles][2], uint64_t d, const SubCols& c, int cw, int mt0,
    bool more) {
  const auto turn = [&](auto tile) {
    constexpr int T = decltype(tile)::value;
    if (T < mt0) bar_sync(kBarTurn + cw, kConsThreads);     // this one's turn
    if constexpr (T < MT) {
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kMaxKSteps; ++ks)
        wgmma_n64(acc[T & 1], a[T][ks], d + ((2 * ks * kCore) >> 4), ks > 0);
      wgmma_commit();
    }
    if (T < mt0 && (cw == 0 || more || T + 1 < mt0))
      bar_arrive(kBarTurn + (cw ^ 1), kConsThreads);    // the other's turn
    if constexpr (T >= 1 && T - 1 < MT) {
      if constexpr (T < MT) wgmma_wait<1>(); else wgmma_wait<0>();
      wg_fold(acc[(T - 1) & 1], c, mx[T - 1][0], mx[T - 1][1]);
    }
  };
  static_assert(kMTiles == 4, "four turns a sub-tile");
  turn(std::integral_constant<int, 0>());
  turn(std::integral_constant<int, 1>());
  turn(std::integral_constant<int, 2>());
  turn(std::integral_constant<int, 3>());
  if constexpr (MT == kMTiles) {
    wgmma_wait<0>();
    wg_fold(acc[1], c, mx[3][0], mx[3][1]);
  }
}

// The consumers: each warpgroup runs its tiles' products on every 64
// columns of each stage (wg_sub), releases the stage, and at an entry's
// (group's) last tile hands its rows' maxima to the producer.
__device__ __forceinline__ void wg_consume(const LatRows<bf16>& rows,
                                           const Walk& w, const WgSmem& m) {
  // consumer warpgroup 0 / 1, warp-uniform to the compiler, so that the
  // products' branches are not divergent
  const int cw = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0) - 1;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const uint64_t desc0 = b_desc(m.bt, kCore, kGroupBytes);
  const auto one = [](int) { return 1.f; };
  uint32_t a[kMTiles][kMaxKSteps][4];
  float acc[2][kSubCols / 2];
  float mx[kMTiles][2];
  int mt = 0, m0 = 0, mt0 = 0, gn = 0, loaded = -1;
  if (cw == 1) bar_arrive(kBarTurn, kConsThreads);   // warpgroup 0 first
  Step st = w.first();
  for (int i = 0, j = 0; st.b < w.B; ++i) {
    const Step nx = w.next(st);
    const int s = i % kBStages;
    if (st.t == 0) {
      gn = rows.group_rows(st.g);
      const int MT = (gn + 63) >> 6;
      mt0 = (MT + 1) >> 1;
      mt = cw == 0 ? mt0 : MT - mt0;
      m0 = cw == 0 ? 0 : mt0;
      if (st.g != loaded) {
#pragma unroll
        for (int t = 0; t < kMTiles; ++t)
#pragma unroll
          for (int ks = 0; ks < kMaxKSteps; ++ks)
            if (t < mt)
              load_a(a[t][ks], rows.x, rows.rows, rows.D,
                     st.g * rows.group + (m0 + t) * 64 + warp * 16, ks, one);
        loaded = w.fixed || w.ngroups == 1 ? st.g : -1;
      }
#pragma unroll
      for (int t = 0; t < kMTiles; ++t) mx[t][0] = mx[t][1] = -INFINITY;
    }
    mbar_wait(&m.full[s], (i / kBStages) & 1);
    const int nsub = (w.ncols(st.t) + kSubCols - 1) / kSubCols;
    for (int q = 0; q < nsub; ++q) {
      // features past D are zero on both sides: every k-step runs
      const uint64_t d = desc0
          + ((uint32_t)(s * kStageBytes + q * (kSubCols / 8) * kGroupBytes)
             >> 4);
      SubCols c;
      c.load(m, s, q, lane);
      const bool more = nx.b < w.B || q < nsub - 1;
      switch (mt) {
        case 4: wg_sub<4>(acc, a, mx, d, c, cw, mt0, more); break;
        case 3: wg_sub<3>(acc, a, mx, d, c, cw, mt0, more); break;
        case 2: wg_sub<2>(acc, a, mx, d, c, cw, mt0, more); break;
        case 1: wg_sub<1>(acc, a, mx, d, c, cw, mt0, more); break;
        default: wg_sub<0>(acc, a, mx, d, c, cw, mt0, more); break;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&m.empty[s]);
    if (st.t == w.ntiles - 1) {                      // hand the maxima over
      const int buf = j & 1;
      mbar_wait(&m.rempty[buf], ((j >> 1) & 1) ^ 1);
      float* out = m.rmax + buf * kGroupRows;
#pragma unroll
      for (int t = 0; t < kMTiles; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (t >= mt) continue;
          float v = mx[t][h];
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
          const int r = (m0 + t) * 64 + warp * 16 + (lane >> 2) + 8 * h;
          if ((lane & 3) == 0 && r < gn) out[r] = v;
        }
      __syncwarp();
      if (lane == 0) mbar_arrive(&m.rfull[buf]);
      ++j;
    }
    st = nx;
  }
}

// Src: WgDec<T> or WgCodes; Rows: LatRows<bf16> (the kernel's name keeps
// the rows' type, as the screen bodies' do).
template <class Src, class Rows>
__global__ void __launch_bounds__(kWgThreads, 1) screen_wg_kernel(
    Src src, Rows rows, Walk w) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (w.first().b >= w.B) return;
  unsigned char* sm = smem;
  WgSmem m;
  m.bt = carve(sm, (size_t)kBStages * kStageBytes);
  m.a1s = reinterpret_cast<float*>(carve(sm, kBStages * kCT * 4));
  m.a2s = reinterpret_cast<float*>(carve(sm, kBStages * kCT * 4));
  m.zero = reinterpret_cast<int*>(carve(sm, kBStages * 4 * 4));
  m.raw_bytes = padded((size_t)kCT * src.row_bytes());
  m.raw = carve(sm, kRawStages * m.raw_bytes);
  m.rmax = reinterpret_cast<float*>(carve(sm, 2 * kGroupRows * 4));
  rows.lsum = reinterpret_cast<float*>(carve(sm, (size_t)rows.NL * 4));
  m.full = reinterpret_cast<uint64_t*>(carve(sm, kBars * 8));
  m.empty = m.full + kBStages;
  m.rawf = m.empty + kBStages;
  m.rfull = m.rawf + kRawStages;
  m.rempty = m.rfull + 2;
  src.init(sm);
  // features past D (and columns never written) stay zero in every stage
  for (int i = threadIdx.x; i < kBStages * kStageBytes / 16; i += kWgThreads)
    reinterpret_cast<uint4*>(m.bt)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBStages; ++s) {
      mbar_init(&m.full[s], kConvThreads);
      mbar_init(&m.empty[s], kConsThreads / 32);
    }
    for (int s = 0; s < kRawStages; ++s)
      mbar_init(&m.rawf[s], src.bulk ? 1 : kConvThreads);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&m.rfull[s], kConsThreads / 32);
      mbar_init(&m.rempty[s], 1);
    }
    mbar_init_fence();
  }
  fence_async_smem();
  __syncthreads();
  if (__shfl_sync(0xffffffffu, threadIdx.x >> 7, 0) == 0) {
    regs_release<kProdRegs>();
    if (__shfl_sync(0xffffffffu, threadIdx.x >> 5, 0) < 3)
      wg_convert(src, w, m);
    else
      wg_finish(rows, w, m);
  } else {
    regs_take<kConsRegs>();
    wg_consume(rows, w, m);
  }
}

// The screens' groups on this body: whole latents where a latent fits in
// 512 rows (a block keeps its group; no partial sums cross blocks), else
// 512 rows walked in order by every block.
inline void plan_wg(LatRows<bf16>& rows, Walk& w) {
  w.fixed = rows.Lt <= kGroupRows;
  rows.group = w.fixed ? min(kGroupRows / rows.Lt * rows.Lt, rows.rows)
                       : kGroupRows;
  w.ngroups = (rows.rows + rows.group - 1) / rows.group;
}

template <class Src>
size_t wg_smem_bytes(const Src& src, const LatRows<bf16>& rows) {
  return padded((size_t)kBStages * kStageBytes) + 2 * padded(kBStages * kCT * 4)
      + padded(kBStages * 4 * 4)
      + padded(kRawStages * padded((size_t)kCT * src.row_bytes()))
      + padded(2 * kGroupRows * 4) + padded((size_t)rows.NL * 4)
      + padded(kBars * 8) + src.smem_bytes();
}

template <class Src>
int launch_wg(const Src& src, const LatRows<bf16>& rows, const Walk& w,
              void* stream) {
  const size_t smem = wg_smem_bytes(src, rows);
  int grid = 0;
  const auto kernel = screen_wg_kernel<Src, LatRows<bf16>>;
  const int e = plan_grid(kernel, smem, w, &grid, kWgThreads);
  if (e != (int)cudaSuccess) return e;
  kernel<<<grid, kWgThreads, smem, (cudaStream_t)stream>>>(src, rows, w);
  return (int)cudaGetLastError();
}

}  // namespace afis_screen
