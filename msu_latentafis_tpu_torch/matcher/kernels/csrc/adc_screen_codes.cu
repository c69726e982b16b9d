// Codes-resident ADC texture screen: persistent blocks, each serving all NL
// latents of every gallery entry it takes.
//
// Replaces the JAX package's pallas_kernels.py fused_adc_screen_codes
// (:1213, pallas_call :1240, body _adc_screen_codes_kernel :1174). Over
// uint8 PQ codes [B, Rt, S] and the codebook [S, C, sub_dim] (x's type):
//   dec_j     = cb[s][codes[j][s]] for each subspace s (an exact lookup)
//   v[i, j]   = (x_i . dec_j + a1_j) + a2_j
//   raw[i]    = max_j v[i, j], rounded to x's type
//   out[n, b] = sum_i max(2 raw[i] + ((6 - |x_i|^2) - tau), 0) * lv_i
// with the terms summed in row order and a1 / a2 the wrapper's
// ops.screen_aug (adc_screen.cu says what they are).
//
// Bound: operations, 2 NL Lt Rt D flops per entry (44 MFLOP at the
// prescreen's NL 8 x Lt 64, Rt 448, D 96) against 7 KB of codes. Design:
// the two bodies of screen_body.cuh, shared with the predecoded screen
// (adc_screen.cu), with this file's column source: the block copies the
// codebook into shared memory once, then, for each entry, decodes its
// rolled columns in tiles of 128 (each code byte read once per subspace,
// fetched into registers while the previous tile computes) and applies
// each decoded tile to every latent row of its group:
//   - bf16 (the JAX engine's bf16 decode tensor): tensor cores. A group is
//     up to 512 latent rows, 64 per warp, whose A fragments stay in
//     registers. Latents of at most 512 rows make groups of whole latents
//     and a block keeps one group for its life (the serving prescreen's
//     8 x 64 rows are one group, so every tile is decoded once per entry;
//     4 x 448 rows are four groups whose blocks split the entries); longer
//     latents are walked in groups of 512 by every block, the fragments
//     reloaded per (group, entry). The decoded values are exact codebook
//     entries and the products exact, so only the order of the f32
//     accumulation differs from the plain version: each raw[i] may round
//     to the neighbouring bf16 value (ops.screen_slack states the
//     tolerance). The predecoded screen runs the same instructions on the
//     same tile, so the two give the same bits.
//   - f32: CUDA cores, each dot in index order with one rounding per
//     product and per sum (--fmad=false), bit for bit the plain version
//     and the predecoded adc_screen.cu. The latent rows (196 KB at the
//     prescreen) stream from L2 in 64-row tiles (cp.async) against the
//     decoded tile; the running row maxima of up to 4,096 rows sit in
//     shared memory. On an H100 SXM (700 W) a second row buffer, loading
//     the next tile during the product, bought nothing (within 1% in two
//     trials), so there is one; the first tile of a column tile loads
//     while the block decodes.
// Each row maximum folds (acc + a1) + a2 with the tile's columns past Rt at
// a1 = -inf; a group's terms then add into per-latent sums in row order.
#include "screen_body.cuh"

namespace {

using namespace afis_screen;

constexpr int kUnits = 8;                 // codes a thread prefetches a tile

// What a thread brings in for one column tile before it is decoded: up to
// kUnits (column, subspace) codes and the augmented terms of column
// threadIdx.x (a1 = -inf past Rt).
struct TileIn {
  uint32_t code[kUnits];
  float a1, a2;
};

// The column source of both bodies: uint8 codes [B, Rt, S] decoded from the
// codebook [S, C, sd] (T), which the block copies into shared memory once.
template <class T>
struct Codes {
  const uint8_t* codes;
  const T* codebook;
  const float* a1;
  const float* a2;
  int S, C, sd;
  T* cb;               // the block's copy
  bf16* dec;           // [2][kCT][kLd] (tensor-core body)
  float2* av;          // [2][kCT] (tensor-core body)

  // Unit u of a tile: (column u % ct, subspace u / ct) when kColMajor (the
  // f32 tile is stored d-major, so neighbouring threads write neighbouring
  // columns), else (column u / S, subspace u % S).
  template <bool kColMajor>
  __device__ void unit_of(int u, int ct, int& col, int& s) const {
    if (kColMajor) {
      col = u % ct;
      s = u / ct;
    } else {
      col = u / S;
      s = u % S;
    }
  }
  template <bool kColMajor>
  __device__ void fetch_tile(TileIn& in, Step st, const Walk& w) const {
    const int c0 = st.t * w.ct, ncols = w.ncols(st.t);
    const uint8_t* cs = codes + ((size_t)st.b * w.Rt + c0) * S;
#pragma unroll
    for (int i = 0; i < kUnits; ++i) {
      int col, s;
      unit_of<kColMajor>(threadIdx.x + i * kThreads, w.ct, col, s);
      in.code[i] = col < ncols && s < S ? cs[(size_t)col * S + s] : 0u;
    }
    const int j = threadIdx.x;
    const size_t o = (size_t)st.b * w.Rt + c0 + j;
    in.a1 = j < ncols ? a1[o] : -INFINITY;
    in.a2 = j < ncols ? a2[o] : 0.f;
  }
  // Decodes the fetched tile: unit (col, s) copies cb[s][code] (sd values)
  // to feature s * sd of column col, at dst(col, feature).
  template <bool kColMajor, class Dst>
  __device__ void decode_tile(const TileIn& in, float2* at, Step st,
                              const Walk& w, const Dst& dst) const {
    const int ncols = w.ncols(st.t);
#pragma unroll
    for (int i = 0; i < kUnits; ++i) {
      int col, s;
      unit_of<kColMajor>(threadIdx.x + i * kThreads, w.ct, col, s);
      if (col < ncols && s < S) {
        const T* src = cb + ((size_t)s * C + in.code[i]) * sd;
        for (int k = 0; k < sd; ++k) *dst(col, s * sd + k) = src[k];
      }
    }
    if (threadIdx.x < kCT) at[threadIdx.x] = make_float2(in.a1, in.a2);
  }

  size_t cb_bytes() const { return padded((size_t)S * C * sd * sizeof(T)); }
  size_t smem_bytes() const {
    return cb_bytes() + (std::is_same<T, bf16>::value
                         ? padded(2 * kCT * kLd * 2) + padded(2 * kCT * 8)
                         : 0);
  }
  __device__ void init(unsigned char*& sm) {
    const int n = S * C * sd;
    cb = reinterpret_cast<T*>(carve(sm, (size_t)n * sizeof(T)));
    for (int i = threadIdx.x; i < n; i += kThreads) cb[i] = codebook[i];
    if constexpr (std::is_same<T, bf16>::value) {
      dec = reinterpret_cast<bf16*>(carve(sm, 2 * kCT * kLd * 2));
      av = reinterpret_cast<float2*>(carve(sm, 2 * kCT * 8));
      for (int i = threadIdx.x; i < 2 * kCT * kLd; i += kThreads)
        dec[i] = __float2bfloat16_rn(0.f);    // features past D stay zero
    }
  }

  using In = TileIn;

  // tensor-core body: two decoded tiles; step i decodes into tile i % 2,
  // whose last readers swept two steps back, before the last sync
  struct Tile {
    const bf16* dt;
    const float2* av;
    __device__ float2 aug(int col) const { return av[col]; }
  };
  __device__ void begin(In& in, Step st, const Walk& w) {
    fetch_tile<false>(in, st, w);
    __syncthreads();
  }
  __device__ Tile stage(In& in, int i, Step st, Step nx, const Walk& w) {
    bf16* dt = dec + (i & 1) * kCT * kLd;
    float2* at = av + (i & 1) * kCT;
    decode_tile<false>(in, at, st, w, [&](int col, int f) {
      return dt + col * kLd + f;
    });
    __syncthreads();
    if (nx.b < w.B) fetch_tile<false>(in, nx, w);
    return Tile{dt, at};
  }

  // f32 body: the tile decoded at the top of its step, the next one's codes
  // fetched into registers while it computes
  __device__ void fetch(In& in, Step st, const Walk& w) const {
    fetch_tile<true>(in, st, w);
  }
  __device__ void store(In& in, float* ds, float2* at, Step st,
                        const Walk& w) const {
    decode_tile<true>(in, at, st, w, [&](int col, int f) {
      return ds + f * kCT + col;
    });
  }
};

}  // namespace

// x [NL, Lt, S * sub_dim] and the codebook [S, C, sub_dim] in x's type (f32
// or bf16; bf16 needs S * sub_dim <= 96); a1 / a2 [B, Rt]; out [NL, B].
extern "C" int afis_adc_screen_codes(const void* x, const float* lsq,
                                     const float* lvalid,
                                     const uint8_t* codes,
                                     const void* codebook, const float* a1,
                                     const float* a2, float* out, int NL,
                                     int Lt, int B, int Rt, int S, int C,
                                     int sub_dim, float tau, int xtype,
                                     void* stream) {
  if (NL <= 0 || Lt <= 0 || B <= 0 || Rt <= 0 || S <= 0 || C <= 0
      || C > 256 || sub_dim <= 0 || (long long)NL * Lt > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int D = S * sub_dim;
  Walk w{B, Rt, min(kCT, (kThreads * kUnits / S) & ~7), 0, 1, 1, false};
  if (w.ct < 8) return (int)cudaErrorInvalidValue;
  w.ntiles = (Rt + w.ct - 1) / w.ct;
  if (xtype == afis_t::kBF16) {
    if (D > kDMax) return (int)cudaErrorInvalidValue;
    LatRows<bf16> rows{static_cast<const bf16*>(x), lsq, lvalid, out, NL,
                       Lt, B, D, NL * Lt, 0, tau};
    rows.plan_tc(w);
    return launch_tc(Codes<bf16>{codes, static_cast<const bf16*>(codebook),
                                 a1, a2, S, C, sub_dim},
                     rows, w, stream);
  }
  if (xtype == afis_t::kF32) {
    LatRows<float> rows{static_cast<const float*>(x), lsq, lvalid, out, NL,
                        Lt, B, D, NL * Lt, 0, tau};
    plan_f32(rows, w);
    return launch_f32(Codes<float>{codes,
                                   static_cast<const float*>(codebook), a1,
                                   a2, S, C, sub_dim},
                      rows, w, stream);
  }
  return (int)cudaErrorInvalidValue;
}
