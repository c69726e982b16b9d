// The codes column source of the ADC bodies (screen_body.cuh), shared by
// the codes-resident screen (adc_screen_codes.cu) and the codes row max
// (adc_rowmax.cu): uint8 PQ codes [B, Rt, S] decoded from the codebook
// [S, C, sub_dim], of which each block keeps one copy in shared memory for
// its life. A tile's codes are fetched into registers while the previous
// tile computes and each (column, subspace) code is read once; decoded
// values are exact codebook entries.
#pragma once

#include "screen_body.cuh"

namespace afis_screen {

constexpr int kUnits = 8;                 // codes a thread prefetches a tile

// What a thread brings in for one column tile before it is decoded: up to
// kUnits (column, subspace) codes and the augmented terms of column
// threadIdx.x (a1 = -inf past Rt).
struct TileIn {
  uint32_t code[kUnits];
  float a1, a2;
};

// The column source of both bodies: uint8 codes [B, Rt, S] decoded from the
// codebook [S, C, sd] (T), which the block copies into shared memory once
// for its life. a1 / a2 [B, Rt] are the two epilogue values of a column:
// the screen's augmented terms, or the row max's rsq and rvalid.
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

  // The dot of latent row xr with column j of entry b in index order, one
  // rounding per product and per sum (the plain version's order), the
  // column decoded from the block's codebook copy.
  template <class XT>
  __device__ float dot_exact(const XT* xr, int b, int j,
                             const Walk& w) const {
    const uint8_t* cs = codes + ((size_t)b * w.Rt + j) * S;
    float acc = 0.f;
#pragma unroll 4
    for (int s = 0; s < S; ++s) {
      const T* v = cb + ((size_t)s * C + __ldg(cs + s)) * sd;
      for (int k = 0; k < sd; ++k)
        acc = __fadd_rn(acc, __fmul_rn(afis_t::widen(__ldg(xr + s * sd + k)),
                                       afis_t::widen(v[k])));
    }
    return acc;
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


}  // namespace afis_screen
