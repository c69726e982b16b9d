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
// a grid of about one block per SM walks the entries. The block copies the
// codebook into shared memory once, then, for each entry, decodes its
// rolled columns in tiles of 128 (each code byte read once per subspace,
// fetched into registers while the previous tile computes) and applies
// each decoded tile to every latent row of the group in flight:
//   - bf16 (the JAX engine's bf16 decode tensor): tensor cores,
//     mma.sync.m16n8k16 bf16 -> f32 (mma.cuh). A group is 512 latent rows,
//     64 per warp, whose A fragments stay in registers; with NL x Lt <= 512
//     (the serving prescreen, 8 x 64) they are loaded once per block and
//     every tile is decoded once per entry. Larger row counts run in groups
//     of 512, each decoding the entry again (decode is a few percent of a
//     group's tensor work; streaming the rows per tile would cost more).
//     The decoded values are exact codebook entries and the products exact,
//     so only the order of the f32 accumulation differs from the plain
//     version: each raw[i] may round to the neighbouring bf16 value
//     (ops.screen_slack states the tolerance).
//   - f32: CUDA cores, each dot in index order with one rounding per
//     product and per sum (--fmad=false), bit for bit the plain version
//     and the predecoded adc_screen.cu. The latent rows (196 KB at the
//     prescreen) stream from L2 in 64-row tiles (cp.async) against the
//     decoded tile; 256 threads hold 4 x 8 register tiles; the running row
//     maxima of up to 4,096 rows sit in shared memory. On an H100 SXM
//     (700 W) a second row buffer, loading the next tile during the
//     product, bought nothing (within 1% in two trials), so there is one;
//     the first tile of a column tile loads while the block decodes.
// Each row maximum folds (acc + a1) + a2 with the tile's columns past Rt at
// a1 = -inf; a group's terms then add into per-latent sums in row order.
#include <math.h>

#include "dtypes.cuh"
#include "mma.cuh"

namespace {

using afis_t::bf16;
using namespace afis_mma;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCT = 128;                  // rolled columns per decoded tile
constexpr int kUnits = 8;                 // codes a thread prefetches a tile
constexpr int kDMax = kMaxKSteps * kK;    // 96
constexpr int kLd = kDMax + 8;            // bf16 tile row, 13 x 16 bytes
constexpr int kWarpRows = 64;             // latent rows per warp (4 m-tiles)
constexpr int kRowsTC = kWarps * kWarpRows;   // rows per tensor-core group
constexpr int kRowTile = 64;              // latent rows per f32 tile
constexpr int kLdx = kRowTile + 4;        // f32 row tile stride (no conflicts)
constexpr int kMaxRowsF32 = 4096;         // running maxima an f32 block holds

struct Params {
  const float* lsq;
  const float* lvalid;
  const uint8_t* codes;
  const float* a1;
  const float* a2;
  float* out;
  int NL, Lt, B, Rt, S, C, sd, D;
  int ct;        // columns decoded per tile (kCT unless S > 16)
  int rows;      // NL * Lt
  int group;     // latent rows per group
  int ngroups, ntiles;
  float tau;
};

// One unit of a block's work: entry b, row group g, column tile t.
struct Step {
  int b, g, t;
};

__device__ __forceinline__ Step next_step(Step s, const Params& p) {
  if (++s.t < p.ntiles) return s;
  s.t = 0;
  if (++s.g < p.ngroups) return s;
  s.g = 0;
  s.b += gridDim.x;
  return s;
}

// What a thread brings in for one column tile before it is decoded: up to
// kUnits (column, subspace) codes and the augmented terms of column
// threadIdx.x (a1 = -inf past Rt).
struct TileIn {
  uint32_t code[kUnits];
  float a1, a2;
};

// Unit u of a tile: (column u % ct, subspace u / ct) when kColMajor (the f32
// tile is stored d-major, so neighbouring threads write neighbouring
// columns), else (column u / S, subspace u % S).
template <bool kColMajor>
__device__ __forceinline__ void unit_of(int u, const Params& p, int& col,
                                        int& s) {
  if (kColMajor) {
    col = u % p.ct;
    s = u / p.ct;
  } else {
    col = u / p.S;
    s = u % p.S;
  }
}

template <bool kColMajor>
__device__ __forceinline__ void fetch_tile(TileIn& in, Step st,
                                           const Params& p) {
  const int c0 = st.t * p.ct, ncols = min(p.ct, p.Rt - c0);
  const uint8_t* codes = p.codes + ((size_t)st.b * p.Rt + c0) * p.S;
#pragma unroll
  for (int i = 0; i < kUnits; ++i) {
    int col, s;
    unit_of<kColMajor>(threadIdx.x + i * kThreads, p, col, s);
    in.code[i] = col < ncols && s < p.S ? codes[(size_t)col * p.S + s] : 0u;
  }
  const int j = threadIdx.x;
  const size_t o = (size_t)st.b * p.Rt + c0 + j;
  in.a1 = j < ncols ? p.a1[o] : -INFINITY;
  in.a2 = j < ncols ? p.a2[o] : 0.f;
}

// Decodes the fetched tile: unit (col, s) copies cb[s][code] (sub_dim
// values) to feature s * sub_dim of column col, at dst(col, feature).
template <bool kColMajor, class T, class Dst>
__device__ __forceinline__ void decode_tile(const TileIn& in, const T* cb,
                                            float2* av, Step st,
                                            const Params& p, const Dst& dst) {
  const int ncols = min(p.ct, p.Rt - st.t * p.ct);
#pragma unroll
  for (int i = 0; i < kUnits; ++i) {
    int col, s;
    unit_of<kColMajor>(threadIdx.x + i * kThreads, p, col, s);
    if (col < ncols && s < p.S) {
      const T* src = cb + ((size_t)s * p.C + in.code[i]) * p.sd;
      for (int k = 0; k < p.sd; ++k) *dst(col, s * p.sd + k) = src[k];
    }
  }
  if (threadIdx.x < kCT) av[threadIdx.x] = make_float2(in.a1, in.a2);
}

// After a group's last tile: the row maxima max_rows[r] (r < rows in the
// group) become terms, and the terms add into the per-latent sums in row
// order; a latent whose last row is in the group writes its score. Every
// thread calls it; term may alias max_rows.
template <class XT, class MaxOf>
__device__ void finish_group(const MaxOf& max_of, float* term, float* lsum,
                             Step st, const Params& p) {
  const int g0 = st.g * p.group, gn = min(p.group, p.rows - g0);
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
      p.out[(size_t)n * p.B + st.b] = s;
    else
      lsum[n] = s;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1) codes_screen_tc_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ codebook,
    Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cb_n = p.S * p.C * p.sd;
  bf16* cb = reinterpret_cast<bf16*>(smem);
  bf16* dec = cb + ((cb_n + 7) & ~7);                       // [2][kCT][kLd]
  float2* av = reinterpret_cast<float2*>(dec + 2 * kCT * kLd);  // [2][kCT]
  float* part = reinterpret_cast<float*>(av + 2 * kCT);     // [kRowsTC]
  float* term = part + kRowsTC;                              // [kRowsTC]
  float* lsum = term + kRowsTC;                              // [NL]

  Step st{(int)blockIdx.x, 0, 0};
  if (st.b >= p.B) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < cb_n; i += kThreads) cb[i] = codebook[i];
  for (int i = tid; i < 2 * kCT * kLd; i += kThreads)
    dec[i] = __float2bfloat16_rn(0.f);      // features past D stay zero
  TileIn in;
  fetch_tile<false>(in, st, p);
  __syncthreads();

  uint32_t a[4][kMaxKSteps][4];   // this warp's 64 rows, all of D
  float mx[4][2];                 // running maxima of rows g, g + 8
  int loaded = -1, wr = 0, wc = 0, rw = 0, cw = 0;
  for (int buf = 0; st.b < p.B; buf ^= 1) {
    bf16* dt = dec + buf * kCT * kLd;
    float2* at = av + buf * kCT;
    // this buffer's last readers swept two steps back, before the last sync
    decode_tile<false>(in, cb, at, st, p, [&](int col, int f) {
      return dt + col * kLd + f;
    });
    __syncthreads();
    const Step nx = next_step(st, p);
    if (nx.b < p.B) fetch_tile<false>(in, nx, p);
    if (st.t == 0) {
      // warps split a group as wr row slots x wc column slots
      const int gn = min(kRowsTC, p.rows - st.g * kRowsTC);
      wr = (gn + kWarpRows - 1) / kWarpRows;
      wc = kWarps / wr;
      rw = warp % wr;
      cw = warp / wr;
      if (st.g != loaded) {
        const int r0 = st.g * kRowsTC + rw * kWarpRows;
        const auto one = [](int) { return 1.f; };
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int ks = 0; ks < kMaxKSteps; ++ks)
            load_a(a[m][ks], x, p.rows, p.D, r0 + 16 * m, ks, one);
        loaded = p.ngroups == 1 ? st.g : -1;
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) mx[m][0] = mx[m][1] = -INFINITY;
    }
    if (cw < wc) {
      const int ncols = min(p.ct, p.Rt - st.t * p.ct);
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
          for (int j = 0; j < 3; ++j) load_b2(b[q][j], dt, kLd, (n + q) * 8, j);
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
          const float2 u0 = at[col], u1 = at[col + 1];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const float* c = acc[q][m];
            mx[m][0] = fmaxf(mx[m][0], fmaxf((c[0] + u0.x) + u0.y,
                                             (c[1] + u1.x) + u1.y));
            mx[m][1] = fmaxf(mx[m][1], fmaxf((c[2] + u0.x) + u0.y,
                                             (c[3] + u1.x) + u1.y));
          }
        }
      }
    }
    if (st.t == p.ntiles - 1) {
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
      const int slot = wr * kWarpRows, nslot = wc;
      finish_group<bf16>([&](int r) {
        float v = part[r];
        for (int q = 1; q < nslot; ++q) v = fmaxf(v, part[q * slot + r]);
        return v;
      }, term, lsum, st, p);
    }
    st = nx;
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, bit for bit the plain version
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts copying latent rows row0 .. row0 + n - 1 (of [rows, D]) into
// xs[d][r] (stride kLdx), zero past n; 8 neighbouring threads copy 8
// neighbouring features of one row (one 32-byte sector). The copies are
// asynchronous, so the first tile of a step loads while the block decodes.
__device__ __forceinline__ void fetch_rows(float* xs, const float* x,
                                           int row0, int n, int D) {
  const int d8 = (D + 7) >> 3;
  for (int e = threadIdx.x; e < kRowTile * d8 * 8; e += kThreads) {
    const int lo = e & 7, r = (e >> 3) % kRowTile, hi = (e >> 3) / kRowTile;
    const int d = hi * 8 + lo;
    if (d >= D) continue;
    float* dst = xs + d * kLdx + r;
    if (r < n)
      cp_async4(dst, x + (size_t)(row0 + r) * D + d);
    else
      *dst = 0.f;
  }
  cp_commit();
}

__global__ void __launch_bounds__(kThreads, 1) codes_screen_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ codebook,
    Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cb_n = p.S * p.C * p.sd;
  float* cb = reinterpret_cast<float*>(smem);
  float* ds = cb + ((cb_n + 3) & ~3);          // [D][kCT]
  float* xs = ds + p.D * kCT;                   // [D][kLdx]
  float2* av = reinterpret_cast<float2*>(xs + p.D * kLdx);       // [kCT]
  float* rmax = reinterpret_cast<float*>(av + kCT);  // [group]
  float* lsum = rmax + p.group;                      // [NL]

  Step st{(int)blockIdx.x, 0, 0};
  if (st.b >= p.B) return;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  for (int i = tid; i < cb_n; i += kThreads) cb[i] = codebook[i];
  TileIn in;
  fetch_tile<true>(in, st, p);

  while (st.b < p.B) {
    const int g0 = st.g * p.group, gn = min(p.group, p.rows - g0);
    __syncthreads();     // the codebook copy, or the last tile's readers
    if (st.t == 0)
      for (int r = tid; r < gn; r += kThreads) rmax[r] = -INFINITY;
    fetch_rows(xs, x, g0, min(kRowTile, gn), p.D);
    decode_tile<true>(in, cb, av, st, p, [&](int col, int f) {
      return ds + f * kCT + col;
    });
    const Step nx = next_step(st, p);
    if (nx.b < p.B) fetch_tile<true>(in, nx, p);
    for (int r0 = 0; r0 < gn; r0 += kRowTile) {
      if (r0 > 0) fetch_rows(xs, x, g0 + r0, min(kRowTile, gn - r0), p.D);
      cp_wait_all();
      __syncthreads();   // the row tile, the decoded tile and av are in place
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
    if (st.t == p.ntiles - 1)
      finish_group<float>([&](int r) { return rmax[r]; }, rmax, lsum, st,
                          p);
    st = nx;
  }
}

template <class Kernel, class XT>
int launch(Kernel kernel, const XT* x, const XT* codebook, Params& p,
           size_t smem, void* stream) {
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
  const int grid = (int)min((long long)p.B, (long long)sms * per_sm);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(x, codebook, p);
  return (int)cudaGetLastError();
}

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
  Params p{lsq, lvalid, codes, a1, a2, out, NL, Lt, B, Rt, S, C, sub_dim,
           S * sub_dim};
  p.ct = min(kCT, (kThreads * kUnits / S) & ~7);
  if (p.ct < 8) return (int)cudaErrorInvalidValue;
  p.rows = NL * Lt;
  p.ntiles = (Rt + p.ct - 1) / p.ct;
  p.tau = tau;
  const size_t cb_n = (size_t)S * C * sub_dim;
  if (xtype == afis_t::kBF16) {
    if (p.D > kDMax) return (int)cudaErrorInvalidValue;
    p.group = kRowsTC;
    p.ngroups = (p.rows + kRowsTC - 1) / kRowsTC;
    const size_t smem = ((cb_n + 7) & ~(size_t)7) * sizeof(bf16)
        + 2 * kCT * kLd * sizeof(bf16) + 2 * kCT * sizeof(float2)
        + (2 * kRowsTC + NL) * sizeof(float);
    return launch(codes_screen_tc_kernel, static_cast<const bf16*>(x),
                  static_cast<const bf16*>(codebook), p, smem, stream);
  }
  if (xtype == afis_t::kF32) {
    p.group = min((p.rows + kRowTile - 1) / kRowTile * kRowTile, kMaxRowsF32);
    p.ngroups = (p.rows + p.group - 1) / p.group;
    const size_t smem = (((cb_n + 3) & ~(size_t)3) + (size_t)p.D * kCT
                         + (size_t)p.D * kLdx + 2 * kCT + p.group + NL)
        * sizeof(float);
    return launch(codes_screen_f32_kernel, static_cast<const float*>(x),
                  static_cast<const float*>(codebook), p, smem, stream);
  }
  return (int)cudaErrorInvalidValue;
}
