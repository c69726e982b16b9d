// The transposed ADC screens of the ADC-screen throughput experiment.
//
// Replaces the two Pallas kernels of the JAX package's
// scripts/exp_screen_mfu.py (pallas_calls :154 and :124, bodies
// kernel_bf16 :89 and kernel_int8 :101). The experiment asks whether the
// screen's row maximum runs faster over the other axis of the product:
// dots [Rt, NL Lt] per entry, reduced over Rt.
//   screen_t_bf16: raw[b, m] = max_j sum_d dect[b, j, d] xt[d, m]
//     dect [B, Rt, D + 2] bf16 (the gallery side with its two augmented
//     columns -|dec|^2 / 2 and the invalid sentinel), xt [D + 2, M] bf16
//     (the latents, M = NL Lt, with two ones rows); f32 sums, raw f32.
//   screen_t_int8: raw[b, m] = max_j (sum_d dect[b, j, d] xt[d, m]
//     + corr[b, j]), int8 x int8 products summed in int32, exact in any
//     order; corr [B, Rt] int32 carries -|dec|^2 / 2 in x's scale and
//     -2^28 for an invalid column.
// The wrapper (ops.screen_t) builds the operands and applies the script's
// epilogue.
//
// Bound: operations, 2 M Rt (D + 2) per entry (39.3 MFLOP at the script's
// NL 8, Lt 448, Rt 448, D 96), against 88 KB (bf16) or 43 KB (int8) per
// entry read. Designs:
//   - bf16, Da = D + 2 <= 98: tensor cores, screen_body.cuh's body, the
//     same as the bf16 ADC screens' with the script's operands: the rows
//     are the M columns of xt, in fixed groups of 512 (7 at the script's
//     M 3,584), whose A fragments each block reads once from the
//     transposed xt and keeps for its life; the entries' columns arrive in
//     tiles of 128 by 4-byte cp.async (a row of 98 bf16 is not 16-byte
//     aligned) into a ring of three stages. The first 96 features run on
//     the tensor cores; features 96 and 97 (the aug columns against xt's
//     ones rows) are added after the dot in f32, in index order, as the
//     last two terms of the plain version's sum. The blocks of a group take
//     its entries E at a time (the wrapper's `entries`). Only the order of
//     the first 96 products' sum differs from the plain version
//     (ops.screen_t_tol states the tolerance).
//   - bf16 with Da > 98: adc_tile.cuh's 64 x 64 f32 tiles, widened on
//     load, sums in index order: a block owns 64 columns m of xt, kept in
//     shared memory, and walks E entries and each entry's Rt axis in
//     64-row tiles; each of 256 threads keeps a 4 x 4 register tile.
//   - int8, D <= 96: tensor cores, mma.sync.m16n8k32 s8 x s8 -> s32
//     (mma.cuh), on screen_body.cuh's fixed walk but in a kernel of its own
//     (screen_t_int8_tc_kernel): no f32 tail and an integer fold, so the
//     bf16 body keeps its instructions. A group of 512 rows m keeps its A
//     fragments in registers for the block's life, packed once from the
//     transposed xt (4 consecutive k of a row m to a register), ceil(D / 32)
//     k-steps, zero past D: 48 registers a lane at D 96. The entries' rows
//     (96 bytes, 16-byte aligned) arrive by 16-byte cp.async into a ring of
//     three 128-column stages stored [n][112 bytes], from which ldmatrix
//     gives the B fragments without bank conflicts, and corr beside them.
//     corr[b, j] is the mma's C operand of column j's first k-step, so the
//     epilogue is one three-way integer maximum per two values; columns
//     past Rt drop out by a mask in the fold (never an INT_MIN
//     accumulator: a dot added to it would wrap). int32 sums of int8
//     products are exact in any order, so the kernel gives the plain
//     version's integers bit for bit wherever they fit in int32.
//   - int8, D > 96 (past the fragments' register budget): the bf16 tiles'
//     layout, four int8 values to a 32-bit word in shared memory, summed
//     with __dp4a on the CUDA cores. Exact as well.
// afis_screen_t_int8_plan says which of the two an int8 launch takes.
#include <limits.h>

#include "adc_tile.cuh"
#include "screen_body.cuh"

namespace afis_screen_t8 {

using namespace afis_screen;

constexpr int kKS8 = 32;        // k (int8 values) of one mma step
constexpr int kDMax8 = 96;      // features on the tensor cores: 3 k-steps
constexpr int kLd8 = 112;       // tile row in bytes, 7 x 16: no conflicts

struct Args {
  const int8_t* xt;     // [D, M]
  const int8_t* dect;   // [B, Rt, D]
  const int* corr;      // [B, Rt]
  int* raw;             // [B, M]
  int M, D, chunk;      // chunk: bytes per cp.async of a row (16, 8 or 4)
};

// p[0], p[stride], p[2 stride], p[3 stride] in one register, the first in
// the lowest byte.
__device__ __forceinline__ int pack4(const int8_t* p, size_t stride) {
  return (int)(uint8_t)p[0] | ((int)(uint8_t)p[stride] << 8)
      | ((int)(uint8_t)p[2 * stride] << 16)
      | ((int)(uint8_t)p[3 * stride] << 24);
}

// xt[k .. k + 3, m] in one register; zero past D (a multiple of 4) or M.
__device__ __forceinline__ uint32_t pack_k4(const Args& p, int k, int m) {
  return k < p.D && m < p.M
      ? (uint32_t)pack4(p.xt + (size_t)k * p.M + m, (size_t)p.M) : 0u;
}

// The B fragments of columns 8 n .. 8 n + 7 of a tile stored [n][kLd8]:
// k-steps 2 j, 2 j + 1 by one ldmatrix.x4, an odd last k-step by an x2.
template <int KS>
__device__ __forceinline__ void load_b(uint32_t (&b)[KS][2],
                                       const unsigned char* tile, int n) {
  const int lane = threadIdx.x & 31;
  const unsigned char* row = tile + (size_t)(8 * n + (lane & 7)) * kLd8;
#pragma unroll
  for (int j = 0; j < KS / 2; ++j) {
    uint32_t r[4];
    ldmatrix_x4(r, smem_addr(row + 64 * j + 16 * (lane >> 3)));
    b[2 * j][0] = r[0];
    b[2 * j][1] = r[1];
    b[2 * j + 1][0] = r[2];
    b[2 * j + 1][1] = r[3];
  }
  if (KS & 1)
    ldmatrix_x2(b[KS - 1],
                smem_addr(row + 64 * (KS / 2) + 16 * ((lane >> 3) & 1)));
}

// The values of the n-tile of columns n0 .. n0 + 7 (dot + corr: columns
// n0 + 2 c, n0 + 2 c + 1 of rows g, g + 8 of each m-tile) into the running
// maxima; columns at or past ncols (the tile's ragged end) drop out.
__device__ __forceinline__ void fold(int (&mx)[4][2], const int (&acc)[4][4],
                                     int n0, int ncols) {
  const int col = n0 + 2 * (threadIdx.x & 3);
  if (n0 + 8 <= ncols) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      mx[m][0] = __vimax3_s32(mx[m][0], acc[m][0], acc[m][1]);
      mx[m][1] = __vimax3_s32(mx[m][1], acc[m][2], acc[m][3]);
    }
  } else {
    const bool in0 = col < ncols, in1 = col + 1 < ncols;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      mx[m][0] = __vimax3_s32(mx[m][0], in0 ? acc[m][0] : INT_MIN,
                              in1 ? acc[m][1] : INT_MIN);
      mx[m][1] = __vimax3_s32(mx[m][1], in0 ? acc[m][2] : INT_MIN,
                              in1 ? acc[m][3] : INT_MIN);
    }
  }
}

// Shared memory: the group's partial maxima, the column ring and corr's.
inline size_t smem_bytes() {
  return padded(kRowsTC * 4) + padded((size_t)kStages * kCT * kLd8)
      + padded(kStages * kCT * 4);
}

// raw[b, m] for the rows m of the block's fixed group (Walk::fixed) over
// its entries; KS = ceil(D / 32) k-steps.
template <int KS>
__global__ void __launch_bounds__(kThreads, 2) screen_t_int8_tc_kernel(
    Args p, Walk w) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sm = smem;
  int* part = reinterpret_cast<int*>(carve(sm, kRowsTC * 4));
  unsigned char* ring = carve(sm, (size_t)kStages * kCT * kLd8);
  int* cring = reinterpret_cast<int*>(carve(sm, kStages * kCT * 4));
  Step st = w.first();
  if (st.b >= w.B) return;
  // k past D stays zero in every stage (the fragments are zero there too)
  for (int i = threadIdx.x; i < kStages * kCT * kLd8 / 16; i += kThreads)
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;

  // Starts the copies of step s into stage `stage`; nothing past the last
  // entry.
  const auto issue = [&](Step s, int stage) {
    if (s.b >= w.B) return;
    const int ncols = w.ncols(s.t);
    const size_t o = (size_t)s.b * w.Rt + s.t * w.ct;
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(p.dect + o * p.D);
    unsigned char* dst = ring + (size_t)stage * kCT * kLd8;
    const int per = p.D / p.chunk;
    for (int e = threadIdx.x; e < ncols * per; e += kThreads) {
      const int n = e / per, q = e - n * per;
      cp_async(dst + n * kLd8 + q * p.chunk,
               src + (size_t)n * p.D + q * p.chunk, p.chunk);
    }
    for (int n = threadIdx.x; n < ncols; n += kThreads)
      cp_async(cring + stage * kCT + n, p.corr + o + n, 4);
  };
  Step ahead = st;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    issue(ahead, k);
    cp_commit();
    ahead = w.next(ahead);
  }

  uint32_t a[4][KS][4];   // this warp's 64 rows, all of D
  MaxFoldT<int> fo;       // rows g, g + 8 of each m-tile
  int loaded = -1;
  WarpSplit sp{0, 0, 0, 0};
  for (int i = 0; st.b < w.B; ++i) {
    const Step nx = w.next(st);
    cp_wait<kStages - 2>();             // this thread's copies of step i
    __syncthreads();                    // everyone's; step i - 1 is done
    issue(ahead, (i + kStages - 1) % kStages);
    cp_commit();
    ahead = w.next(ahead);
    const unsigned char* tile = ring + (size_t)(i % kStages) * kCT * kLd8;
    const int* ct = cring + (i % kStages) * kCT;
    const int g0 = st.g * kRowsTC, gn = min(kRowsTC, p.M - g0);
    if (st.t == 0) {
      sp.set(gn);
      if (st.g != loaded) {
        const int r0 = g0 + sp.rw * kWarpRows;
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
#pragma unroll
            for (int h = 0; h < 4; ++h)
              a[m][ks][h] = pack_k4(p, ks * kKS8 + 4 * c + 16 * (h >> 1),
                                    r0 + 16 * m + g + 8 * (h & 1));
        loaded = st.g;
      }
      fo.reset();
    }
    if (sp.cw < sp.wc) {
      const int ncols = w.ncols(st.t), nn = (ncols + 7) >> 3;
      for (int n = sp.cw; n < nn; n += sp.wc) {
        uint32_t b[KS][2];
        load_b(b, tile, n);
        // corr of the lane's two columns: the first k-step's C operand
        const int2 cr = *reinterpret_cast<const int2*>(ct + 8 * n + 2 * c);
        const int cin[4] = {cr.x, cr.y, cr.x, cr.y};
        int acc[4][4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          mma_s8(acc[m], a[m][0], b[0][0], b[0][1], cin);
#pragma unroll
          for (int ks = 1; ks < KS; ++ks)
            mma_s8(acc[m], a[m][ks], b[ks][0], b[ks][1]);
        }
        fold(fo.mx, acc, 8 * n, ncols);
      }
    }
    if (st.t == w.ntiles - 1) {
      // slot cw's maxima to part, then the maximum over the wc slots to raw
      fo.to_part(part, sp);
      __syncthreads();
      for (int r = threadIdx.x; r < gn; r += kThreads)
        p.raw[(size_t)st.b * p.M + g0 + r] =
            slot_max(part, sp.wr * kWarpRows, sp.wc, r);
    }
    st = nx;
  }
}

template <int KS>
int launch(const Args& p, const Walk& w, void* stream) {
  const size_t smem = smem_bytes();
  int grid = 0;
  const int e = plan_grid(screen_t_int8_tc_kernel<KS>, smem, w, &grid);
  if (e != (int)cudaSuccess) return e;
  screen_t_int8_tc_kernel<KS>
      <<<grid, kThreads, smem, (cudaStream_t)stream>>>(p, w);
  return (int)cudaGetLastError();
}

// xt [D, M], dect [B, Rt, D], corr [B, Rt] -> raw [B, M] on the tensor
// cores (D <= kDMax8, a multiple of 4); the blocks of a group take its
// entries E at a time.
int screen(const int8_t* xt, const int8_t* dect, const int* corr, int* raw,
           int M, int B, int Rt, int D, int E, void* stream) {
  const Args p{xt, dect, corr, raw, M, D, copy_chunk(dect, D, D)};
  const Walk w{B, Rt, kCT, (Rt + kCT - 1) / kCT,
               (M + kRowsTC - 1) / kRowsTC, E, true};
  if (p.chunk == 0) return (int)cudaErrorInvalidValue;
  switch ((D + kKS8 - 1) / kKS8) {
    case 1: return launch<1>(p, w, stream);
    case 2: return launch<2>(p, w, stream);
    default: return launch<3>(p, w, stream);
  }
}

}  // namespace afis_screen_t8

namespace {

using namespace afis_adc;

constexpr int kMaxEntries = 64;   // entries per block (static cap)

// xs[m][d] = xt[d, m0 + m] widened, rows past M zero.
__device__ void load_xt_bf16(float* xs, const afis_t::bf16* xt, int m0,
                             int M, int Da) {
  const int DP = Da + 1;
  for (int idx = threadIdx.x; idx < kTile * Da; idx += blockDim.x) {
    const int d = idx / kTile, m = idx - d * kTile;
    xs[m * DP + d] = m0 + m < M ? widen(xt[(size_t)d * M + m0 + m]) : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads) screen_t_bf16_kernel(
    const afis_t::bf16* __restrict__ xt,
    const afis_t::bf16* __restrict__ dect, float* __restrict__ raw, int M,
    int B, int Rt, int Da, int E) {
  extern __shared__ float sm[];
  const int DP = Da + 1;
  float* xs = sm;                      // [kTile][DP] latent columns m
  float* ds = sm + kTile * DP;         // [kTile][DP] entry rows j
  const int m0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  load_xt_bf16(xs, xt, m0, M, Da);
  const DecCols<afis_t::bf16> cols{dect};
  for (int e = 0; e < E; ++e) {
    const int b = blockIdx.y * E + e;
    if (b >= B) break;
    float bv[4];
    for (int q = 0; q < 4; ++q) bv[q] = -INFINITY;
    for (int c0 = 0; c0 < Rt; c0 += kTile) {
      __syncthreads();
      cols.load(ds, b, c0, Rt, Da);
      __syncthreads();
      float acc[4][4];
      tile_dots(xs, ds, Da, tr, tc, acc);
      for (int j = 0; j < 4; ++j) {
        if (c0 + tc * 4 + j >= Rt) break;
        for (int i = 0; i < 4; ++i) bv[i] = fmaxf(bv[i], acc[i][j]);
      }
    }
    for (int i = 0; i < 4; ++i) {
      for (int off = 8; off > 0; off >>= 1)
        bv[i] = fmaxf(bv[i], __shfl_xor_sync(0xffffffffu, bv[i], off));
      const int m = m0 + tr * 4 + i;
      if (tc == 0 && m < M) raw[(size_t)b * M + m] = bv[i];
    }
  }
}

using afis_screen_t8::pack4;

__global__ void __launch_bounds__(kThreads) screen_t_int8_kernel(
    const int8_t* __restrict__ xt, const int8_t* __restrict__ dect,
    const int* __restrict__ corr, int* __restrict__ raw, int M, int B,
    int Rt, int D, int E) {
  extern __shared__ int smi[];
  const int W = D / 4, WP = W + 1;     // 32-bit words per row, padded
  int* xs = smi;                       // [kTile][WP] latent columns m
  int* ds = smi + kTile * WP;          // [kTile][WP] entry rows j
  const int m0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  for (int idx = tid; idx < kTile * W; idx += blockDim.x) {
    const int w = idx / kTile, m = idx - w * kTile;
    xs[m * WP + w] = m0 + m < M
        ? pack4(xt + (size_t)4 * w * M + m0 + m, (size_t)M) : 0;
  }
  for (int e = 0; e < E; ++e) {
    const int b = blockIdx.y * E + e;
    if (b >= B) break;
    int bv[4] = {INT_MIN, INT_MIN, INT_MIN, INT_MIN};
    for (int c0 = 0; c0 < Rt; c0 += kTile) {
      __syncthreads();
      for (int idx = tid; idx < kTile * W; idx += blockDim.x) {
        const int c = idx / W, w = idx - c * W;
        ds[c * WP + w] = c0 + c < Rt
            ? pack4(dect + ((size_t)b * Rt + c0 + c) * D + 4 * w, 1) : 0;
      }
      __syncthreads();
      int acc[4][4];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] = 0;
      for (int w = 0; w < W; ++w) {
        int xv[4], dv[4];
        for (int q = 0; q < 4; ++q) {
          xv[q] = xs[(tr * 4 + q) * WP + w];
          dv[q] = ds[(tc * 4 + q) * WP + w];
        }
        for (int i = 0; i < 4; ++i)
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(xv[i], dv[j], acc[i][j]);
      }
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tc * 4 + j;
        if (c >= Rt) break;
        const int cr = corr[(size_t)b * Rt + c];
        for (int i = 0; i < 4; ++i) bv[i] = max(bv[i], acc[i][j] + cr);
      }
    }
    for (int i = 0; i < 4; ++i) {
      for (int off = 8; off > 0; off >>= 1)
        bv[i] = max(bv[i], __shfl_xor_sync(0xffffffffu, bv[i], off));
      const int m = m0 + tr * 4 + i;
      if (tc == 0 && m < M) raw[(size_t)b * M + m] = bv[i];
    }
  }
}

bool bad_shape(int M, int B, int Rt, int D, int E) {
  return M <= 0 || B <= 0 || Rt <= 0 || D <= 0 || E <= 0 || E > kMaxEntries
      || (B + E - 1) / E > 65535;
}

// The largest D at which no int8 x int8 dot can leave int32:
// D 128 * 128 <= 2^31 - 1.
constexpr int kDMaxInt8 = INT_MAX / (128 * 128);

}  // namespace

// xt [Da, M] bf16, dect [B, Rt, Da] bf16 -> raw [B, M] f32; E entries per
// block at a time.
extern "C" int afis_screen_t_bf16(const void* xt, const void* dect,
                                  float* raw, int M, int B, int Rt, int Da,
                                  int E, void* stream) {
  namespace sc = afis_screen;
  if (bad_shape(M, B, Rt, Da, E)) return (int)cudaErrorInvalidValue;
  const auto* x = static_cast<const afis_t::bf16*>(xt);
  const auto* d = static_cast<const afis_t::bf16*>(dect);
  const int Dk = min(Da, sc::kDMax), tail = Da - Dk;
  if (tail <= 2) {
    sc::TRows rows{x, raw, M, Dk, tail, B, M, 0};
    sc::Walk w{B, Rt, sc::kCT, (Rt + sc::kCT - 1) / sc::kCT, 1, E, true};
    rows.plan_tc(w);
    const sc::CopyTC<afis_t::bf16, true> src{
        d, nullptr, nullptr, Da, Dk, tail, sc::copy_chunk(d, Da, Dk)};
    if (sc::tc_smem_bytes(src, rows) <= sc::smem_optin())
      return sc::launch_tc(src, rows, w, stream);
  }
  const size_t bytes = 2 * (size_t)kTile * (Da + 1) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      screen_t_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + kTile - 1) / kTile, (B + E - 1) / E);
  screen_t_bf16_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      x, d, raw, M, B, Rt, Da, E);
  return (int)cudaGetLastError();
}

// The plan of an int8 launch at feature width D: 0 the tensor cores, 1
// the __dp4a tiles.
extern "C" int afis_screen_t_int8_plan(int D) {
  return D <= afis_screen_t8::kDMax8 ? 0 : 1;
}

// xt [D, M] int8, dect [B, Rt, D] int8 (D a multiple of 4, at most
// kDMaxInt8), corr [B, Rt] int32 -> raw [B, M] int32; E entries per block
// (per block of a row group on the tensor cores).
extern "C" int afis_screen_t_int8(const int8_t* xt, const int8_t* dect,
                                  const int* corr, int* raw, int M, int B,
                                  int Rt, int D, int E, void* stream) {
  if (bad_shape(M, B, Rt, D, E) || D % 4 || D > kDMaxInt8)
    return (int)cudaErrorInvalidValue;
  if (afis_screen_t_int8_plan(D) == 0)
    return afis_screen_t8::screen(xt, dect, corr, raw, M, B, Rt, D, E,
                                  stream);
  const size_t bytes = 2 * (size_t)kTile * (D / 4 + 1) * sizeof(int);
  const dim3 grid((M + kTile - 1) / kTile, (B + E - 1) / E);
  screen_t_int8_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      xt, dect, corr, raw, M, B, Rt, D, E);
  return (int)cudaGetLastError();
}
