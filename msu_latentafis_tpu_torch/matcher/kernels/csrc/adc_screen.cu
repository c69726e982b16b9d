// Predecoded ADC texture screen: persistent blocks, each serving all NL
// latents of every gallery entry it takes.
//
// Replaces the JAX package's pallas_kernels.py fused_adc_screen (:1106,
// pallas_call :1155, body _adc_augmax_kernel :1080); the codes variant
// fused_adc_screen_codes is adc_screen_codes.cu:
//   v[i, j]   = (x_i . dec_j + a1_j) + a2_j
//   raw[i]    = max_j v[i, j], rounded to x's type
//   out[n, b] = sum_i max(2 raw[i] + ((6 - |x_i|^2) - tau), 0) * lv_i
// The TPU kernel carries a1 and a2 as two augmented contraction rows of
// dec against two columns of x; the wrapper (ops.screen_aug) forms the
// products a1_j, a2_j the contraction adds and this kernel adds them after
// the D-long dot, in the order written above:
//   - f32 / bf16 dec: a1 = -(|dec_j|^2 / 2) and a2 = 0 for a valid rolled
//     minutia, -1e4 for an invalid one, both rounded to dec's type;
//   - int8 dec (tex_int8): a1 = c1 * round(-(|dec_j|^2 / 2) / c1) with c1
//     one scale per JAX engine block of entries, in x's type, and a2 = 0 or
//     -127.
// In f32 the screen is the one before the modes, bit for bit. With tau = 0
// it bounds the exact texture score from above (up to the rounding of the
// bf16 and int8 modes).
//
// Bound: operations, 2 NL Lt Rt D flops per entry (44 MFLOP at the
// prescreen's NL 8 x Lt 64, Rt 448, D 96) against the entry's 172 KB of
// f32 descriptors (86 KB in bf16, 43 KB in int8). Design: one body per
// operand type, shared with the codes screen, with the predecoded column
// source; afis_adc_screen_body names the one a shape takes (ops.
// SCREEN_BODIES):
//   - x bf16 ([bf16,bf16], [bf16,int8]), D <= 96: "wgmma", the
//     warp-specialized body of screen_wg.cuh. A producer warpgroup brings
//     each entry's columns in by bulk copies, tiles of 128, and widens an
//     int8 tile to bf16 exactly (|v| <= 127 fits bf16's significand, so
//     every product x dec is exact in f32) into the layout wgmma reads;
//     two consumer warpgroups keep up to 512 latent rows' A fragments in
//     registers (4 x 448 rows: four groups, each with its blocks; 4 x
//     1,000: groups of 512 walked per entry) and take turns between their
//     products and their row-max folds. Only the order of the f32
//     accumulation differs from the plain version: a row maximum may round
//     to the neighbouring bf16 value (ops.screen_slack). On the same entry
//     the bf16 codes screen gives the same bits.
//   - x f32 ([f32,f32], [f32,int8]): "f32 body", CUDA cores
//     (screen_body.cuh), each dot in index order with one rounding per
//     product and per sum, bit for bit the plain version and the f32 codes
//     screen. The tile is staged at the top of its step, widened to f32,
//     while the block's first 64-row tile of latent rows streams in by
//     cp.async.
//   - outside that envelope (bf16 with D > 96, or an f32 tile and its row
//     maxima beyond the card's shared memory, D above ~270): "CUDA-core
//     tiles", the widened kernel below, one block per (latent, entry) on
//     adc_tile.cuh's 64 x 64 tiles, bit for bit the plain version.
#include "adc_tile.cuh"
#include "screen_wg.cuh"

namespace {

using afis_screen::bf16;

// One thread block per (latent, entry): the latent rows in 64-row tiles
// and, for each, the rolled columns in 64-column tiles (values widened to
// f32 on load); one thread sums the Lt terms in index order.
template <class XT, class Cols>
__global__ void __launch_bounds__(afis_adc::kThreads) adc_screen_kernel(
    const XT* __restrict__ x, const float* __restrict__ lsq,
    const float* __restrict__ lvalid, Cols cols,
    const float* __restrict__ a1, const float* __restrict__ a2,
    float* __restrict__ out, int NL, int Lt, int B, int Rt, int D,
    float tau) {
  using afis_adc::kTile;
  extern __shared__ float sm[];
  const int DP = D + 1;
  float* xs = sm;                      // [kTile][DP] latent rows
  float* ds = xs + kTile * DP;         // [kTile][DP] rolled columns
  float* term = ds + kTile * DP;       // [Lt] per-row terms
  cols.init(term + Lt);
  // latent fastest: consecutive blocks share the rolled entry in L2
  const int n = blockIdx.x % NL, b = blockIdx.x / NL;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;

  for (int row0 = 0; row0 < Lt; row0 += kTile) {
    __syncthreads();
    afis_adc::load_rows(xs, x, n, row0, Lt, D);
    float bv[4];
    for (int q = 0; q < 4; ++q) bv[q] = -INFINITY;
    for (int c0 = 0; c0 < Rt; c0 += kTile) {
      __syncthreads();
      cols.load(ds, b, c0, Rt, D);
      __syncthreads();
      float acc[4][4];
      afis_adc::tile_dots(xs, ds, D, tr, tc, acc);
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tc * 4 + j;
        if (c >= Rt) break;
        const float u = a1[(size_t)b * Rt + c];
        const float w = a2[(size_t)b * Rt + c];
        for (int i = 0; i < 4; ++i)
          bv[i] = fmaxf(bv[i], (acc[i][j] + u) + w);
      }
    }
    for (int i = 0; i < 4; ++i) {
      for (int off = 8; off > 0; off >>= 1)
        bv[i] = fmaxf(bv[i], __shfl_xor_sync(0xffffffffu, bv[i], off));
      const int r = row0 + tr * 4 + i;
      if (tc == 0 && r < Lt) {
        const size_t o = (size_t)n * Lt + r;
        const float t6 = (6.f - lsq[o]) - tau;
        const float raw = afis_t::round_to<XT>(bv[i]);
        term[r] = fmaxf(2.f * raw + t6, 0.f) * lvalid[o];
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int r = 0; r < Lt; ++r) s = s + term[r];
    out[(size_t)n * B + b] = s;
  }
}

template <class XT, class Cols>
int launch_tiles(const XT* x, const float* lsq, const float* lvalid,
                 Cols cols, const float* a1, const float* a2, float* out,
                 int NL, int Lt, int B, int Rt, int D, float tau,
                 void* stream) {
  const size_t bytes = (2 * (size_t)afis_adc::kTile * (D + 1) + Lt)
      * sizeof(float) + cols.smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(
      adc_screen_kernel<XT, Cols>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  adc_screen_kernel<XT, Cols>
      <<<NL * B, afis_adc::kThreads, bytes, (cudaStream_t)stream>>>(
          x, lsq, lvalid, cols, a1, a2, out, NL, Lt, B, Rt, D, tau);
  return (int)cudaGetLastError();
}

enum Body { kBodyWg = 0, kBodyF32 = 1, kBodyTiles = 2 };

// One launch's operands; with `body` set, plan only and report the body.
struct Args {
  const void* x;
  const float* lsq;
  const float* lvalid;
  const float* a1;
  const float* a2;
  float* out;
  int NL, Lt, B, Rt, D;
  float tau;
  void* stream;
  int* body;
};

int screen(const Args& a, const void* dec, int xtype, int dtype) {
  using namespace afis_screen;
  if (a.NL <= 0 || a.Lt <= 0 || a.B <= 0 || a.Rt <= 0 || a.D <= 0
      || (long long)a.NL * a.B > 0x7fffffffLL
      || (long long)a.NL * a.Lt > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t optin = smem_optin();
  return afis_t::dispatch_pair(xtype, dtype, [&](auto xt, auto dt) {
    using XT = typename decltype(xt)::type;
    using DT = typename decltype(dt)::type;
    const XT* xx = static_cast<const XT*>(a.x);
    const DT* dd = static_cast<const DT*>(dec);
    Walk w{a.B, a.Rt, kCT, (a.Rt + kCT - 1) / kCT, 1, 1, false};
    if constexpr (std::is_same<XT, bf16>::value) {
      LatRows<bf16> rows{xx, a.lsq, a.lvalid, a.out, a.NL, a.Lt, a.B, a.D,
                         a.NL * a.Lt, 0, a.tau};
      plan_wg(rows, w);
      const uintptr_t p = reinterpret_cast<uintptr_t>(dd);
      const WgDec<DT> src{dd, a.a1, a.a2, a.D,
                          a.D * sizeof(DT) % 16 == 0 && p % 16 == 0};
      if (a.D <= kDMax && wg_smem_bytes(src, rows) <= optin) {
        if (a.body) {
          *a.body = kBodyWg;
          return 0;
        }
        return launch_wg(src, rows, w, a.stream);
      }
    } else {
      LatRows<float> rows{xx, a.lsq, a.lvalid, a.out, a.NL, a.Lt, a.B, a.D,
                          a.NL * a.Lt, 0, a.tau};
      plan_f32(rows, w);
      const uintptr_t p = reinterpret_cast<uintptr_t>(dd);
      const CopyF32<DT> src{dd, a.a1, a.a2, a.D,
                            a.D % 4 == 0 && p % (4 * sizeof(DT)) == 0};
      if (f32_smem_bytes(rows) <= optin) {
        if (a.body) {
          *a.body = kBodyF32;
          return 0;
        }
        return launch_f32(src, rows, w, a.stream);
      }
    }
    if (a.body) {
      *a.body = kBodyTiles;
      return 0;
    }
    return launch_tiles(xx, a.lsq, a.lvalid, afis_adc::DecCols<DT>{dd}, a.a1,
                        a.a2, a.out, a.NL, a.Lt, a.B, a.Rt, a.D, a.tau,
                        a.stream);
  });
}

}  // namespace

// xtype / dtype: the operands' type codes (dtypes.cuh); a1 / a2 [B, Rt].
extern "C" int afis_adc_screen(const void* x, const float* lsq,
                               const float* lvalid, const void* dec,
                               const float* a1, const float* a2, float* out,
                               int NL, int Lt, int B, int Rt, int D,
                               float tau, int xtype, int dtype,
                               void* stream) {
  const Args a{x, lsq, lvalid, a1, a2, out, NL, Lt, B, Rt, D, tau, stream,
               nullptr};
  return screen(a, dec, xtype, dtype);
}

// The body a launch of these shapes takes: 0 wgmma, 1 the f32 body, 2 the
// CUDA-core tiles; negative: the launch would be refused (-error).
extern "C" int afis_adc_screen_body(int NL, int Lt, int B, int Rt, int D,
                                    int xtype, int dtype) {
  int body = -1;
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, NL, Lt,
               B, Rt, D, 0.f, nullptr, &body};
  const int e = screen(a, nullptr, xtype, dtype);
  return e != 0 ? -e : body;
}
