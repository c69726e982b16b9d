// ADC texture similarity row maxima, without materializing the similarity.
//
// Replaces the JAX package's pallas_kernels.py fused_adc_rowmax (:1489) /
// _adc_rowmax_kernel (:29) and, over uint8 PQ codes, fused_adc_rowmax_codes
// (:1434) / _adc_rowmax_codes_kernel (:1387). For every latent n, gallery
// entry b and latent row i:
//   simi[i, j] = 2 x_i . dec_j + ((6 - |x_i|^2) - |dec_j|^2) + (v_j - 1) 1e30
//   best[n, b, i] = max_j simi[i, j], bestj = the first j reaching it.
// The masking expression is kept exactly: a row whose rolled side is all
// invalid becomes all -1e30 and its argmax is 0. best and bestj are the
// plain version's bits in every mode: the texture score reads best, and
// texture_match takes bestj as the correspondence.
//
// Bound: operations, 2 Lt Rt D flops per (latent, entry) pair (38.5 MFLOP at
// Lt = Rt = 448, D = 96) against ~0.3 MB read (7 KB of codes), at the f32
// rate with f32 latents and the bf16 tensor cores' rate with bf16 latents.
// Design: the row max is the screens' inner loop with another epilogue, so
// it runs on their bodies (screen_body.cuh) with its own rows policy,
// ArgRows, and the same column sources as the screens (CopyTC / CopyF32
// there, Codes in codes_src.cuh). A work item is (entry, group of latent
// rows), groups sized so that the rerank's single latent (1 x 64 entries at
// Lt 448 or 1000) still fills the card; persistent blocks keep their group
// and one codebook copy for their life, and decode or copy each column tile
// once for all of the group's rows:
//   - f32 latents: the f32 body on the CUDA cores, each dot in index order
//     with one rounding per product and per sum (--fmad=false), the first
//     argmax kept in column order: bit for bit the plain version.
//   - bf16 latents (bf16 or int8 gallery, bf16 codebook), D <= 96: the
//     tensor-core body (mma.sync) finds up to two candidate columns per
//     row within ops.rowmax_threshold of its maximum, recomputes them in
//     index order and takes the exact maximum (rows with three or more
//     candidates: an exact pass over all columns on the CUDA cores): bit
//     for bit the plain version.
//   - outside that envelope (bf16 with D > 96, an f32 tile beyond the
//     card's shared memory): the CUDA-core kernel below, one block per
//     64 latent rows of one (latent, entry) on adc_tile.cuh's 64 x 64
//     tiles, bit for bit the plain version.
// The body is chosen on the host from the shapes (afis_adc_rowmax_body);
// every launcher returns cudaGetLastError(). Codes and predecoded twins
// give the same bits on the same entry (both are the plain version's).
//
// Modes (dtypes.cuh): x is f32 or bf16 (the compute dtype, any int8 scale
// folded in); dec is x's type or int8; the codebook is x's type. Products
// of the typed operands are exact in f32 and everything after the dot is
// f32, as in the TPU kernel, which casts dec to x's type and accumulates
// in f32.
#include <type_traits>

#include "adc_tile.cuh"
#include "codes_src.cuh"

namespace {

using namespace afis_adc;

template <class XT, class Cols>
__global__ void __launch_bounds__(kThreads) adc_rowmax_kernel(
    const XT* __restrict__ x, const float* __restrict__ lsq, Cols cols,
    const float* __restrict__ rsq, const float* __restrict__ rvalid,
    float* __restrict__ best, int* __restrict__ bestj, int Lt, int B, int Rt,
    int D) {
  extern __shared__ float sm[];
  const int DP = D + 1;
  float* xs = sm;                      // [kTile][DP] latent rows
  float* ds = sm + kTile * DP;         // [kTile][DP] rolled columns
  cols.init(ds + kTile * DP);
  const int row0 = blockIdx.x * kTile, b = blockIdx.y, n = blockIdx.z;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;

  load_rows(xs, x, n, row0, Lt, D);
  float t6[4], bv[4];
  int bi[4];
  for (int q = 0; q < 4; ++q) {
    const int r = row0 + tr * 4 + q;
    t6[q] = r < Lt ? 6.f - lsq[(size_t)n * Lt + r] : 0.f;
    bv[q] = -INFINITY;
    bi[q] = 0;
  }

  for (int c0 = 0; c0 < Rt; c0 += kTile) {
    __syncthreads();
    cols.load(ds, b, c0, Rt, D);
    __syncthreads();
    float acc[4][4];
    tile_dots(xs, ds, D, tr, tc, acc);
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tc * 4 + j;
      if (c >= Rt) break;
      const float cr = rsq[(size_t)b * Rt + c];
      const float mask = (rvalid[(size_t)b * Rt + c] - 1.f) * 1e30f;
      for (int i = 0; i < 4; ++i) {
        const float s = (2.f * acc[i][j] + (t6[i] - cr)) + mask;
        if (s > bv[i]) { bv[i] = s; bi[i] = c; }
      }
    }
  }

  // merge the 16 column groups of each row (lanes of one half-warp)
  for (int i = 0; i < 4; ++i) {
    for (int off = 8; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi[i], off);
      if (ov > bv[i] || (ov == bv[i] && oi < bi[i])) { bv[i] = ov; bi[i] = oi; }
    }
    const int r = row0 + tr * 4 + i;
    if (tc == 0 && r < Lt) {
      const size_t o = ((size_t)n * B + b) * Lt + r;
      best[o] = bv[i];
      bestj[o] = bi[i];
    }
  }
}

// The CUDA-core tiles' launch.
template <class XT, class Cols>
int launch_tiles(const XT* x, const float* lsq, Cols cols, const float* rsq,
                 const float* rvalid, float* best, int* bestj, int NL,
                 int Lt, int B, int Rt, int D, void* stream) {
  if (B > 65535 || NL > 65535) return (int)cudaErrorInvalidValue;
  const size_t bytes =
      2 * (size_t)kTile * (D + 1) * sizeof(float) + cols.smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(
      adc_rowmax_kernel<XT, Cols>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Lt + kTile - 1) / kTile, B, NL);
  adc_rowmax_kernel<XT, Cols>
      <<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
          x, lsq, cols, rsq, rvalid, best, bestj, Lt, B, Rt, D);
  return (int)cudaGetLastError();
}

namespace sc = afis_screen;

// Rows refined between two candidates, rows sent to the exact pass, rows
// with no valid column, over every tensor-core launch since the last reset.
__device__ unsigned long long g_rowmax_counts[3];

enum Body { kBodyTC = 0, kBodyF32 = 1, kBodyTiles = 2 };

// One launch's operands; with `body` set, plan only and report the body.
struct Args {
  const void* x;
  const float* lsq;
  const float* rsq;
  const float* rvalid;
  const float* xl1;
  const float* cmax;
  float* best;
  int* bestj;
  int NL, Lt, B, Rt, D;
  void* stream;
  int* body;
};

template <class XT>
sc::ArgRows<XT> arg_rows(const Args& a) {
  return sc::ArgRows<XT>{static_cast<const XT*>(a.x), a.lsq, a.rsq,
                         a.rvalid, a.xl1, a.cmax, a.best, a.bestj, nullptr,
                         a.NL, a.Lt, a.B, a.Rt, a.D, a.NL * a.Lt, 0};
}

// The tensor-core body over column source src, if it takes the shape: 1 if
// not, else the launch's error (or 0 with a.body set).
template <class Src>
int try_tc(const Args& a, const Src& src, sc::Walk w) {
  if (a.D > sc::kDMax) return 1;
  sc::ArgRows<sc::bf16> rows = arg_rows<sc::bf16>(a);
  rows.plan(w, sc::sm_count(), sc::kRowsTC, true);
  if (sc::tc_smem_bytes(src, rows) > sc::smem_optin()) return 1;
  if (a.body) {
    *a.body = kBodyTC;
    return 0;
  }
  if (a.xl1 == nullptr || a.cmax == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaGetSymbolAddress(
      reinterpret_cast<void**>(&rows.counts), g_rowmax_counts);
  if (e != cudaSuccess) return (int)e;
  return sc::launch_tc(src, rows, w, a.stream);
}

// The f32 body over column source src, if its shared memory fits. Groups
// are planned for the blocks the card holds at once: where an SM holds two
// (the predecoded tiles need ~80 KB), for twice the SMs.
template <class Src>
int try_f32(const Args& a, const Src& src, sc::Walk w) {
  sc::ArgRows<float> rows = arg_rows<float>(a);
  const int sms = sc::sm_count();
  rows.plan(w, sms, sc::kMaxRowsF32, false);
  const size_t smem = sc::f32_smem_bytes(rows) + src.smem_bytes();
  if (smem > sc::smem_optin()) return 1;
  const auto kernel = sc::screen_f32_kernel<Src, sc::ArgRows<float>>;
  int per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      sc::kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm > 1) rows.plan(w, sms * per_sm, sc::kMaxRowsF32, false);
  if (a.body) {
    *a.body = kBodyF32;
    return 0;
  }
  return sc::launch_f32(src, rows, w, a.stream);
}

// The tiles, the last body: always takes the shape.
template <class XT, class Cols>
int run_tiles(const Args& a, Cols cols) {
  if (a.body) {
    *a.body = kBodyTiles;
    return 0;
  }
  return launch_tiles(static_cast<const XT*>(a.x), a.lsq, cols, a.rsq,
                      a.rvalid, a.best, a.bestj, a.NL, a.Lt, a.B, a.Rt, a.D,
                      a.stream);
}

bool valid_sizes(const Args& a) {
  return a.NL > 0 && a.Lt > 0 && a.B > 0 && a.Rt > 0 && a.D > 0
      && (long long)a.NL * a.Lt <= 0x7fffffffLL;
}

int rowmax(const Args& a, const void* dec, int xtype, int dtype) {
  if (!valid_sizes(a)) return (int)cudaErrorInvalidValue;
  return afis_t::dispatch_pair(xtype, dtype, [&](auto xt, auto dt) {
    using XT = typename decltype(xt)::type;
    using DT = typename decltype(dt)::type;
    const DT* dd = static_cast<const DT*>(dec);
    const sc::Walk w{a.B, a.Rt, sc::kCT, (a.Rt + sc::kCT - 1) / sc::kCT, 1,
                     1, true};
    int e = 1;
    if constexpr (std::is_same<XT, sc::bf16>::value) {
      e = try_tc(a, sc::CopyTC<DT, false>{dd, a.rsq, a.rvalid, a.D, a.D, 0,
                                          sc::copy_chunk(dd, a.D, a.D)},
                 w);
    } else {
      const uintptr_t p = reinterpret_cast<uintptr_t>(dd);
      e = try_f32(a, sc::CopyF32<DT>{dd, a.rsq, a.rvalid, a.D,
                                     a.D % 4 == 0 && p % (4 * sizeof(DT)) == 0},
                  w);
    }
    return e != 1 ? e : run_tiles<XT>(a, DecCols<DT>{dd});
  });
}

int rowmax_codes(const Args& a, const uint8_t* codes, const void* codebook,
                 int S, int C, int sub_dim, int xtype) {
  if (!valid_sizes(a) || S <= 0 || C <= 0 || C > 256 || sub_dim <= 0)
    return (int)cudaErrorInvalidValue;
  sc::Walk w{a.B, a.Rt, min(sc::kCT, (sc::kThreads * sc::kUnits / S) & ~7),
             0, 1, 1, true};
  w.ntiles = w.ct >= 8 ? (a.Rt + w.ct - 1) / w.ct : 0;
  return afis_t::dispatch_float(xtype, [&](auto xt) {
    using XT = typename decltype(xt)::type;
    const XT* cb = static_cast<const XT*>(codebook);
    int e = 1;
    if (w.ct >= 8) {
      const sc::Codes<XT> src{codes, cb, a.rsq, a.rvalid, S, C, sub_dim};
      if constexpr (std::is_same<XT, sc::bf16>::value)
        e = try_tc(a, src, w);
      else
        e = try_f32(a, src, w);
    }
    return e != 1 ? e
                  : run_tiles<XT>(a, CodeCols<XT>{codes, cb, S, C, sub_dim,
                                                  nullptr});
  });
}

}  // namespace

// xtype / dtype: the operands' type codes (dtypes.cuh). xl1 [NL, Lt] and
// cmax [B] (ops.rowmax_operand_norms) bound the tensor cores' sums; the
// other bodies do not read them (they may be null there).
extern "C" int afis_adc_rowmax(const void* x, const float* lsq,
                               const void* dec, const float* rsq,
                               const float* rvalid, float* best, int* bestj,
                               const float* xl1, const float* cmax, int NL,
                               int Lt, int B, int Rt, int D, int xtype,
                               int dtype, void* stream) {
  const Args a{x, lsq, rsq, rvalid, xl1, cmax, best, bestj, NL, Lt, B, Rt, D,
               stream, nullptr};
  return rowmax(a, dec, xtype, dtype);
}

// The codebook has x's type.
extern "C" int afis_adc_rowmax_codes(const void* x, const float* lsq,
                                     const uint8_t* codes,
                                     const void* codebook, const float* rsq,
                                     const float* rvalid, float* best,
                                     int* bestj, const float* xl1,
                                     const float* cmax, int NL, int Lt,
                                     int B, int Rt, int S, int C,
                                     int sub_dim, int xtype, void* stream) {
  const Args a{x, lsq, rsq, rvalid, xl1, cmax, best, bestj, NL, Lt, B, Rt,
               S * sub_dim, stream, nullptr};
  return rowmax_codes(a, codes, codebook, S, C, sub_dim, xtype);
}

// The body a launch of these shapes takes: 0 tensor cores, 1 the f32 body,
// 2 the CUDA-core tiles; negative: the launch would be refused (-error).
// S > 0: the codes variant (dtype ignored).
extern "C" int afis_adc_rowmax_body(int NL, int Lt, int B, int Rt, int D,
                                    int xtype, int dtype, int S, int C) {
  int body = -1;
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, NL, Lt, B, Rt, D, nullptr, &body};
  const int e = S > 0 ? rowmax_codes(a, nullptr, nullptr, S, C, D / S, xtype)
                      : rowmax(a, nullptr, xtype, dtype);
  return e != 0 ? -e : body;
}

// out [3] = the counts of g_rowmax_counts; reset != 0 zeroes them.
extern "C" int afis_adc_rowmax_counts(long long* out, int reset) {
  unsigned long long h[3] = {0, 0, 0};
  cudaError_t e = cudaMemcpyFromSymbol(h, g_rowmax_counts, sizeof h);
  if (e == cudaSuccess && reset) {
    const unsigned long long z[3] = {0, 0, 0};
    e = cudaMemcpyToSymbol(g_rowmax_counts, z, sizeof z);
  }
  for (int i = 0; i < 3; ++i) out[i] = (long long)h[i];
  return (int)e;
}

extern "C" const char* afis_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" const char* afis_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
