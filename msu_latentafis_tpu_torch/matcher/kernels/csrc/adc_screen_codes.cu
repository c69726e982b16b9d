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
// the bodies shared with the predecoded screen (adc_screen.cu), with a
// codes column source; afis_adc_screen_codes_body names the one a shape
// takes (ops.SCREEN_BODIES):
//   - bf16 (the JAX engine's bf16 decode tensor), S * sub_dim <= 96:
//     "wgmma", screen_wg.cuh. Each block copies the codebook into shared
//     memory once; its producer warpgroup brings each tile of 128 columns'
//     codes in by a bulk copy and decodes them (four subspaces, 24
//     features, at a time at sub_dim 6) straight into the layout wgmma
//     reads; two consumer warpgroups apply each decoded tile to every
//     latent row of the group (A fragments of up to 512 rows in registers)
//     and take turns between their products and their row-max folds.
//     Latents of at most 512 rows make groups of whole latents and a block
//     keeps one group for its life (the serving prescreen's 8 x 64 rows
//     are one group, so every tile is decoded once per entry); longer
//     latents are walked in groups of 512 by every block. The decoded
//     values are exact codebook entries and the products exact, so only
//     the order of the f32 accumulation differs from the plain version:
//     each raw[i] may round to the neighbouring bf16 value (ops.
//     screen_slack). The predecoded screen runs the same instructions on
//     the same tile, so the two give the same bits.
//   - f32: "f32 body", CUDA cores, each dot in index order with one
//     rounding per product and per sum (--fmad=false), bit for bit the
//     plain version and the predecoded adc_screen.cu. The latent rows
//     (196 KB at the prescreen) stream from L2 in 64-row tiles (cp.async)
//     against the decoded tile (codes_src.cuh); the running row maxima of
//     up to 4,096 rows sit in shared memory.
// Each row maximum folds (acc + a1) + a2 with the tile's columns past Rt at
// a1 = -inf; a group's terms then add into per-latent sums in row order.
#include "screen_wg.cuh"

using namespace afis_screen;

namespace {

enum Body { kBodyWg = 0, kBodyF32 = 1 };

// The codes screen's launch; with `body` set, plan only and report the
// body.
int codes_screen(const void* x, const float* lsq, const float* lvalid,
                 const uint8_t* codes, const void* codebook, const float* a1,
                 const float* a2, float* out, int NL, int Lt, int B, int Rt,
                 int S, int C, int sub_dim, float tau, int xtype,
                 void* stream, int* body) {
  if (NL <= 0 || Lt <= 0 || B <= 0 || Rt <= 0 || S <= 0 || C <= 0
      || C > 256 || sub_dim <= 0 || (long long)NL * Lt > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int D = S * sub_dim;
  if (xtype == afis_t::kBF16) {
    if (D > kDMax) return (int)cudaErrorInvalidValue;
    Walk w{B, Rt, kCT, (Rt + kCT - 1) / kCT, 1, 1, false};
    LatRows<bf16> rows{static_cast<const bf16*>(x), lsq, lvalid, out, NL,
                       Lt, B, D, NL * Lt, 0, tau};
    plan_wg(rows, w);
    const WgCodes src{codes, static_cast<const bf16*>(codebook), a1, a2, S,
                      C, sub_dim,
                      S % 16 == 0
                          && reinterpret_cast<uintptr_t>(codes) % 16 == 0};
    if (wg_smem_bytes(src, rows) > smem_optin())
      return (int)cudaErrorInvalidValue;
    if (body) {
      *body = kBodyWg;
      return 0;
    }
    return launch_wg(src, rows, w, stream);
  }
  if (xtype == afis_t::kF32) {
    Walk w{B, Rt, min(kCT, (kThreads * kUnits / S) & ~7), 0, 1, 1, false};
    if (w.ct < 8) return (int)cudaErrorInvalidValue;
    w.ntiles = (Rt + w.ct - 1) / w.ct;
    if (body) {
      *body = kBodyF32;
      return 0;
    }
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
  return codes_screen(x, lsq, lvalid, codes, codebook, a1, a2, out, NL, Lt,
                      B, Rt, S, C, sub_dim, tau, xtype, stream, nullptr);
}

// The body a launch of these shapes takes: 0 wgmma, 1 the f32 body;
// negative: the launch would be refused (-error).
extern "C" int afis_adc_screen_codes_body(int NL, int Lt, int B, int Rt,
                                          int S, int C, int sub_dim,
                                          int xtype) {
  int body = -1;
  const int e = codes_screen(nullptr, nullptr, nullptr, nullptr, nullptr,
                             nullptr, nullptr, nullptr, NL, Lt, B, Rt, S, C,
                             sub_dim, 0.f, xtype, nullptr, &body);
  return e != 0 ? -e : body;
}
