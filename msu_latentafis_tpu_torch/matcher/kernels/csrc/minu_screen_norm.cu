// Mutually normalized minutiae screening score.
//
// Replaces the JAX package's pallas_kernels.py fused_minu_screen with
// normalize=True (:1312, pallas_call :1370, body _minu_screen_kernel
// :1281). For every latent template t and entry b:
//   s    = (relu(ldes_t . rdes_b) * lv) * rv                [P, R]
//   row  = sum_r s, col = sum_p s                  (index order)
//   n    = ((s / (((row + col) - s) + 1e-6)) * lv) * rv
//   out[t, b] = min(sum_p max_r n, sum_r max_p n)   (index order)
// The descriptors are not zeroed before the product, unlike the fast path.
// It is a correlation heuristic, not a bound on the exact score.
//
// Bound: operations, 2 P R D flops per (template, entry) pair (the
// normalization's ~25 operations a pair of indices are not counted). The
// normalization needs whole row and column sums before any maximum. Two
// designs by the latent operand's type (minu_body.cuh):
//   - CUDA cores (f32 latents, and bf16 latents outside the tensor cores'
//     envelope), bit for bit the plain version: the fast path's body with
//     2 templates a block; each stage's s tile goes to shared memory once,
//     its row and column sums run as index-order chains, one thread per row
//     and per column, and the tile is normalized and folded from shared
//     memory. An entry too wide for one stage (R 1000 at P 128) takes two
//     passes over its 96-column chunks, the sums carried across them.
//   - tensor cores (bf16 latents, D <= 96, R <= 128, and one template's
//     [P, R] s in shared memory beside the entry, e.g. 8 of 24.8 KB at P
//     64 / R 96, 3 at the cap's 128 x 128): mma.sync.m16n8k16 bf16 -> f32
//     on the entry staged unscaled in bf16 (an int8 value is exact in
//     bf16; validity applies after the relu). A block walks entries, the
//     next entry's rows loaded into registers while the warps work on this
//     one; each warp takes a template: s = (relu(dot) * lv) * rv from the
//     accumulators into its own [P, R] in shared memory (rows padded to 32,
//     columns to 8, stores without bounds checks), then the row and column
//     sums (a lane per row, two rows at a time; a lane per column, its
//     columns at once; index order), the normalization in place with the
//     column maxima in registers (a lane per column, two rows at a time,
//     the division without its range check when a warp vote finds every
//     operand in range), the row maxima (a lane per row) and the two final
//     sums, all in the f32 order of the plain version. Only the dots' order
//     differs (the tensor cores' k-steps), held within
//     ops.minu_norm_interval.
#include <algorithm>

#include "minu_body.cuh"

namespace {

using namespace afis_minu;

// 16-byte units of an entry's bf16 rows (R <= kRC, D <= 96) a thread holds
constexpr int kPreUnits =
    kRC * afis_mma::kMaxKSteps * afis_mma::kK * 2 / 16 / kThreads;

// A warp's [P, R] of s: rows padded to 32, columns to 8 and then to an odd
// stride (no bank holds two rows' elements of one column step).
__host__ __device__ inline int s_stride(int R) { return ((R + 7) & ~7) | 1; }
__host__ __device__ inline size_t s_floats(int P, int R) {
  const int P32 = (P + 31) & ~31;
  return (size_t)P32 * s_stride(R) + P32;
}

// NC: entry columns a lane holds (lane + 32 k, k < NC), R <= 32 NC.
template <class RT, int NC>
__global__ void __launch_bounds__(kThreads, 1) minu_screen_norm_tc_kernel(
    const bf16* __restrict__ ldes, const float* __restrict__ lvalid,
    const RT* __restrict__ rdes, const float* __restrict__ rvalid,
    float* __restrict__ out, int NT, int P, int B, int R, int D, int W,
    int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* es = reinterpret_cast<bf16*>(smem);                   // [kRC][kLdE]
  float* rvs = reinterpret_cast<float*>(es + kRC * kLdE);     // [kRC]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, cq = lane & 3;
  const int SR = s_stride(R), P32 = (P + 31) & ~31, R4 = R & ~3, P4 = P & ~3;
  float* sw = rvs + kRC + (size_t)warp * s_floats(P, R);  // [P32][SR]
  float* rw = sw + (size_t)P32 * SR;                        // [P32]
  for (int i = tid; i < kRC * kLdE / 8; i += kThreads)
    reinterpret_cast<uint4*>(es)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < kRC; i += kThreads) rvs[i] = 0.f;

  // the next entry's rows (16-byte units of R x D) and validity, loaded
  // into registers ahead of its turn
  constexpr int kEpu = 16 / sizeof(RT);
  const int units = vec ? R * D / kEpu : 0;
  uint4 pre[kPreUnits];
  float prv = 0.f;
  const auto fetch = [&](int b) {
    const uint4* src = reinterpret_cast<const uint4*>(rdes + (size_t)b * R * D);
#pragma unroll
    for (int u = 0; u < kPreUnits; ++u)
      if (tid + u * kThreads < units) pre[u] = __ldg(src + tid + u * kThreads);
    if (tid < R) prv = __ldg(rvalid + (size_t)b * R + tid);
  };
  const auto put = [&](int b) {
    if (!vec) {
      stage_entry<RT>(es, rdes, nullptr, b, 0, R, R, D);
    } else {
#pragma unroll
      for (int u = 0; u < kPreUnits; ++u) {
        const int idx = tid + u * kThreads;
        if (idx >= units) continue;
        const int e = idx * kEpu, c = e / D, k = e - c * D;
        bf16* dst = es + c * kLdE + k;
        if constexpr (sizeof(RT) == 2) {
          *reinterpret_cast<uint4*>(dst) = pre[u];
        } else {
          const int8_t* v = reinterpret_cast<const int8_t*>(&pre[u]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t w[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              w[q] = afis_mma::pack(
                  __float2bfloat16_rn((float)v[8 * h + 2 * q]),
                  __float2bfloat16_rn((float)v[8 * h + 2 * q + 1]));
            *reinterpret_cast<uint4*>(dst + 8 * h) =
                make_uint4(w[0], w[1], w[2], w[3]);
          }
        }
      }
    }
    if (tid < R) rvs[tid] = prv;
  };

  // one warp, template t against the staged entry b
  const auto norm_template = [&](int t, int b) {
    const bf16* lt = ldes + (size_t)t * P * D;
    const float* lv = lvalid + (size_t)t * P;
    const int nn = (R + 7) >> 3;
    // s = (relu(dot) * lv) * rv from the accumulators; odd: some s in
    // (0, 2^-66) or sum above 2^59 (norm_n)
    bool odd = false;
    for (int mp = 0; mp < P; mp += 32) {
      uint32_t a[2][afis_mma::kMaxKSteps][4];
      tc_rows(a, lt, P, D, mp, [](int) { return 1.f; });
      float l[2][2];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mp + 16 * m + g + 8 * h;
          l[m][h] = r < P ? __ldg(lv + r) : 0.f;
        }
#pragma unroll
      for (int n = 0; n < kRC / 8; ++n) {
        if (n >= nn) break;
        float acc[2][4];
        tc_cols(a, es, n * 8, acc);
        const int c = n * 8 + 2 * cq;
        const float rv0 = rvs[c], rv1 = rvs[c + 1];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {   // padding rows and columns get 0
            float* o = sw + (mp + 16 * m + g + 8 * h) * SR + c;
            const float s0 = norm_s(acc[m][2 * h], l[m][h], rv0);
            const float s1 = norm_s(acc[m][2 * h + 1], l[m][h], rv1);
            o[0] = s0;
            o[1] = s1;
            odd |= small_s(s0) || small_s(s1);
          }
      }
    }
    __syncwarp();
    // row sums (rows lane + 32 q, two chains at a time) into rw, column
    // sums (columns lane + 32 k) in registers, in index order; the chains
    // of padding rows and columns run on and are dropped
    for (int q0 = 0; q0 < P32 / 32; q0 += 2) {
      const float* r0 = sw + (lane + 32 * q0) * SR;
      const float* r1 = sw + (lane + 32 * min(q0 + 1, P32 / 32 - 1)) * SR;
      float a0 = 0.f, a1 = 0.f;
      int c = 0;
      for (; c < R4; c += 4) {
        const float4 x0 = make_float4(r0[c], r0[c + 1], r0[c + 2], r0[c + 3]);
        const float4 x1 = make_float4(r1[c], r1[c + 1], r1[c + 2], r1[c + 3]);
        a0 = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(a0, x0.x), x0.y), x0.z),
                       x0.w);
        a1 = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(a1, x1.x), x1.y), x1.z),
                       x1.w);
      }
      for (; c < R; ++c) {
        a0 = __fadd_rn(a0, r0[c]);
        a1 = __fadd_rn(a1, r1[c]);
      }
      if (lane + 32 * q0 < P) rw[lane + 32 * q0] = a0;
      if (q0 + 1 < P32 / 32 && lane + 32 * (q0 + 1) < P)
        rw[lane + 32 * (q0 + 1)] = a1;
      odd |= large_sum(a0) || large_sum(a1);
    }
    float cs[NC], cm[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      cs[k] = 0.f;
      cm[k] = -INFINITY;
    }
    {
      const float* col = sw + lane;        // columns past R8 fold onto R8 - 1
      int p = 0;
      for (; p < P4; p += 4) {
        float x[4][NC];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int k = 0; k < NC; ++k)
            x[j][k] = col[(p + j) * SR + min(32 * k, SR - 1 - lane)];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int k = 0; k < NC; ++k) cs[k] = __fadd_rn(cs[k], x[j][k]);
      }
      for (; p < P; ++p)
#pragma unroll
        for (int k = 0; k < NC; ++k)
          cs[k] = __fadd_rn(cs[k], col[p * SR + min(32 * k, SR - 1 - lane)]);
#pragma unroll
      for (int k = 0; k < NC; ++k)
        odd |= lane + 32 * k < R && large_sum(cs[k]);
    }
    const bool fast = !__any_sync(kFull, odd);
    // normalize in place, two rows at a time; column maxima in registers
    float rvk[NC];
    int ck[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      rvk[k] = rvs[min(lane + 32 * k, kRC - 1)];
      ck[k] = min(32 * k, SR - 1 - lane);   // past R8: the stride's pad
    }
    const auto normalize_all = [&](auto fast_div) {
      const auto normalize_row = [&](int p, const float (&x)[NC],
                                     float (&y)[NC]) {
        const float row = rw[p], l = __ldg(lv + p);
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          y[k] = norm_n<decltype(fast_div)::value>(x[k], row, cs[k], l,
                                                   rvk[k]);
          if (lane + 32 * k < R) cm[k] = fmaxf(cm[k], y[k]);
        }
      };
      {
        int p = 0;
        for (; p + 1 < P; p += 2) {
          float* s0 = sw + p * SR + lane;
          float* s1 = s0 + SR;
          float x0[NC], x1[NC], y0[NC], y1[NC];
#pragma unroll
          for (int k = 0; k < NC; ++k) {
            x0[k] = s0[ck[k]];
            x1[k] = s1[ck[k]];
          }
          normalize_row(p, x0, y0);
          normalize_row(p + 1, x1, y1);
#pragma unroll
          for (int k = 0; k < NC; ++k) {
            s0[ck[k]] = y0[k];
            s1[ck[k]] = y1[k];
          }
        }
        if (p < P) {
          float* s0 = sw + p * SR + lane;
          float x0[NC], y0[NC];
#pragma unroll
          for (int k = 0; k < NC; ++k) x0[k] = s0[ck[k]];
          normalize_row(p, x0, y0);
#pragma unroll
          for (int k = 0; k < NC; ++k) s0[ck[k]] = y0[k];
        }
      }
    };
    if (fast)
      normalize_all(std::true_type{});
    else
      normalize_all(std::false_type{});
    __syncwarp();
    // row maxima (rows lane + 32 q, two at a time) over their sums in rw
    for (int q0 = 0; q0 < P32 / 32; q0 += 2) {
      const float* r0 = sw + (lane + 32 * q0) * SR;
      const float* r1 = sw + (lane + 32 * min(q0 + 1, P32 / 32 - 1)) * SR;
      float m0 = -INFINITY, m1 = -INFINITY;
      int c = 0;
      for (; c < R4; c += 4) {
        m0 = fmaxf(m0, fmaxf(fmaxf(r0[c], r0[c + 1]), fmaxf(r0[c + 2],
                                                           r0[c + 3])));
        m1 = fmaxf(m1, fmaxf(fmaxf(r1[c], r1[c + 1]), fmaxf(r1[c + 2],
                                                           r1[c + 3])));
      }
      for (; c < R; ++c) {
        m0 = fmaxf(m0, r0[c]);
        m1 = fmaxf(m1, r1[c]);
      }
      if (lane + 32 * q0 < P) rw[lane + 32 * q0] = m0;
      if (q0 + 1 < P32 / 32 && lane + 32 * (q0 + 1) < P)
        rw[lane + 32 * (q0 + 1)] = m1;
    }
    __syncwarp();
    // the column maxima over row 0 of sw; the two sums in index order
#pragma unroll
    for (int k = 0; k < NC; ++k)
      if (lane + 32 * k < R) sw[lane + 32 * k] = cm[k];
    __syncwarp();
    float v = 0.f;
    if (lane < 2)
      v = ordered_sum(lane == 0 ? P : R,
                      [&](int i) { return lane == 0 ? rw[i] : sw[i]; });
    const float cols_side = __shfl_sync(kFull, v, 1);
    if (lane == 0) out[(size_t)t * B + b] = fminf(v, cols_side);
    __syncwarp();
  };

  int b = blockIdx.x;
  if (b < B) fetch(b);
  for (; b < B; b += gridDim.x) {
    __syncthreads();     // the zeroing, or the last entry's readers
    put(b);
    __syncthreads();
    if (b + (int)gridDim.x < B) fetch(b + gridDim.x);
    if (warp >= W) continue;
    for (int t = warp; t < NT; t += W) norm_template(t, b);
  }
}

// Warps of a tensor-core block that hold a template's [P, R] beside the
// entry (0: the launch goes to the CUDA cores).
int tc_warps(int P, int R, int D, size_t limit) {
  if (D > afis_mma::kMaxKSteps * afis_mma::kK || R > kRC) return 0;
  const size_t base = kRC * kLdE * sizeof(bf16) + kRC * sizeof(float);
  const size_t per = s_floats(P, R) * sizeof(float);
  if (limit <= base) return 0;
  return (int)std::min<size_t>(kWarps, (limit - base) / per);
}

template <class RT, int NC>
int launch_tc(const void* ldes, const float* lvalid, const void* rdes,
              const float* rvalid, float* out, int NT, int P, int B, int R,
              int D, int W, void* stream) {
  const size_t bytes = kRC * kLdE * sizeof(bf16) + kRC * sizeof(float)
      + (size_t)W * s_floats(P, R) * sizeof(float);
  const int vec = (D * (int)sizeof(RT)) % 16 == 0
      && (reinterpret_cast<uintptr_t>(rdes) & 15) == 0;
  const auto kernel = minu_screen_norm_tc_kernel<RT, NC>;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<std::min(B, sms), kThreads, bytes, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(ldes), lvalid, static_cast<const RT*>(rdes),
      rvalid, out, NT, P, B, R, D, W, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// ltype / rtype: the descriptors' type codes (dtypes.cuh).
extern "C" int afis_minu_screen_norm(const void* ldes, const float* lvalid,
                                     const void* rdes, const float* rvalid,
                                     float* out, int NT, int P, int B, int R,
                                     int D, int ltype, int rtype,
                                     void* stream) {
  if (NT <= 0 || P <= 0 || B <= 0 || R <= 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  if (ltype == afis_t::kBF16) {
    const int W = tc_warps(P, R, D, smem_optin());
    const auto run = [&](auto rt) {
      using RT = typename decltype(rt)::type;
      return R <= 96 ? launch_tc<RT, 3>(ldes, lvalid, rdes, rvalid, out, NT,
                                        P, B, R, D, W, stream)
                     : launch_tc<RT, 4>(ldes, lvalid, rdes, rvalid, out, NT,
                                        P, B, R, D, W, stream);
    };
    if (W > 0 && rtype == afis_t::kBF16) return run(afis_t::Tag<bf16>{});
    if (W > 0 && rtype == afis_t::kI8) return run(afis_t::Tag<int8_t>{});
  }
  return afis_t::dispatch_pair(ltype, rtype, [&](auto lt, auto rt) {
    using LT = typename decltype(lt)::type;
    using RT = typename decltype(rt)::type;
    return launch_screen<LT, RT, true>(ldes, lvalid, rdes, rvalid, out, NT,
                                       P, B, R, D, stream);
  });
}
