// Operand types of the matcher's kernels.
//
// The JAX engine runs in f32 or, for throughput, in bf16, and may keep its
// gallery descriptors as int8 (tex_int8 / minu_int8). Its kernels cast
// every tile to the latent operand's type and accumulate in f32. Here the
// CUDA-core kernels widen each value to f32 as they copy a tile to shared
// memory: a bf16 x bf16, bf16 x int8 or f32 x int8 product is then one f32
// product, exact for the first two, and the sums keep their index order.
// The tensor-core screens (bf16 latents) stage an int8 gallery as bf16,
// exactly, and their products are exact too; only their sums' order
// differs.
//
// Launchers take each operand's type as a code (ops.py DTYPE_CODE) and
// dispatch to the instantiation for the pairs the JAX engine produces: the
// latent side f32 or bf16, the gallery side the latent's type or int8.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace afis_t {

enum Dtype { kF32 = 0, kBF16 = 1, kI8 = 2 };

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(int8_t v) { return (float)v; }

// Rounds an f32 value to the latent operand's type and back, as the TPU
// kernels' outputs in x.dtype do (round to nearest even).
template <class T>
__device__ __forceinline__ float round_to(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <class T>
struct Tag {
  using type = T;
};

inline bool valid_pair(int lt, int gt) {
  return (lt == kF32 || lt == kBF16) && (gt == lt || gt == kI8);
}

// f(Tag<L>{}, Tag<G>{}) for the latent / gallery pair (lt, gt); an error
// for any other pair.
template <class F>
int dispatch_pair(int lt, int gt, F&& f) {
  if (lt == kF32 && gt == kF32) return f(Tag<float>{}, Tag<float>{});
  if (lt == kF32 && gt == kI8) return f(Tag<float>{}, Tag<int8_t>{});
  if (lt == kBF16 && gt == kBF16) return f(Tag<bf16>{}, Tag<bf16>{});
  if (lt == kBF16 && gt == kI8) return f(Tag<bf16>{}, Tag<int8_t>{});
  return (int)cudaErrorInvalidValue;
}

// f(Tag<T>{}) for one float type: f32 or bf16.
template <class F>
int dispatch_float(int t, F&& f) {
  if (t == kF32) return f(Tag<float>{});
  if (t == kBF16) return f(Tag<bf16>{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace afis_t
