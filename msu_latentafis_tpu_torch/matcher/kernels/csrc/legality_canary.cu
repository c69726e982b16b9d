// The launch-legality canary: a copy whose launch plan the caller chooses.
//
// Replaces the Pallas kernel of the JAX package's
// tests/test_mosaic_legality.py (test_export_canary_catches_illegal_blocks,
// pallas_call :44): a copy of an [8, 128, 448] f32 array with a block plan
// the TPU's lowering must refuse before it reaches the chip, or the file's
// other checks mean nothing. On Hopper the same guarantee carries the
// port's rule that a CUDA tensor launches its kernel or raises: a launch
// the card refuses (more dynamic shared memory than
// cudaDevAttrMaxSharedMemoryPerBlockOptin, more threads than a block
// takes) never runs, and only cudaGetLastError() right after it says so. A
// refused launch must come back as that error, never as stale output, and
// must not disturb the next launch.
//
// Plan: ``threads`` per block and ``smem_bytes`` of dynamic shared memory,
// both given to the launch as they are, so the card refuses exactly the
// plans it refuses for any kernel, through the launch's own error; nothing
// answers before the launch. The shared memory is reserved, not used: a
// copy needs none, and staging through it measured slower than the direct
// copy. Bound: bytes, the array read once and written once (3.67 MB at the
// smoke's shape: 1.1 us at 3.35 TB/s).
//
// Design: the work is not tied to the plan. A persistent grid of
// min(work, SMs x the blocks an SM holds at this plan) strides over the
// array in 16-byte units aligned to y, float4 loads and stores, kInFlight
// loads in flight per thread before their stores (the occupancy query
// sizes the grid; a plan the query refuses gets one block per SM and the
// launch's error). Edges: block 0 copies the floats before y's first
// 16-byte boundary and after the last whole unit; where x is not aligned
// like y, a unit is loaded as four floats. Every plan copies bit for bit,
// for any n and any 4-byte offset of either pointer.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInFlight = 4;     // 16-byte loads per thread at once
constexpr int kMaxDevices = 64;

struct Plan {
  long long units;   // 16-byte units of y from y + head
  int head;          // floats before the first unit
  int co;            // x + head is 16-byte aligned too
};

__global__ void __launch_bounds__(1024) canary_copy_kernel(
    const float* __restrict__ x, float* __restrict__ y, long long n,
    Plan p) {
  const float* xs = x + p.head;
  float4* ys = reinterpret_cast<float4*>(y + p.head);
  if (blockIdx.x == 0) {
    const long long tail0 = p.head + 4 * p.units;
    for (int e = threadIdx.x; e < 8; e += blockDim.x) {
      const long long i = e < 4 ? e : tail0 + e - 4;
      if (e < 4 ? i < p.head : i < n) y[i] = x[i];
    }
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       u < p.units; u += kInFlight * stride) {
    float4 v[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      const long long uk = u + k * stride;
      if (uk >= p.units) break;
      v[k] = p.co ? __ldg(reinterpret_cast<const float4*>(xs) + uk)
                  : make_float4(xs[4 * uk], xs[4 * uk + 1], xs[4 * uk + 2],
                                xs[4 * uk + 3]);
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      const long long uk = u + k * stride;
      if (uk >= p.units) break;
      ys[uk] = v[k];
    }
  }
}

// Per device, set once: the opt-in limit (the kernel is opted in to it),
// the SM count, and the occupancy of the last plan asked for.
struct DeviceState {
  int limit, sms, threads, smem, per_sm;
};
DeviceState g_dev[kMaxDevices];

// The state of the current device, set up at its first call.
int device_state(DeviceState** out) {
  int dev = -1;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  DeviceState& s = g_dev[dev];
  if (s.limit <= 0) {
    int limit = 0, sms = 0;
    e = cudaDeviceGetAttribute(&limit,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    // opted in to the card's limit, not to the plan: a plan above the
    // limit reaches the launch, and the launch's own error comes back
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(canary_copy_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               limit);
    if (e != cudaSuccess) return (int)e;
    s = DeviceState{limit, sms > 0 ? sms : 1, -1, -1, 0};
  }
  *out = &s;
  return (int)cudaSuccess;
}

// The blocks an SM holds at (threads, smem_bytes), 0 where the occupancy
// query refuses the plan (its error cleared: it is not the launch's).
int per_sm(DeviceState& s, int threads, int smem_bytes) {
  if (threads != s.threads || smem_bytes != s.smem) {
    int occ = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &occ, canary_copy_kernel, threads, (size_t)smem_bytes)
        != cudaSuccess) {
      cudaGetLastError();
      occ = 0;
    }
    s.threads = threads;
    s.smem = smem_bytes;
    s.per_sm = occ;
  }
  return s.per_sm;
}

}  // namespace

// The card's opt-in limit of dynamic shared memory per block, in bytes
// (0 on error).
extern "C" int afis_max_smem_optin() {
  DeviceState* s = nullptr;
  return device_state(&s) == (int)cudaSuccess ? s->limit : 0;
}

// y = x (n floats) with the given plan on the current device; returns the
// launch's own error.
extern "C" int afis_legality_canary(const float* x, float* y, long long n,
                                    int threads, int smem_bytes,
                                    void* stream) {
  if (n <= 0 || threads <= 0 || smem_bytes < 0)
    return (int)cudaErrorInvalidValue;
  const uintptr_t ya = reinterpret_cast<uintptr_t>(y);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  if ((xa | ya) & 3) return (int)cudaErrorInvalidValue;
  DeviceState* s = nullptr;
  const int e = device_state(&s);
  if (e != (int)cudaSuccess) return e;
  Plan p;
  p.head = (int)(((16 - (ya & 15)) & 15) / 4);
  if (p.head > n) p.head = (int)n;
  p.units = (n - p.head) / 4;
  p.co = ((xa + 4 * p.head) & 15) == 0;
  // a plan the query refuses: one block per SM, and the launch decides
  const int occ = per_sm(*s, threads, smem_bytes);
  const long long work = (p.units + threads - 1) / threads;
  const long long cap = (long long)s->sms * occ;
  const long long blocks = occ > 0 ? (work < cap ? work : cap) : s->sms;
  canary_copy_kernel<<<(unsigned)(blocks > 0 ? blocks : 1), threads,
                       smem_bytes, (cudaStream_t)stream>>>(x, y, n, p);
  return (int)cudaGetLastError();
}
