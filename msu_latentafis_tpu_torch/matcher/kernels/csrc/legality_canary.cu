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
// Plan: ``threads`` per block and ``smem_bytes`` of dynamic shared memory.
// Each block stages max(threads, smem_bytes / 4) floats through shared
// memory when smem_bytes > 0, else copies directly. Bound: bytes, the
// array read once and written once.
#include <cuda_runtime.h>

namespace {

__global__ void canary_copy_kernel(const float* __restrict__ x,
                                   float* __restrict__ y, long long n,
                                   int chunk, int staged) {
  extern __shared__ float buf[];
  const long long base = (long long)blockIdx.x * chunk;
  for (int i = threadIdx.x; i < chunk && base + i < n; i += blockDim.x) {
    if (staged) buf[i] = x[base + i];
    else y[base + i] = x[base + i];
  }
  if (!staged) return;
  __syncthreads();
  for (int i = threadIdx.x; i < chunk && base + i < n; i += blockDim.x)
    y[base + i] = buf[i];
}

}  // namespace

// The card's opt-in limit of dynamic shared memory per block, in bytes
// (0 on error).
extern "C" int afis_max_smem_optin() {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&limit,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev) != cudaSuccess)
    return 0;
  return limit;
}

// y = x (n floats) with the given plan. The kernel is opted in to the
// card's limit, not to the plan, so a plan above the limit reaches the
// launch, and the launch's own error comes back.
extern "C" int afis_legality_canary(const float* x, float* y, long long n,
                                    int threads, int smem_bytes,
                                    void* stream) {
  if (n <= 0 || threads <= 0 || smem_bytes < 0)
    return (int)cudaErrorInvalidValue;
  const int limit = afis_max_smem_optin();
  if (limit <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      canary_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      limit);
  if (e != cudaSuccess) return (int)e;
  const int staged = smem_bytes > 0;
  const int chunk = staged ? smem_bytes / 4 : threads;
  if (chunk <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + chunk - 1) / chunk;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  canary_copy_kernel<<<(unsigned)blocks, threads, smem_bytes,
                       (cudaStream_t)stream>>>(x, y, n, chunk, staged);
  return (int)cudaGetLastError();
}
