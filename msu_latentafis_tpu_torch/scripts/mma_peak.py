#!/usr/bin/env python
"""The card's rate for the warp-level tensor-core instructions the port's
kernels issue: mma.sync.m16n8k32 s8 x s8 -> s32 (the transposed int8
screen) and mma.sync.m16n8k16 bf16 x bf16 -> f32 (the bf16 screens, the
row max, the normalized minutiae screen).

    python -m msu_latentafis_tpu_torch.scripts.mma_peak

Each warp runs ITERS rounds of CHAINS independent accumulator chains on
register operands (no memory traffic), 2 blocks an SM of 4, 8 or 16 warps.
One JSON line per instruction and block size: TOPS (2 m n k per
instruction), ms (CUDA events over one launch), the card and its power
limit. The published dense peaks (1,979 int8 TOPS, 989 bf16 TFLOP/s on the
H100 SXM) are wgmma's; this is the ceiling of a kernel built on mma.sync.
The source is written into the ignored build directory and built there
with nvcc; it is never part of the port's library.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ITERS = 4000
CHAINS = 8
SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// one instruction on chain d (volatile: never merged, hoisted or dropped)
__device__ __forceinline__ void step(int (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void step(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <class T>
__global__ void mma_loop(int* out, int iters) {
  const uint32_t a[4] = {threadIdx.x, 2u, 3u, 4u}, b0 = 5u, b1 = 6u;
  T d[CHAINS][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) step(d[c], a, b0, b1);
  T s = 0;
  for (int c = 0; c < CHAINS; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  if (s == (T)12345) out[0] = 1;   // keeps the chains live
}
extern "C" int mma_peak(int which, int blocks, int threads, int iters,
                        int* out, void* stream) {
  if (which == 0)
    mma_loop<int><<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  else
    mma_loop<float><<<blocks, threads, 0, (cudaStream_t)stream>>>(out,
                                                                  iters);
  return (int)cudaGetLastError();
}
"""
# instruction -> (kernel selector, operations per instruction: 2 m n k)
INSTRUCTIONS = {"mma.sync.m16n8k32.s8": (0, 2 * 16 * 8 * 32),
                "mma.sync.m16n8k16.bf16": (1, 2 * 16 * 8 * 16)}


def build() -> ctypes.CDLL:
    from msu_latentafis_tpu_torch.matcher.kernels import _build
    work = _build.BUILD_DIR / "mma_peak"
    work.mkdir(parents=True, exist_ok=True)
    src, lib = work / "mma_peak.cu", work / "libmma_peak.so"
    src.write_text(f"#define CHAINS {CHAINS}\n" + SOURCE)
    run = subprocess.run(
        [_build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
         str(lib), str(src)], capture_output=True, text=True,
        timeout=_build.BUILD_TIMEOUT_S)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc failed ({run.returncode}):\n{run.stderr}")
    dll = ctypes.CDLL(str(lib))
    dll.mma_peak.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    return dll


def run(emit=print) -> list:
    import torch
    from msu_latentafis_tpu_torch.utils.timing import card_line
    dll = build()
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    card = card_line()
    rows = []
    for name, (which, ops) in INSTRUCTIONS.items():
        for warps in (4, 8, 16):
            args = (which, 2 * sms, 32 * warps)
            if dll.mma_peak(*args, 10, out.data_ptr(), stream) != 0:
                raise RuntimeError(f"{name}: the warm-up launch failed")
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            err = dll.mma_peak(*args, ITERS, out.data_ptr(), stream)
            b.record()
            torch.cuda.synchronize()
            if err != 0:
                raise RuntimeError(f"{name}: launch failed ({err})")
            ms = a.elapsed_time(b)
            total = 2 * sms * warps * ITERS * CHAINS * ops
            rows.append(dict(instruction=name, warps_per_block=warps,
                             blocks_per_sm=2, tops=total / ms / 1e9,
                             ms=ms, card=card))
            emit(json.dumps(rows[-1]))
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mma_peak: no CUDA device", file=sys.stderr)
        return 2
    run(lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    sys.exit(main())
