#!/usr/bin/env python
"""Where one block of the match kernels and the minutiae screens spends
its cycles.

    python -m msu_latentafis_tpu_torch.scripts.stage_clocks

Copies the kernels' sources into the ignored build directory, puts a
``clock64()`` stamp after each stage of the two kernels and of the filter
body (thread 0, after a block barrier: every stage ends at one anyway, so
the stamps add a barrier per stage and little else), builds that copy and
runs it at the shapes the main paths launch: the dense block (4 latents x
3 templates x 64 entries at the 448 shape, with and without a mate), the
rerank block (1 latent x 64 entries), the cap rerank block (P = R = 128,
Lt = Rt = 1000) and a 1,000-minutiae print (the workspace); then the two
minutiae screens at the serving chunk's shape (8 templates of P 64
against 16,384 entries of R 96): the fast path (f32) and the normalized
screen (f32 on the CUDA cores, bf16 on the tensor cores). Per launch one
JSON line: CUDA-event ms per launch of the stamped kernel, the blocks, the
per-block wall time (globaltimer) min / mean / max, and per stage the
cycles of block 0, the mean over blocks and the slowest block's. The
stamped copy is never the library the port loads.

The stages: minutiae_match sim (descriptor tiles and similarity), sums,
norm+extract, bisect, ranks (slot scans and band ranks), slots (fill and
gather); texture_match load (row maxima, window, n_valid), bisect, ranks,
slots; then the filter body's H1 (table build), power1, greedy1 (with the
blockers), compact, H2, power2, greedy2, total. The screens' CUDA-core
body (minu_body.cuh), per stage of its walk: stage (waiting for the
stage's copies, widening them), epilogue (the previous stage's maxima and
sums), dots (the products, and for the normalized screen their s tiles),
sums and normalize (the normalized screen); the tensor-core normalized
screen: stage (the entry into shared memory), then warp 0's template: s
(the products), sums, normalize (with the maxima), final (the two sums).
Each stamp goes before or
after an anchor, a line of the sources that occurs once
(tests/test_torch_scripts.py checks that every anchor is found).
"""
import argparse
import ctypes
import json
import shutil
import sys
from pathlib import Path

NSLOT = 32
MAXB = 8192
STAGES = {
    "minutiae_match": ["sim", "sums", "norm+extract", "bisect", "ranks",
                       "slots"],
    "texture_match": ["load", "bisect", "ranks", "slots"],
    "minu_screen": ["stage", "epilogue", "dots"],
    "minu_screen_norm": ["stage", "epilogue", "dots", "sums", "normalize"],
    "minu_screen_norm_tc": ["stage", "s", "sums", "normalize", "final"],
}
# kernel -> the stamp reader of its source (READERS)
READER_OF = {"minutiae_match": "stage_minu", "texture_match": "stage_tex",
             "minu_screen": "stage_screen",
             "minu_screen_norm": "stage_norm",
             "minu_screen_norm_tc": "stage_norm"}
FILTER_STAGES = ["H1", "power1", "greedy1", "compact", "H2", "power2",
                 "greedy2", "total"]
FILTER_SLOT0 = 8                 # filter stages take slots 8 .. 15

STAMP_CUH = r"""#pragma once
// stage clocks (stage_clocks.py): per block, cycles accumulated per slot
#include <cuda_runtime.h>
#define NSLOT %(nslot)d
#define MAXB %(maxb)d
static __device__ long long g_st[MAXB * NSLOT];
static __device__ long long g_prev[MAXB];
__device__ __forceinline__ long long stamp_gtimer() {
  long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP_BEGIN() do { __syncthreads(); \
  if (threadIdx.x == 0 && blockIdx.x < MAXB) { \
    g_prev[blockIdx.x] = clock64(); \
    if (g_st[blockIdx.x * NSLOT + 28] == 0) \
      g_st[blockIdx.x * NSLOT + 28] = stamp_gtimer(); } } while (0)
#define STAMP(i) do { __syncthreads(); \
  if (threadIdx.x == 0 && blockIdx.x < MAXB) { \
    const long long t_ = clock64(); \
    g_st[blockIdx.x * NSLOT + (i)] += t_ - g_prev[blockIdx.x]; \
    g_prev[blockIdx.x] = t_; \
    g_st[blockIdx.x * NSLOT + 29] = stamp_gtimer(); } } while (0)
#define WSTAMP(i) do { __syncwarp(); \
  if (threadIdx.x == 0 && blockIdx.x < MAXB) { \
    const long long t_ = clock64(); \
    g_st[blockIdx.x * NSLOT + (i)] += t_ - g_prev[blockIdx.x]; \
    g_prev[blockIdx.x] = t_; \
    g_st[blockIdx.x * NSLOT + 29] = stamp_gtimer(); } } while (0)
#define STAMP_READER(name) \
  extern "C" int name##_read(long long* out) { \
    return (int)cudaMemcpyFromSymbol(out, g_st, sizeof(g_st)); } \
  extern "C" int name##_reset() { \
    static long long z[MAXB * NSLOT]; \
    return (int)cudaMemcpyToSymbol(g_st, z, sizeof(g_st)); }
""" % dict(nslot=NSLOT, maxb=MAXB)


def _st(stage: str) -> str:
    return f"STAMP({FILTER_SLOT0 + FILTER_STAGES.index(stage)});"


# (file, anchor, text before it, text after it); every anchor occurs
# exactly once in its file
PATCHES = [
    ("texture_match.cu", "  const size_t row = (size_t)pair * Lt;\n",
     "  STAMP_BEGIN();\n", ""),
    ("texture_match.cu", "  float lo = fmaxf(mn - 1.f, SENT), hi = mx + 1.f;\n",
     "  STAMP(0);\n", ""),
    ("texture_match.cu", "  const int n_hi = block_scan_count(Lt",
     "  STAMP(1);\n", ""),
    ("texture_match.cu", "  for (int k = threadIdx.x; k < K; k += blockDim.x) "
     "{\n    f.val[k] = 0.f; f.li[k] = 0;", "  STAMP(2);\n", ""),
    ("texture_match.cu", "  const float score = filter_run(", "  STAMP(3);\n",
     ""),
    ("minutiae_match.cu", "    const float* rv = rvalid + (size_t)b * R;\n",
     "", "    STAMP_BEGIN();\n"),
    ("minutiae_match.cu", "    // ---- 2. sums", "    STAMP(0);\n", ""),
    ("minutiae_match.cu", "    auto normalized = [&]", "    STAMP(1);\n",
     ""),
    ("minutiae_match.cu", "    // ---- 4. the bisect", "    STAMP(2);\n",
     ""),
    ("minutiae_match.cu", "    bisect_window(kth, lo, hi);\n", "",
     "    STAMP(3);\n"),
    ("minutiae_match.cu", "      rank_tie[i] = rank;\n    }\n"
     "    __syncthreads();\n", "", "    STAMP(4);\n"),
    ("minutiae_match.cu", "    const float score = filter_run(",
     "    STAMP(5);\n", ""),
    ("filter_body.cuh", "#include <stdint.h>\n", "", '#include "stamp.cuh"\n'),
    ("filter_body.cuh", "  build_h1(f, lookup);\n", "",
     f"  {_st('H1')}\n"),
    ("filter_body.cuh", "  power_iter(f, K, dist_iters, [&](int i) "
     "{ return h1_row_dot(f, i, f.b); });\n", "", f"  {_st('power1')}\n"),
    ("filter_body.cuh", "    return f.li[i] == f.li[j] || f.ri[i] == "
     "f.ri[j] || h < 1e-5f;\n  });\n", "", f"  {_st('greedy1')}\n"),
    ("filter_body.cuh", "    f.b[m] = b2;\n  }\n  __syncthreads();\n", "",
     f"  {_st('compact')}\n"),
    ("filter_body.cuh", "  if (stages == 4)\n", f"  {_st('H2')}\n", ""),
    ("filter_body.cuh", "  if (stages == 5) return seq_total(f, nc, "
     "[&](int m) { return f.b[m]; });\n", f"  {_st('power2')}\n", ""),
    ("filter_body.cuh", "        || !bit_of(f.h2 + a * W2, b);\n  });\n",
     "", f"  {_st('greedy2')}\n"),
    ("minu_body.cuh", "#include <stdint.h>\n", "", '#include "stamp.cuh"\n'),
    ("minu_body.cuh", "  if (pl.pieces == 1) stage_templates(0);\n", "",
     "  STAMP_BEGIN();\n"),
    ("minu_body.cuh", "    convert(k, st);\n    __syncthreads();\n", "",
     "    STAMP(0);\n"),
    ("minu_body.cuh", "      if (folds(prev)) epilogue(k - 1, prev, warp);\n"
     "    }\n", "", "    STAMP(1);\n"),
    ("minu_body.cuh", "      continue;\n    }\n    // whether every division",
     "      STAMP(2);\n", ""),
    ("minu_body.cuh", "      const int nrow = tg * st.rows, ncol = tg * "
     "st.nc;\n", "      STAMP(2);\n", ""),
    ("minu_body.cuh", "      if (two_pass) continue;\n", "      STAMP(3);\n",
     ""),
    ("minu_body.cuh", "  }\n  __syncthreads();\n  if (warp < tg) {\n    const"
     " Stage last", "    STAMP(4);\n", ""),
    ("minu_screen_norm.cu", "  int b = blockIdx.x;\n  if (b < B) fetch(b);\n",
     "", "  STAMP_BEGIN();\n"),
    ("minu_screen_norm.cu", "    if (b + (int)gridDim.x < B) fetch(b + "
     "gridDim.x);\n", "    STAMP(0);\n", ""),
    ("minu_screen_norm.cu", "    // row sums (rows lane + 32 q",
     "    WSTAMP(1);\n", ""),
    ("minu_screen_norm.cu", "    // normalize in place, two rows at a time",
     "    WSTAMP(2);\n", ""),
    ("minu_screen_norm.cu", "    // the column maxima over row 0 of sw",
     "    WSTAMP(3);\n", ""),
    ("minu_screen_norm.cu", "    if (lane == 0) out[(size_t)t * B + b] = "
     "fminf(v, cols_side);\n", "", "    WSTAMP(4);\n"),
]
READERS = {"minutiae_match.cu": "stage_minu", "texture_match.cu": "stage_tex",
           "minu_screen.cu": "stage_screen",
           "minu_screen_norm.cu": "stage_norm"}
TOTAL = ("  return seq_total(f, nc, [&](int m) {\n"
         "    return bit_of(f.sel, m) ? f.val[f.cidx[m]] : 0.f; });\n}")


def instrument(src: Path, dst: Path) -> None:
    """Copy the sources in ``src`` to ``dst`` with the stage stamps. Raises
    when an anchor is missing or repeated."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    (dst / "stamp.cuh").write_text(STAMP_CUH)
    texts = {n: (dst / n).read_text()
             for n in ("filter_body.cuh", "minutiae_match.cu",
                       "texture_match.cu", "minu_body.cuh",
                       "minu_screen.cu", "minu_screen_norm.cu")}
    for name, anchor, before, after in PATCHES:
        s = texts[name]
        if s.count(anchor) != 1:
            raise RuntimeError(f"{name}: anchor found {s.count(anchor)} "
                               f"times: {anchor!r}")
        texts[name] = s.replace(anchor, before + anchor + after)
    if texts["filter_body.cuh"].count(TOTAL) != 1:
        raise RuntimeError("filter_body.cuh: no final total")
    texts["filter_body.cuh"] = texts["filter_body.cuh"].replace(TOTAL, (
        "  const float total_ = seq_total(f, nc, [&](int m) {\n"
        "    return bit_of(f.sel, m) ? f.val[f.cidx[m]] : 0.f; });\n"
        f"  {_st('total')}\n  return total_;\n}}"))
    for name, reader in READERS.items():
        texts[name] += f"\nSTAMP_READER({reader})\n"
    for name, s in texts.items():
        (dst / name).write_text(s)


def cuda_ms(fn, reps: int = 10) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def clocks(lib, kernel: str, fn, label: str, blocks, emit) -> dict:
    """One launch of ``fn`` stamped, its slots read back and summarized
    (``blocks`` None: every block that stamped its start)."""
    import numpy as np
    import torch
    ms = cuda_ms(fn)
    reader = READER_OF[kernel]
    read, reset = getattr(lib, reader + "_read"), getattr(lib, reader + "_reset")
    read.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_longlong * (MAXB * NSLOT))()
    torch.cuda.synchronize()
    if reset() != 0:
        raise RuntimeError("stamp reset failed")
    fn()
    torch.cuda.synchronize()
    if read(ctypes.addressof(buf)) != 0:
        raise RuntimeError("stamp read failed")
    a = np.frombuffer(buf, dtype=np.int64).reshape(MAXB, NSLOT)
    a = a[:blocks] if blocks is not None else a[a[:, 28] != 0]
    blocks = len(a)
    wall = (a[:, 29] - a[:, 28]) / 1e3
    names = STAGES[kernel]
    if kernel in ("minutiae_match", "texture_match"):
        names = names + [""] * (FILTER_SLOT0 - len(names)) + FILTER_STAGES
    st = a[:, :len(names)].astype(np.float64)
    slow = int(np.argmax(st.sum(1)))
    rec = {"label": label, "ms": round(ms, 4), "blocks": blocks,
           "block_us": [round(float(wall.min()), 1),
                        round(float(wall.mean()), 1),
                        round(float(wall.max()), 1)],
           "cycles": {"block0": int(st[0].sum()),
                      "mean": int(st.sum(1).mean()),
                      "max": int(st.sum(1).max())},
           "stages": {n: [int(st[0, i]), int(st[:, i].mean()),
                          int(st[slow, i])]
                      for i, n in enumerate(names) if n}}
    emit(json.dumps(rec))
    return rec


def make_latents(rng, n: int, cb, Lm: int, Lt: int, Rm: int, Rt: int):
    """n packed latents and their packed mates at one shape."""
    from msu_latentafis_tpu_torch.templates import pack_gallery, pack_latent
    from msu_latentafis_tpu_torch.utils.synthetic import (
        make_latent_template, make_rolled_template)
    lats = [make_latent_template(rng, n_minu=Lm, n_tex=Lt) for _ in range(n)]
    mates = [make_rolled_template(rng, n_minu=Rm, n_tex=Rt, mated_latent=l,
                                  codebook=cb) for l in lats]
    return ([pack_latent(l, minu_cap=Lm, tex_cap=Lt, quantize_tex_xy=False)
             for l in lats],
            pack_gallery(mates, cb, names=[f"mate{i}" for i in range(n)],
                         minu_cap=Rm, tex_cap=Rt))


def run(emit=print):
    from unittest import mock
    from msu_latentafis_tpu_torch.matcher.kernels import _build
    work = _build.BUILD_DIR / "stage_clocks"
    instrument(_build.CSRC, work / "csrc")
    # ops loads the stamped copy for the run, the port's library after it
    _build.load.cache_clear()
    try:
        with mock.patch.multiple(_build, CSRC=work / "csrc", BUILD_DIR=work):
            _run(_build.load(), emit)
    finally:
        _build.load.cache_clear()


def _run(lib, emit):
    import numpy as np
    import torch
    from msu_latentafis_tpu_torch.matcher.engine import MatchEngine
    from msu_latentafis_tpu_torch.matcher.kernels import ops
    from msu_latentafis_tpu_torch.utils.synthetic import (
        device_synthetic_gallery, plant_gallery_entries, random_codebook)
    from msu_latentafis_tpu_torch.utils.timing import card_line
    emit(json.dumps({"card": card_line()}))
    rng = np.random.default_rng(20261017)
    cb = random_codebook(rng)
    e = MatchEngine(cb, block_size=64, device="cuda")
    for shape, Lm, Lt, Rm, Rt in (("448", 64, 448, 96, 448),
                                  ("cap", 128, 1000, 128, 1000),
                                  ("R 1000", 128, 448, 1000, 448)):
        gal = device_synthetic_gallery(e, 1024, n_minu=Rm, n_tex=Rt, seed=2)
        lats, mates = make_latents(rng, 4, cb, Lm, Lt, Rm, Rt)
        plant_gallery_entries(gal, e, mates, [100, 300, 600, 900])
        lat = e.latent_batch(lats)
        blocks = [("rerank 1x64 (a mate's block)",
                   e.latent_side({k: v[:1] for k, v in lat.items()}, gal), 64)]
        if shape == "448":
            L = e.latent_side(lat, gal)
            blocks = [("dense 4x64", L, 0), ("dense 4x64 (a mate's block)",
                                            L, 64)] + blocks
        for what, L, a in blocks:
            minu, adc, tex = e.block_args(L, gal, a)
            NT, P, D = minu["ldes"].shape
            B, R, _ = minu["rdes"].shape
            words = lib.afis_minutiae_match_workspace(P, R, D, 120, 8)
            n = NT * B if words == 0 else min(NT * B, lib.afis_minutiae_match_blocks(
                P, R, D, 120, 8, 0, 0))
            clocks(lib, "minutiae_match", lambda: ops.minutiae_match(**minu),
                   f"minutiae_match {shape} {what}", n, emit)
            if shape == "R 1000":
                continue
            best, bestj = ops.adc_rowmax(**adc)
            clocks(lib, "texture_match",
                   lambda: ops.texture_match(best, bestj, **tex),
                   f"texture_match {shape} {what}",
                   best.shape[0] * best.shape[1], emit)
        del gal
        torch.cuda.empty_cache()
    # the minutiae screens at a serving chunk (8 templates x 16,384
    # entries, P 64, R 96, D 96)
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    NT, P, B, R, D = 8, 64, 16384, 96, 96
    ld = torch.nn.functional.normalize(
        torch.randn(NT, P, D, device="cuda", generator=g), dim=-1)
    rd = torch.nn.functional.normalize(
        torch.randn(B, R, D, device="cuda", generator=g), dim=-1)
    lv = (torch.rand(NT, P, device="cuda", generator=g) > 0.1).float()
    rv = (torch.rand(B, R, device="cuda", generator=g) > 0.1).float()
    for kernel, fn, dt in (
            ("minu_screen", ops.minu_screen, torch.float32),
            ("minu_screen_norm", ops.minu_screen_norm, torch.float32),
            ("minu_screen_norm_tc", ops.minu_screen_norm, torch.bfloat16)):
        a, b = ld.to(dt), rd.to(dt)
        clocks(lib, kernel, lambda: fn(a, lv, b, rv),
               f"{kernel} serving chunk {NT}x{B} (P {P}, R {R})", None, emit)


def main():
    import torch
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    if not torch.cuda.is_available():
        print("stage_clocks: no CUDA device", file=sys.stderr)
        return 2
    run(lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
