#!/usr/bin/env python
"""Where the H1 probe kernel's time goes, phase by phase.

    python -m msu_latentafis_tpu_torch.scripts.h1_phases

Builds copies of ``csrc/h1_probe.cu`` into the ignored build directory
with phases cut out, and times each, bcast and gram, at the probe's
shape (NP 4096 sets of K 200, the script's inputs, the plan the port
launches): ``full``; ``no_fold`` (thread 0 folds no rows); ``no_sums``
(no row or column sums, no fold); ``no_terms`` (each tile stores
constants in place of its four terms; sums and fold kept); ``walk_only``
(no terms, sums or fold: the loads, the compaction and the tiles' walk
and stores). The differences give each phase's share of a launch. A cut
copy's outputs are not the probe's; the copies are never the library the
port loads. One JSON line per copy: {"copy", "bcast_ms", "gram_ms",
"card"}. Each cut wraps an anchor, a line of the source that occurs once
(tests/test_torch_scripts.py checks that every anchor is found).
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

# cut -> (anchor, its replacement)
CUTS = {
    "NO_TERMS": ("    S[p] = tile_terms<kGram, kFast>(q, R, C, r25);",
                 "#ifdef NO_TERMS\n    S[p] = make_float4(R, C, 0.f, 1.f);"
                 "\n#else\n    S[p] = tile_terms<kGram, kFast>(q, R, C, "
                 "r25);\n#endif"),
    "NO_SUMS": ("    for (int t = tid; t < (r1 - r0) + (n - r1); "
                "t += kThreads) {",
                "#ifdef NO_SUMS\n    if (0)\n#endif\n"
                "    for (int t = tid; t < (r1 - r0) + (n - r1); "
                "t += kThreads) {"),
    "NO_FOLD": ("    if (tid == 0) {                  // r0 is even, acc "
                "8-byte aligned",
                "#ifndef NO_FOLD\n    if (tid == 0) {\n#else\n"
                "    if (tid < 0) {\n#endif"),
}
COPIES = {"full": [], "no_fold": ["NO_FOLD"],
          "no_sums": ["NO_SUMS", "NO_FOLD"], "no_terms": ["NO_TERMS"],
          "walk_only": ["NO_TERMS", "NO_SUMS", "NO_FOLD"]}


def instrument(src: str) -> str:
    """The probe's source with every cut behind its macro."""
    for name, (anchor, repl) in CUTS.items():
        if src.count(anchor) != 1:
            raise RuntimeError(f"h1_phases: anchor of {name} not found once")
        src = src.replace(anchor, repl)
    return src


def build(out_dir: Path) -> dict:
    """nvcc of each copy (the port's flags) -> {copy: library path}."""
    from msu_latentafis_tpu_torch.matcher.kernels import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "h1_probe_cut.cu"
    cu.write_text(instrument((_build.CSRC / "h1_probe.cu").read_text()))
    libs = {}
    for name, macros in COPIES.items():
        so = out_dir / f"h1_{name}.so"
        run = subprocess.run(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared",
             *(f"-D{m}" for m in macros), "-o", str(so), str(cu)],
            capture_output=True, text=True, timeout=_build.BUILD_TIMEOUT_S)
        if run.returncode != 0:
            raise RuntimeError(f"nvcc ({name}) failed:\n{run.stderr}")
        libs[name] = so
    return libs


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("h1_phases: no CUDA device", file=sys.stderr)
        return 2
    from msu_latentafis_tpu_torch.matcher.kernels import _build, ops
    from msu_latentafis_tpu_torch.scripts import microbench_h1_probe as h1p
    from msu_latentafis_tpu_torch.scripts.microbench_body_stages import \
        cuda_ms
    from msu_latentafis_tpu_torch.utils.timing import card_line
    card = card_line()
    p = h1p.make_inputs(np.random.default_rng(0), "cuda")
    NP, K = p["lx"].shape
    plan = ops.h1_probe_plan(K, p["lx"].device.index)
    out = torch.empty((NP,), dtype=torch.float32, device="cuda")
    ptrs = [t.data_ptr() for t in (p["lx"], p["ly"], p["rx"], p["ry"],
                                   p["vf"], out)]
    stream = torch.cuda.current_stream().cuda_stream
    for name, so in build(_build.BUILD_DIR / "h1_phases").items():
        lib = ctypes.CDLL(str(so))
        lib.afis_h1_probe.argtypes = _build.SIGNATURES["afis_h1_probe"]
        row = {"copy": name}
        for v in ("bcast", "gram"):
            def launch(v=v):
                _build.check(lib.afis_h1_probe(
                    *ptrs, NP, K, ops.H1_VARIANTS.index(v), plan["budget"],
                    plan["smem_bytes"], stream), "h1_phases")
            row[f"{v}_ms"] = round(cuda_ms(launch, 20), 4)
        row["card"] = card
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
