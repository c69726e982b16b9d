#!/usr/bin/env python
"""The two gallery loaders at a deployment's gallery size.

    python -m msu_latentafis_tpu_torch.scripts.loader_bench [--files N]
        [--distinct D] [--seed S]

Writes N rolled ``.dat`` files (default 100,000, the serving benchmark's
gallery) into a temporary directory: D distinct synthetic prints (default
1,024; 20-96 minutiae, 100-448 texture minutiae, as the smoke's second
loader directory), each copied byte for byte to fill the N names. Then,
on the host that runs it:

- the native loader's first-use build (``g++`` into an empty temporary
  build directory, not the one the port loads from), in seconds;
- ``pack_gallery_native`` over the directory, then the Python packer
  (``read_final_template`` per file and ``pack_gallery``), each once, the
  files in the page cache for both;
- whether the two give the same arrays (every field, bit for bit).

Prints one JSON line: {"files", "distinct", "bytes", "build_s",
"native_s", "python_s", "speedup", "equal", "cpus", "cpu"}. Exits 1 when
the arrays differ, 2 when the loader cannot be built.
"""
import argparse
import glob
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

FIELDS = ("minu_des", "minu_xy", "minu_ori", "minu_n", "tex_codes",
          "tex_sqnorm", "tex_xy", "tex_ori", "tex_n")


def write_gallery(gdir: str, n: int, distinct: int, rng) -> int:
    """n files in gdir, ``distinct`` of them written from synthetic prints
    and the rest copies; returns the bytes written."""
    from msu_latentafis_tpu_torch.templates import \
        write_final_rolled_pq_template
    from msu_latentafis_tpu_torch.utils.synthetic import make_rolled_template
    total = 0
    for j in range(n):
        path = os.path.join(gdir, f"g{j:06d}.dat")
        if j < distinct:
            r = make_rolled_template(rng, n_minu=int(rng.integers(20, 97)),
                                     n_tex=int(rng.integers(100, 449)))
            for tt in r.texture_template:      # writers quantize (x-24)/16
                m = np.asarray(tt.minutiae, np.float64)
                m[:, :2] = m[:, :2] * 16.0 + 24.0
                tt.minutiae = m
            write_final_rolled_pq_template(path, r)
        else:
            shutil.copyfile(os.path.join(gdir, f"g{j % distinct:06d}.dat"),
                            path)
        total += os.path.getsize(path)
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--files", type=int, default=100_000)
    ap.add_argument("--distinct", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    from msu_latentafis_tpu_torch.templates import (native_io, pack_gallery,
                                                    read_final_template)
    from msu_latentafis_tpu_torch.utils.synthetic import random_codebook
    rng = np.random.default_rng(args.seed)
    codebook = random_codebook(rng)
    with tempfile.TemporaryDirectory() as tmp:
        gdir = os.path.join(tmp, "gallery")
        os.makedirs(gdir)
        nbytes = write_gallery(gdir, args.files,
                               min(args.distinct, args.files), rng)
        # the first use on a new host: an empty build directory
        build_dir = native_io.BUILD_DIR
        native_io.BUILD_DIR = Path(tmp) / "build"
        native_io.load.cache_clear()
        try:
            t0 = time.perf_counter()
            lib = native_io.load()
            build_s = time.perf_counter() - t0
            if lib is None:
                print("loader_bench: the native loader cannot be built here",
                      file=sys.stderr)
                return 2
            t0 = time.perf_counter()
            nat = native_io.pack_gallery_native(gdir, codebook)
            native_s = time.perf_counter() - t0
        finally:
            native_io.BUILD_DIR = build_dir
            native_io.load.cache_clear()
        t0 = time.perf_counter()
        files = sorted(glob.glob(os.path.join(gdir, "*.dat")))
        py = pack_gallery([read_final_template(f, kind="rolled")
                           for f in files], codebook,
                          names=[Path(f).stem for f in files])
        python_s = time.perf_counter() - t0
    equal = nat.names == py.names and all(
        getattr(nat, k).dtype == getattr(py, k).dtype
        and np.array_equal(getattr(nat, k), getattr(py, k)) for k in FIELDS)
    print(json.dumps({
        "files": args.files, "distinct": min(args.distinct, args.files),
        "bytes": nbytes, "build_s": build_s, "native_s": native_s,
        "python_s": python_s, "speedup": python_s / native_s,
        "equal": equal, "cpus": len(os.sched_getaffinity(0)),
        "cpu": native_io.cpu_model()}))
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
