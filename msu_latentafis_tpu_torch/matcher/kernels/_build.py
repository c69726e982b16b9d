"""Build and load the matcher's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc -c`` process, all started
together, so the build takes as long as the slowest source; one more
``nvcc`` links the objects into a shared library with a plain C
interface, loaded with ``ctypes``. No PyTorch headers, no ``ninja`` and
no ``torch.utils.cpp_extension``: a source that includes
``torch/extension.h`` takes minutes to compile, these take seconds.

The library is cached under ``_build/`` (listed in ``.gitignore``) by a
hash of the sources and the flags. A build writes to temporary names and
renames the library into place, so an interrupted build leaves no lock or
half-written library behind. ``--fmad=false`` keeps every product and sum
a separate rounding, as in the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC"]
BUILD_TIMEOUT_S = 180

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# C function name -> argument types; every launcher returns cudaError_t.
# Launchers of typed kernels take each operand's type code (ops.DTYPE_CODE)
# after the sizes.
SIGNATURES = {
    "afis_adc_rowmax": [_P] * 9 + [_I] * 7 + [_P],
    "afis_adc_rowmax_codes": [_P] * 10 + [_I] * 8 + [_P],
    "afis_adc_rowmax_body": [_I] * 9,
    "afis_adc_rowmax_counts": [_P, _I],
    "afis_adc_screen": [_P] * 7 + [_I] * 5 + [_F] + [_I] * 2 + [_P],
    "afis_adc_screen_codes": [_P] * 8 + [_I] * 7 + [_F, _I, _P],
    "afis_minu_screen": [_P] * 5 + [_I] * 7 + [_P],
    "afis_minu_screen_norm": [_P] * 5 + [_I] * 7 + [_P],
    "afis_texture_match": [_P] * 6 + [_I] * 7 + [_P],
    "afis_minutiae_match": [_P] * 8 + [_I] * 12 + [_P],
    "afis_minutiae_match_workspace": [_I] * 5,
    "afis_minutiae_match_blocks": [_I] * 7,
    "afis_graph_filter_packed": [_P] * 7 + [_I] * 6 + [_P],
    "afis_graph_filter_infuse": [_P] * 8 + [_I] * 7 + [_P],
    "afis_screen_t_bf16": [_P] * 3 + [_I] * 5 + [_P],
    "afis_screen_t_int8": [_P] * 4 + [_I] * 5 + [_P],
    "afis_screen_t_int8_plan": [_I],
    "afis_h1_probe": [_P] * 6 + [_I] * 3 + [_P],
    "afis_legality_canary": [_P] * 2 + [_L] + [_I] * 2 + [_P],
    "afis_max_smem_optin": [],
    "afis_error_string": [_I],
    "afis_error_name": [_I],
}
RESTYPES = {"afis_error_string": ctypes.c_char_p,
            "afis_error_name": ctypes.c_char_p,
            "afis_minutiae_match_workspace": ctypes.c_longlong}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return cand


def sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libafis_kernels_{h.hexdigest()[:16]}.so"


def _nvcc(*args: str) -> subprocess.CompletedProcess:
    """One nvcc process; a timeout kills it and raises."""
    try:
        return subprocess.run([nvcc_path(), *args], capture_output=True,
                              text=True, timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"nvcc timed out after {BUILD_TIMEOUT_S} s") from e


def build() -> Path:
    """Compile the kernels unless the cached library exists; returns it.
    The compilers' resource reports (``-Xptxas=-v``) go to ``<lib>.log``.
    Every process started here has ended when this returns or raises."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    srcs = sources()
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in srcs]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    try:
        with ThreadPoolExecutor(len(srcs)) as pool:
            runs = list(pool.map(
                lambda so: _nvcc(*NVCC_FLAGS, "-c", "-o", str(so[1]),
                                 str(so[0])), zip(srcs, objs)))
        out.with_suffix(".log").write_text("".join(
            f"== {s.name}\n{r.stdout}{r.stderr}" for s, r in zip(srcs, runs)))
        failed = [f"{s.name} ({r.returncode}):\n{r.stderr}"
                  for s, r in zip(srcs, runs) if r.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        link = _nvcc("-shared", "-o", str(tmp), *map(str, objs))
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stderr}")
        os.replace(tmp, out)
    finally:
        for f in objs + [tmp]:
            f.unlink(missing_ok=True)
    return out


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the library; declares every
    launcher's argument types so pointers are never cut to 32 bits."""
    lib = ctypes.CDLL(str(build()))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = RESTYPES.get(name, ctypes.c_int)
    return lib


def check(err: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error (a refused launch is
    never reported by a later synchronize); the message carries the
    error's name, e.g. cudaErrorInvalidValue."""
    if err != 0:
        lib = load()
        name = lib.afis_error_name(err).decode()
        msg = lib.afis_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} {name} ({msg})")
