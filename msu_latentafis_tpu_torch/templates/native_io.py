"""The native (C++/OpenMP) gallery loader, through ctypes.

``csrc/template_io.cpp`` parses every final rolled ``.dat`` of a gallery
directory in parallel and packs the fields straight into the
``PackedGallery`` arrays: the host-side loading path for large galleries
(the reference reads them inside its matcher's OpenMP gallery loop,
matcher.cpp:886-983). The port's own copy of the JAX package's
``templates/native_io.py``, with two differences:

- the library is built at first use with ``g++ -O3 -march=native
  -fopenmp -shared -fPIC`` into ``_build/`` beside this module (listed in
  ``.gitignore``), keyed by a hash of the source, the flags and the host
  CPU's model name and feature flags: a library built for one host's CPU
  is never loaded on another's. The build writes a temporary name and
  renames it into place; no tracked library is ever loaded;
- the texture squared norms: the library gathers each valid row's
  per-subspace terms (``pq_sqnorm_terms``) and NumPy sums them over the
  subspaces as ``pack_gallery`` does, in chunks of SQNORM_CHUNK
  entries, so the two loaders give the same arrays bit for bit.

``pack_gallery_native`` returns None when the library cannot be built (no
compiler): the caller then reads the gallery with the Python packer, as
the JAX CLI does.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from .packing import PackedGallery, codeword_sqnorm

SOURCE = Path(__file__).resolve().parent / "csrc" / "template_io.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]
BUILD_TIMEOUT_S = 300
SQNORM_CHUNK = 4096      # entries per pass of the texture squared norms


def _cpuinfo(key: str) -> str:
    """The first ``key`` line of /proc/cpuinfo, '' where there is none."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.split(":", 1)[0].strip() == key:
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return ""


def cpu_model() -> str:
    """The host CPU's model name."""
    return _cpuinfo("model name") or \
        f"{platform.machine()} {platform.processor()}"


def cpu_flags() -> str:
    """The host CPU's feature flags: what ``-march=native`` compiles for
    (virtual machines often share one generic model name)."""
    return _cpuinfo("flags")


def library_path() -> Path:
    """Where the library for this source, these flags and this CPU (model
    and features) lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(cpu_model().encode())
    h.update(cpu_flags().encode())
    return BUILD_DIR / f"libtemplate_io_{h.hexdigest()[:16]}.so"


def build() -> Optional[Path]:
    """Compile the loader unless this host's library exists; None when it
    cannot be built (no g++, or the compile fails)."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp.so"
    try:
        run = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True,
                             timeout=BUILD_TIMEOUT_S)
        if run.returncode != 0:
            return None
        os.replace(tmp, out)
    except (OSError, subprocess.TimeoutExpired):
        return None
    finally:
        tmp.unlink(missing_ok=True)
    return out


@functools.lru_cache(maxsize=1)
def load() -> Optional[ctypes.CDLL]:
    """Build (once per source, flags and CPU) and load the library."""
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.pack_gallery_files.argtypes = [ctypes.c_char_p] + [I] * 5 + [P] * 10
    lib.pack_gallery_files.restype = I
    lib.scan_gallery_counts.argtypes = [ctypes.c_char_p, I, P, P]
    lib.scan_gallery_counts.restype = I
    lib.pq_sqnorm_terms.argtypes = [P, P, ctypes.c_int64, I, I, I, P, P]
    lib.pq_sqnorm_terms.restype = None
    return lib


def native_available() -> bool:
    return load() is not None


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def pack_gallery_native(gallery_dir: str, codebook: np.ndarray,
                        minu_cap: Optional[int] = None,
                        tex_cap: Optional[int] = None,
                        des_dim: int = 96) -> Optional[PackedGallery]:
    """Parse and pack every rolled ``.dat`` under ``gallery_dir`` with the
    native loader (sorted by path, as the Python reader lists them);
    None when the library is unavailable.

    Without caps a parallel count-only scan sizes them to the gallery's
    largest template 0 (rounded up to 8), as ``pack_gallery`` sizes its
    arrays. Empty and truncated files pack as empty entries."""
    lib = load()
    if lib is None:
        return None
    files = sorted(glob.glob(os.path.join(gallery_dir, "*.dat")))
    n = len(files)
    n_subs = codebook.shape[0]
    joined = "\n".join(files).encode()
    if n and (minu_cap is None or tex_cap is None):
        scan_m = np.zeros((n,), np.int32)
        scan_t = np.zeros((n,), np.int32)
        lib.scan_gallery_counts(joined, n, _ptr(scan_m), _ptr(scan_t))
        rup = lambda v: int(-(-max(int(v), 1) // 8) * 8)
        minu_cap = minu_cap or rup(scan_m.max())
        tex_cap = tex_cap or rup(scan_t.max())
    minu_cap, tex_cap = minu_cap or 8, tex_cap or 8

    minu_des = np.zeros((n, minu_cap, des_dim), np.float32)
    minu_x, minu_y, minu_ori = (np.zeros((n, minu_cap), np.float32)
                                for _ in range(3))
    minu_n = np.zeros((n,), np.int32)
    codes = np.zeros((n, tex_cap, n_subs), np.uint8)
    tex_x, tex_y, tex_ori = (np.zeros((n, tex_cap), np.float32)
                             for _ in range(3))
    tex_n = np.zeros((n,), np.int32)
    if n:
        lib.pack_gallery_files(
            joined, n, minu_cap, tex_cap, des_dim, n_subs, _ptr(minu_des),
            _ptr(minu_x), _ptr(minu_y), _ptr(minu_ori), _ptr(minu_n),
            _ptr(codes), _ptr(tex_x), _ptr(tex_y), _ptr(tex_ori),
            _ptr(tex_n))
    tex_sqnorm = np.zeros((n, tex_cap), np.float32)
    cw_sqnorm = np.ascontiguousarray(codeword_sqnorm(codebook))
    terms = np.empty((min(n, SQNORM_CHUNK), tex_cap, n_subs), np.float32)
    for a in range(0, n, SQNORM_CHUNK):
        m = min(SQNORM_CHUNK, n - a)
        lib.pq_sqnorm_terms(_ptr(codes[a:]), _ptr(tex_n[a:]), m, tex_cap,
                            n_subs, cw_sqnorm.shape[1], _ptr(cw_sqnorm),
                            _ptr(terms))
        # the Python packer's sum over the subspaces (pack_gallery)
        tex_sqnorm[a:a + m] = terms[:m].sum(axis=-1)
    return PackedGallery(
        minu_des=minu_des, minu_xy=np.stack([minu_x, minu_y], axis=-1),
        minu_ori=minu_ori, minu_n=minu_n, tex_codes=codes,
        tex_sqnorm=tex_sqnorm,
        tex_xy=np.stack([tex_x, tex_y], axis=-1), tex_ori=tex_ori,
        tex_n=tex_n,
        names=[os.path.splitext(os.path.basename(f))[0] for f in files])
