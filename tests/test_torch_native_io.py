"""The port's native C++ gallery loader (templates/native_io.py) against the
port's Python packer, on the CPU.

The library is built with g++ at first use into templates/_build/ (git
ignores it), keyed by the source, the flags and the host CPU's model; it
packs the same arrays as ``pack_gallery`` bit for bit, empty and truncated
files as empty entries (the files of tests/test_native_io.py:15-70).
"""
import json
import subprocess
from pathlib import Path

import numpy as np
import pytest

from msu_latentafis_tpu_torch.templates import (
    pack_gallery, read_final_template, write_final_rolled_pq_template)
from msu_latentafis_tpu_torch.templates import native_io
from msu_latentafis_tpu_torch.utils.synthetic import (make_rolled_template,
                                                      random_codebook)

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("minu_des", "minu_xy", "minu_ori", "minu_n", "tex_codes",
          "tex_sqnorm", "tex_xy", "tex_ori", "tex_n")


def _write(tmp_path, rng, sizes):
    for i, (nm, nt) in enumerate(sizes):
        t = make_rolled_template(rng, n_minu=nm, n_tex=nt)
        t.texture_template[0].minutiae[:, :2] = \
            t.texture_template[0].minutiae[:, :2] * 16 + 24
        write_final_rolled_pq_template(str(tmp_path / f"r{i:03d}.dat"), t)


def _python(tmp_path, codebook, **caps):
    files = sorted(tmp_path.glob("*.dat"))
    templates = [read_final_template(str(f), kind="rolled") for f in files]
    return pack_gallery(templates, codebook, names=[f.stem for f in files],
                        **caps)


def _assert_same(native, py):
    for k in FIELDS:
        a, b = getattr(native, k), getattr(py, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert native.names == py.names


@pytest.fixture(scope="module")
def built():
    if not native_io.native_available():
        pytest.skip("g++ cannot build the loader here")
    return native_io.library_path()


def test_native_loader_matches_python(built, rng, tmp_path):
    codebook = random_codebook(rng)
    _write(tmp_path, rng, [(20 + i, 30 + 2 * i) for i in range(8)])
    (tmp_path / "r900.dat").write_bytes(b"")                 # empty
    data = (tmp_path / "r000.dat").read_bytes()
    (tmp_path / "r901.dat").write_bytes(data[:40])           # truncated
    caps = dict(minu_cap=32, tex_cap=48)
    native = native_io.pack_gallery_native(str(tmp_path), codebook,
                                           des_dim=96, **caps)
    py = _python(tmp_path, codebook, des_dim=96, **caps)
    _assert_same(native, py)
    assert native.minu_n[-2:].tolist() == [0, 0]
    assert native.tex_n[-2:].tolist() == [0, 0]


def test_native_loader_autosizes_caps(built, rng, tmp_path):
    """Without caps the count scan sizes the arrays as the adaptive Python
    packer does; caps below a template's count cut it as the packer does."""
    codebook = random_codebook(rng)
    _write(tmp_path, rng, [(9, 30), (21, 55), (14, 41)])
    native = native_io.pack_gallery_native(str(tmp_path), codebook)
    py = _python(tmp_path, codebook)
    assert native.minu_des.shape == (3, 24, 96)
    assert native.tex_codes.shape == (3, 56, 16)
    _assert_same(native, py)
    caps = dict(minu_cap=16, tex_cap=40)
    _assert_same(native_io.pack_gallery_native(str(tmp_path), codebook,
                                               **caps),
                 _python(tmp_path, codebook, **caps))


def test_native_loader_empty_directory(built, rng, tmp_path):
    codebook = random_codebook(rng)
    g = native_io.pack_gallery_native(str(tmp_path), codebook)
    assert g.size == 0 and g.names == []


def test_library_is_built_for_this_host(built, monkeypatch):
    """Built under templates/_build/ (ignored by git), never the tracked
    tools/libtemplate_io.so; another CPU model, or the same model name
    with other features, means another library."""
    assert built.parent == native_io.BUILD_DIR
    assert built.exists() and built.name.startswith("libtemplate_io_")
    assert native_io.load()._name == str(built)
    assert "tools" not in built.parts
    ignored = subprocess.run(["git", "check-ignore", "-q", str(built)],
                             cwd=ROOT)
    assert ignored.returncode == 0
    monkeypatch.setattr(native_io, "cpu_flags", lambda: "fpu sse2")
    assert native_io.library_path() != built
    monkeypatch.setattr(native_io, "cpu_model", lambda: "another CPU")
    assert native_io.library_path() != built
    assert native_io.SOURCE.read_bytes().startswith(
        b"// Native template I/O")


def test_no_loader_returns_none(monkeypatch, rng, tmp_path):
    """Where the library cannot be built, pack_gallery_native returns None
    (the CLI then reads with the Python packer)."""
    monkeypatch.setattr(native_io, "build", lambda: None)
    native_io.load.cache_clear()
    try:
        assert native_io.pack_gallery_native(str(tmp_path),
                                             random_codebook(rng)) is None
        assert not native_io.native_available()
    finally:
        native_io.load.cache_clear()


def test_loader_bench_builds_afresh_and_compares(built, capsys):
    """scripts/loader_bench.py at a small size: a first-use build in a
    directory of its own (the port's build directory is left as it was),
    both loaders over copied files, the same arrays."""
    from msu_latentafis_tpu_torch.scripts import loader_bench
    build_dir = native_io.BUILD_DIR
    assert loader_bench.main(["--files", "40", "--distinct", "8"]) == 0
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rec["equal"] and rec["files"] == 40 and rec["distinct"] == 8
    assert rec["build_s"] > 0 and rec["native_s"] > 0 and rec["bytes"] > 0
    assert native_io.BUILD_DIR == build_dir and built.exists()
