"""The port stands alone: no JAX, nothing of the JAX package, no Triton and
no kernel build at import time."""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "msu_latentafis_tpu_torch"

_NO_JAX = r'''
import sys
sys.modules["jax"] = None          # any "import jax" now raises ImportError
sys.modules["msu_latentafis_tpu"] = None
import importlib, pkgutil
import numpy as np
import msu_latentafis_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
from msu_latentafis_tpu_torch.matcher.engine import MatchEngine
from msu_latentafis_tpu_torch.utils.synthetic import random_codebook
rng = np.random.default_rng(0)
cb = random_codebook(rng)
packed, mates = chip_smoke.make_latents(rng, 1, cb)
engine = MatchEngine(cb, block_size=1, device="cpu")
score = float(engine.match_scores(packed[0], engine.load_gallery(mates))[0])
assert score > 50.0, score
for name in ("config", "scripts.exp_screen_mfu",
             "scripts.microbench_h1_probe"):
    assert "msu_latentafis_tpu_torch." + name in sys.modules, name
import torch
from msu_latentafis_tpu_torch.config import load_config
assert load_config(None).ComputeDtype == "float32"
bf = MatchEngine(cb, block_size=1, compute_dtype=torch.bfloat16,
                 tex_int8=True, minu_int8=True, device="cpu")
q = float(bf.match_scores(packed[0], bf.load_gallery(mates))[0])
assert abs(q - score) < 0.05 * score, (q, score)
assert "triton" not in sys.modules
assert not any(k.startswith("jax") for k, v in sys.modules.items() if v)
print("OK", score)
'''


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")


def _sources():
    files = [p for p in PORT.rglob("*") if p.suffix in (".py", ".cu", ".cuh")]
    assert len(files) > 10
    return files


def test_no_jax_package_imports():
    imp = re.compile(r"^\s*(import|from)\s+(jax|msu_latentafis_tpu)\b", re.M)
    for f in _sources() + [ROOT / "chip_smoke.py"]:
        text = f.read_text()
        assert not imp.search(text), f
    for f in _sources():            # not even named inside the port
        assert not re.search(r"\bmsu_latentafis_tpu\b", f.read_text()), f


def test_kernels_build_only_with_nvcc():
    """nvcc over csrc/*.cu (one compile per source, one link); no PyTorch
    extension builder."""
    text = "\n".join(f.read_text() for f in _sources())
    for banned in (r"cpp_extension\s*(\.|import)", r"import\s+[\w.]*cpp_extension",
                   r"#include\s*[<\"]torch/", r"torch\.compile\(",
                   r"^\s*(import|from)\s+triton"):
        assert not re.search(banned, text, re.M), banned
    from msu_latentafis_tpu_torch.matcher.kernels import _build
    assert "arch=compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert {s.name for s in _build.sources()} == {
        "adc_rowmax.cu", "adc_screen.cu", "adc_screen_codes.cu",
        "minu_screen.cu",
        "minu_screen_norm.cu", "texture_match.cu", "minutiae_match.cu",
        "graph_filter.cu", "graph_filter_infuse.cu", "screen_t.cu",
        "h1_probe.cu", "legality_canary.cu"}
    assert _build.library_path().parent == _build.BUILD_DIR
