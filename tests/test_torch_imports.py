"""The port stands alone: no JAX (nor Flax or Orbax), nothing of the JAX
package, no Triton and no kernel build at import time; no matplotlib
either (``show`` imports it when it draws)."""
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
sys.modules["flax"] = None
sys.modules["orbax"] = None
sys.modules["msu_latentafis_tpu"] = None
sys.modules["matplotlib"] = None   # the card's machine has none
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
             "scripts.microbench_h1_probe", "matcher.reference_impl",
             "templates.native_io", "utils.timing", "utils.logging",
             "scripts.loader_bench", "scripts.h1_phases",
             "templates.legacy_codec", "ops.pq", "models.compnet",
             "pipeline.models_bundle", "pipeline.postprocess",
             "parallel.manifest", "parallel.mesh", "parallel.distributed",
             "parallel.sharding", "models.weights", "models.enhancement",
             "models.minutiae_net", "models.descriptor_net", "ops.gaussian",
             "ops.contrast", "ops.fft", "ops.morphology", "ops.maps",
             "ops.minutiae", "ops.patches", "pipeline.latent",
             "pipeline.rolled", "utils.image_io", "utils.precision",
             "ops.gabor", "scripts.bench_extraction", "ops.cylinder",
             "models.batchnorm", "models.zoo", "training", "training.trainer",
             "training.losses", "training.augment", "training.synthetic_data",
             "training.markup", "training.datasets", "training.checkpoints",
             "training.pretrain", "evaluate", "evaluate.verification",
             "evaluate.search", "evaluate.pairs", "evaluate.classification",
             "show", "scripts.gen_descriptor_pool", "scripts.measure",
             "scripts.rank_parity_100k", "scripts.rank_parity_structured",
             "scripts.profile_rerank", "scripts.profile_match",
             "scripts.bench_ladder"):
    assert "msu_latentafis_tpu_torch." + name in sys.modules, name
from msu_latentafis_tpu_torch.config import AfisConfig
from msu_latentafis_tpu_torch.pipeline import RolledFeatureExtractor
from msu_latentafis_tpu_torch.utils.synthetic import (
    random_bundle_variables, render_ridge_image, write_bundle_npz)
import tempfile
with tempfile.TemporaryDirectory() as d:
    paths = write_bundle_npz(d, random_bundle_variables(
        1, nf_enh=4, nf_minu=8, widths=(8, 8, 8, 8)))
    ext = RolledFeatureExtractor(config=AfisConfig(**paths), device="cpu")
t = ext.extract(render_ridge_image(rng, 160, 176)[0])
assert len(t.minu_template[0].minutiae) > 0 and len(t.texture_template) == 1
assert set(ext.timings) == {"cropping", "minutiae", "descriptors", "texture"}
from msu_latentafis_tpu_torch.pipeline import LatentFeatureExtractor
from msu_latentafis_tpu_torch.utils.synthetic import (PassThroughEnhancement,
                                                      latent_image)
lat = LatentFeatureExtractor(models=ext.models)
lat.models.enhancement = PassThroughEnhancement()
t = lat.extract(latent_image(rng, np.round(render_ridge_image(
    rng, 256, 288)[0]).astype(np.uint8), 224, 256))
assert len(t.minu_template) == 28 and lat.diag["mask_frac"] > 0
assert "cartoon" in lat.timings and "gabor_x2" in lat.timings
from msu_latentafis_tpu_torch.models.compnet import CompNet
from msu_latentafis_tpu_torch.ops.pq import pq_encode
from msu_latentafis_tpu_torch.pipeline import ModelBundle
des = ModelBundle(CompNet(), device="cpu").compress(
    rng.standard_normal((5, 192)).astype(np.float32))
assert des.shape == (5, 96) and pq_encode(des, cb, device="cpu").shape == (5, 16)
from msu_latentafis_tpu_torch.utils.logging import score_stats
from msu_latentafis_tpu_torch.utils.timing import PhaseTimer
timer = PhaseTimer()
with timer.phase("list_to_list"):
    res = engine.list_to_list(packed, engine.load_gallery(mates))
assert float(res[0].scores[0]) == score
assert score_stats(res[0].scores)["n"] == 1 and "list_to_list" in timer.pretty()
import torch
from msu_latentafis_tpu_torch.config import load_config
assert load_config(None).ComputeDtype == "float32"
bf = MatchEngine(cb, block_size=1, compute_dtype=torch.bfloat16,
                 tex_int8=True, minu_int8=True, device="cpu")
q = float(bf.match_scores(packed[0], bf.load_gallery(mates))[0])
assert abs(q - score) < 0.05 * score, (q, score)
from msu_latentafis_tpu_torch.training import (create_train_state,
                                               l2_train_step)
from msu_latentafis_tpu_torch.training.pretrain import config_paths
comp = CompNet()
st = create_train_state(comp)
x = torch.as_tensor(rng.standard_normal((8, 192)), dtype=torch.float32)
_, loss = l2_train_step(st, x, torch.zeros(8, 96))
assert st.step == 1 and float(loss) > 0 and not comp.training
assert set(config_paths("w")) >= {"EnhancementModel", "DescriptorModelPatch2"}
assert "triton" not in sys.modules
assert not any(k.startswith(("jax", "flax", "orbax", "matplotlib"))
               for k, v in sys.modules.items() if v)
print("OK", score)
'''


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")


def _sources():
    files = [p for p in PORT.rglob("*") if p.suffix in (".py", ".cu", ".cuh")]
    assert len(files) > 10
    return files


def test_no_jax_package_imports():
    imp = re.compile(r"^\s*(import|from)\s+(jax|flax|orbax|msu_latentafis_tpu)\b",
                     re.M)
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
