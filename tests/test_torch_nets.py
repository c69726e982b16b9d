"""The port's nets and their weights against the JAX package's Flax modules
on the CPU: each net fed the same variables (``*_from_flax``), the Flax
layouts (SAME padding at odd and even sizes, ConvTranspose, the ResBlock
naming), the ``.npz`` weight files, and the stand-in checkpoints restored
through the JAX package's ``ModelBundle.initialize``.

Tolerance: a net's outputs agree within ``K * 2^-24 * max|out|`` with K the
longest dot product of the net (kh * kw * c_in): the first-order bound of
one f32 sum of K terms, reordered (XLA's CPU convolutions and PyTorch's sum
in other orders), relative to the output's scale."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import flax.linen as fnn

from msu_latentafis_tpu import models as jmod
from msu_latentafis_tpu.config import AfisConfig as JaxConfig
from msu_latentafis_tpu.models.descriptor_net import ResBlock as FlaxResBlock
from msu_latentafis_tpu.pipeline.models_bundle import ModelBundle as JaxBundle
from msu_latentafis_tpu_torch.config import AfisConfig
from msu_latentafis_tpu_torch.models import weights
from msu_latentafis_tpu_torch.models.compnet import CompNet
from msu_latentafis_tpu_torch.models.descriptor_net import (
    DescriptorNet, ResBlock, descriptor_from_flax)
from msu_latentafis_tpu_torch.models.enhancement import (
    EnhancementAEC, SameConv2d, deconv, enhance_whole_image,
    enhancement_from_flax)
from msu_latentafis_tpu_torch.models.minutiae_net import (
    MinutiaeAEC, MinutiaeAEC64, MinutiaeUNet, minutiae_from_flax)
from msu_latentafis_tpu_torch.pipeline import ModelBundle
from msu_latentafis_tpu_torch.utils.synthetic import (
    MINUTIAE_GAINS, random_flax_variables)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch on one intra-op thread: the suite's workers share the host's
    cores, and an intra-op pool in each spins waiting on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STANDIN = os.path.join(ROOT, "checkpoints", "standin")
U = 2.0 ** -24


def jx(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def run_port(net, x_nhwc: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        out = net(torch.as_tensor(x_nhwc).permute(0, 3, 1, 2))
    return out.permute(0, 2, 3, 1).numpy() if out.dim() == 4 else out.numpy()


def assert_close(got, want, K: int):
    """Within the reordered f32 sum's bound of the output's scale."""
    assert got.shape == want.shape
    tol = K * U * max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


# (name, port net, Flax module, input NHWC, longest dot K)
NETS = [
    ("enhancement_nf4", EnhancementAEC(4), jmod.EnhancementAEC(nf=4),
     (1, 64, 96, 1), 16 * 32),
    ("minutiae_aec_nf4", MinutiaeAEC(4), jmod.MinutiaeAEC(nf=4),
     (1, 128, 64, 1), 16 * 32),
    ("minutiae64_nf8", MinutiaeAEC64(8), jmod.MinutiaeAEC64(nf=8),
     (2, 48, 80, 1), 16 * 64),
    ("minutiae_unet_nf4", MinutiaeUNet(4), jmod.MinutiaeUNet(nf=4),
     (1, 128, 64, 1), 16 * 64),
    ("descriptor_narrow", DescriptorNet(64, (8, 16, 16, 32)),
     jmod.DescriptorNet(widths=(8, 16, 16, 32)), (3, 96, 96, 1), 9 * 32),
    ("descriptor_odd", DescriptorNet(64, (8, 16, 16, 32)),
     jmod.DescriptorNet(widths=(8, 16, 16, 32)), (2, 45, 51, 1), 9 * 32),
    # the full widths, on tiny inputs
    ("enhancement_full", EnhancementAEC(), jmod.EnhancementAEC(),
     (1, 32, 64, 1), 16 * 128),
    ("minutiae_aec_full", MinutiaeAEC(), jmod.MinutiaeAEC(),
     (1, 64, 64, 1), 16 * 512),
    ("minutiae64_full", MinutiaeAEC64(), jmod.MinutiaeAEC64(),
     (1, 32, 48, 1), 16 * 512),
    ("descriptor_full", DescriptorNet(), jmod.DescriptorNet(),
     (2, 96, 96, 1), 9 * 256),
]


@pytest.mark.parametrize("case", NETS, ids=[c[0] for c in NETS])
def test_net_matches_flax(case):
    """The port's net holding seeded Flax variables (non-identity batch
    statistics) == the Flax module applied to them; the variables come
    back out of the port unchanged."""
    name, net, flax_mod, shape, K = case
    tree = random_flax_variables(net, 7, MINUTIAE_GAINS)
    x = np.random.default_rng(1).uniform(-1, 1, shape).astype(np.float32)
    want = np.asarray(flax_mod.apply(jx(tree), jnp.asarray(x), train=False))
    conv = {EnhancementAEC: enhancement_from_flax,
            DescriptorNet: descriptor_from_flax,
            MinutiaeAEC: minutiae_from_flax,
            MinutiaeAEC64: lambda v: minutiae_from_flax(v, MinutiaeAEC64),
            MinutiaeUNet: lambda v: minutiae_from_flax(v, MinutiaeUNet)}
    port = conv[type(net)](tree)
    assert type(port) is type(net) and not port.training
    assert_close(run_port(port, x), want, K)
    back, flat = weights.flatten(weights.to_flax(port)), weights.flatten(tree)
    assert sorted(back) == sorted(flat)
    assert all(np.array_equal(back[k], flat[k]) for k in flat)


@pytest.mark.parametrize("size", [(7, 8), (1, 2)])
@pytest.mark.parametrize("kernel,stride", [(3, 2), (4, 2), (3, 1), (1, 2)])
def test_same_padding_matches_flax(size, kernel, stride):
    """Flax "SAME" pads (lo, hi) with hi = lo + 1 where the total is odd:
    SameConv2d pads explicitly, at odd and even sizes."""
    x = np.random.default_rng(2).standard_normal((1, *size, 3)) \
        .astype(np.float32)
    mod = fnn.Conv(5, (kernel, kernel), strides=(stride, stride))
    v = jax.tree_util.tree_map(np.asarray, mod.init(jax.random.PRNGKey(0),
                                                    jnp.asarray(x)))
    want = np.asarray(mod.apply(jx(v), jnp.asarray(x)))
    conv = SameConv2d(3, 5, kernel, stride)
    conv.flax_modules = lambda: {"m": conv}
    weights.load_flax(conv, {"params": {"m": v["params"]}})
    assert_close(run_port(conv, x), want, kernel * kernel * 3)


@pytest.mark.parametrize("size", [(5, 6), (6, 5), (1, 1), (8, 8)])
def test_conv_transpose_matches_flax(size):
    """Flax's 4x4 stride-2 "SAME" ConvTranspose (transpose_kernel=False)
    == ConvTranspose2d(k 4, s 2, padding 1) with the kernel flipped."""
    x = np.random.default_rng(3).standard_normal((2, *size, 3)) \
        .astype(np.float32)
    mod = fnn.ConvTranspose(4, (4, 4), strides=(2, 2))
    v = jax.tree_util.tree_map(np.asarray, mod.init(jax.random.PRNGKey(1),
                                                    jnp.asarray(x)))
    want = np.asarray(mod.apply(jx(v), jnp.asarray(x)))
    dc = deconv(3, 4)
    dc.flax_modules = lambda: {"m": dc}
    weights.load_flax(dc, {"params": {"m": v["params"]}})
    got = run_port(dc, x)
    assert got.shape == (2, 2 * size[0], 2 * size[1], 4)
    assert_close(got, want, 16 * 3)


@pytest.mark.parametrize("cin,features,stride,shortcut",
                         [(16, 16, 1, False), (8, 16, 1, True),
                          (16, 16, 2, True)])
def test_resblock_naming(cin, features, stride, shortcut):
    """A ResBlock's shortcut conv, where it exists, is Flax's Conv_0 and
    the 3x3 convs follow; without one the 3x3 convs are Conv_0, Conv_1."""
    x = np.random.default_rng(4).standard_normal((2, 12, 12, cin)) \
        .astype(np.float32)
    mod = FlaxResBlock(features, stride=stride)
    v = jax.tree_util.tree_map(np.asarray, mod.init(
        jax.random.PRNGKey(2), jnp.asarray(x), train=False))
    names = sorted(k for k in v["params"] if k.startswith("Conv"))
    assert names == ([f"Conv_{i}" for i in range(3 if shortcut else 2)])
    block = ResBlock(cin, features, stride)
    assert (block.shortcut is not None) == shortcut
    block.flax_modules = lambda f=block.flax_modules: f("m")
    tree = random_flax_variables(block, 5)
    assert sorted(k for k in tree["params"]["m"] if k.startswith("Conv")) \
        == names
    assert tree["params"]["m"]["Conv_0"]["kernel"].shape[:2] == \
        ((1, 1) if shortcut else (3, 3))
    want = np.asarray(mod.apply({k: t["m"] for k, t in jx(tree).items()},
                                jnp.asarray(x), train=False))
    weights.load_flax(block, tree)
    assert_close(run_port(block, x), want, 9 * features)


def test_from_flax_rejects_missing_and_extra_leaves():
    tree = random_flax_variables(DescriptorNet(64, (8, 8, 8, 8)), 1)
    extra = weights.flatten(tree)
    extra["params/ResBlock_9/Conv_0/kernel"] = np.zeros((1, 1, 1, 1))
    with pytest.raises(ValueError, match="ResBlock_9"):
        descriptor_from_flax(weights.unflatten(extra))
    missing = weights.flatten(tree)
    del missing["batch_stats/ResBlock_3/BatchNorm_1/var"]
    with pytest.raises(RuntimeError, match="ResBlock_3/BatchNorm_1/var"):
        descriptor_from_flax(weights.unflatten(missing))
    wrong = weights.flatten(tree)
    wrong["params/Dense_0/kernel"] = np.zeros((8, 32), np.float32)
    with pytest.raises(ValueError, match="shape"):
        descriptor_from_flax(weights.unflatten(wrong))


def test_npz_weights_and_initialize(tmp_path):
    """save_npz / load_npz round trip; an empty model path gives the seeded
    init (equal for equal seeds); a given path that cannot be read raises;
    initialize reads the widths from the file."""
    tree = random_flax_variables(MinutiaeAEC64(8), 3)
    path = str(tmp_path / "m64.npz")
    weights.save_npz(path, tree)
    back = weights.flatten(weights.load_npz(path))
    assert all(np.array_equal(back[k], v)
               for k, v in weights.flatten(tree).items())
    a = ModelBundle.initialize(AfisConfig(), device="cpu", seed=4)
    b = ModelBundle.initialize(None, device="cpu", seed=4)
    for na, nb in zip(a.minutiae + a.descriptors, b.minutiae + b.descriptors):
        for pa, pb in zip(na.state_dict().values(),
                          nb.state_dict().values()):
            assert torch.equal(pa, pb)
    cfg = AfisConfig(MinutiaeExtractionModelRolled=path)
    m = ModelBundle.initialize(cfg, device="cpu").minutiae[2]
    assert isinstance(m, MinutiaeAEC64) and m.out.in_channels == 8
    for bad in (str(tmp_path / "absent.npz"), str(tmp_path)):
        with pytest.raises(FileNotFoundError):
            ModelBundle.initialize(AfisConfig(EnhancementModel=bad),
                                   device="cpu")
    corrupt = tmp_path / "corrupt.npz"
    corrupt.write_bytes(b"PK\x03\x04 not a zip")
    with pytest.raises(Exception):
        ModelBundle.initialize(AfisConfig(DescriptorModelPatch8=str(corrupt)),
                               device="cpu")


def test_enhance_and_tiled_inference_match_jax():
    """enhance_whole_image (x / 128 - 1, pad to 32, min-max rescale),
    enhance_tiled and detect_minutiae_tiled (128-px tiles at stride 64,
    Gaussian blending) on a 200 x 230 image, both packages, the same
    variables. The rescale divides the net's error (K u, outputs in
    [-1, 1]) by the output's range r: within 3 K u 255 / r."""
    from msu_latentafis_tpu.models import enhancement as je
    from msu_latentafis_tpu.models import minutiae_net as jm
    from msu_latentafis_tpu_torch.models.enhancement import enhance_tiled
    from msu_latentafis_tpu_torch.models.minutiae_net import \
        detect_minutiae_tiled
    tree = random_flax_variables(EnhancementAEC(4), 8)
    img = np.random.default_rng(5).uniform(0, 255, (200, 230)) \
        .astype(np.float32)
    mod = jmod.EnhancementAEC(nf=4)
    apply = lambda v, x: mod.apply(v, x, train=False)  # noqa: E731
    net = enhancement_from_flax(tree)
    with torch.no_grad():
        raw = net(torch.as_tensor(img / 128.0 - 1.0)[None, None])
    K = 16 * 32
    tol = 3 * K * U * 255 / float(raw.max() - raw.min())
    got = enhance_whole_image(net, img).numpy()
    np.testing.assert_allclose(got, np.asarray(je.enhance_whole_image(
        apply, jx(tree), img)), rtol=0, atol=tol)
    got = enhance_tiled(net, img)
    want = je.enhance_tiled(apply, jx(tree), img)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * 4)  # 4 tiles
    mtree = random_flax_variables(MinutiaeAEC(4), 9, MINUTIAE_GAINS)
    mmod = jmod.MinutiaeAEC(nf=4)
    got = detect_minutiae_tiled(minutiae_from_flax(mtree), img, 0.2)
    want = jm.detect_minutiae_tiled(
        lambda v, x: mmod.apply(v, x, train=False), jx(mtree), img, 0.2)
    assert len(got) > 0
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:, 2:], want[:, 2:], rtol=0,
                               atol=64 * U * 2 * np.pi)


# ---------------------------------------------------------------------------
# the stand-in checkpoints, restored by the JAX package's Orbax reader
# ---------------------------------------------------------------------------

STANDIN_PATHS = {
    "EnhancementModel": "enhancement",
    "MinutiaeExtractionModelLatentSTFT": "minutiae_stft",
    "MinutiaeExtractionModel": "minutiae",
    "MinutiaeExtractionModelRolled": "minutiae64",
    "DescriptorModelPatch2": "descriptor_patch2",
    "DescriptorModelPatch8": "descriptor_patch8",
    "DescriptorModelPatch11": "descriptor_patch11",
    "DimensionalityReductionModel": "compnet",
}


def convert_standins(jax_bundle, out_dir) -> dict:
    """The README's recipe: each net of a JAX ModelBundle (restored from
    the stand-ins) as an .npz the port reads; -> {config field: path}."""
    trees = {
        "EnhancementModel": jax_bundle.enhancement_vars,
        "MinutiaeExtractionModelLatentSTFT": jax_bundle.minutiae_vars[0],
        "MinutiaeExtractionModel": jax_bundle.minutiae_vars[1],
        "MinutiaeExtractionModelRolled": jax_bundle.minutiae_vars[2],
        "DimensionalityReductionModel": jax_bundle.compnet_vars}
    for pt, v in zip(jax_bundle.patch_types, jax_bundle.descriptor_vars):
        trees[f"DescriptorModelPatch{pt}"] = v
    paths = {}
    for key, tree in trees.items():
        paths[key] = os.path.join(out_dir, key + ".npz")
        weights.save_npz(paths[key], jax.tree_util.tree_map(np.asarray, tree))
    return paths


@pytest.fixture(scope="module")
def standins(tmp_path_factory):
    if not os.path.isdir(STANDIN):
        pytest.skip("checkpoints/standin is absent from this checkout")
    cfg = JaxConfig(**{k: os.path.join(STANDIN, d)
                       for k, d in STANDIN_PATHS.items()})
    jb = JaxBundle.initialize(cfg)
    paths = convert_standins(jb, str(tmp_path_factory.mktemp("standin_npz")))
    return jb, ModelBundle.initialize(AfisConfig(**paths), device="cpu")


def test_standin_nets_and_compress_match_jax(standins):
    """Every stand-in net (trained weights and batch statistics), converted
    to .npz and read by the port's initialize, == the JAX package's net on
    the same input; compress too."""
    jb, pb = standins
    var = np.asarray(jb.descriptor_vars[0]["batch_stats"]["BatchNorm_0"]
                     ["var"])
    assert not np.allclose(var, 1.0), "the checkpoint did not restore"
    rng = np.random.default_rng(6)
    img = rng.uniform(-1, 1, (1, 64, 64, 1)).astype(np.float32)
    assert_close(run_port(pb.enhancement, img),
                 np.asarray(jb._enh_apply(jb.enhancement_vars, img)), 16 * 128)
    for i in range(3):
        x = img if i < 2 else img[:, :32, :48]
        assert_close(run_port(pb.minutiae[i], x),
                     np.asarray(jb._minu_apply[i](jb.minutiae_vars[i], x)),
                     16 * 512)
    patch = rng.uniform(-1, 1, (2, 96, 96, 1)).astype(np.float32)
    for k in range(3):
        assert_close(run_port(pb.descriptors[k], patch),
                     np.asarray(jb._des_apply[k](jb.descriptor_vars[k],
                                                 patch)), 9 * 256)
    des = rng.standard_normal((50, 192)).astype(np.float32)
    np.testing.assert_allclose(pb.compress(des), jb.compress(des),
                               rtol=1e-5, atol=1e-5)
    assert isinstance(pb.compnet, CompNet)
