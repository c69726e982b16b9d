"""The port's rolled extraction against the JAX package on the CPU: each
classical op fed the JAX op's own inputs, the minutiae decoders, the patch
gathers, ``describe_stack`` against ``describe_host``, the image files
against imageio and cv2, the ``RolledFeatureExtractor`` and the
``extract-rolled`` CLI end to end on small prints with the same (seeded,
narrow) weights.

Tolerances, from the sums: f32 filters of K taps whose weights sum to 1
agree within K u max|x| (u = 2^-24); the FFT low-pass against the JAX
package's DFT matmuls within 4 n u max|x| (four length-n passes), scaled by
the texture's 255 / 40; the nets as ``test_torch_nets`` states; the image
resize within 8 u 256 (two passes of a two-tap sum on [0, 255])."""
import os

import cv2
import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msu_latentafis_tpu import cli as jcli
from msu_latentafis_tpu import models as jmod
from msu_latentafis_tpu.config import AfisConfig as JaxConfig
from msu_latentafis_tpu.ops import contrast as jc
from msu_latentafis_tpu.ops import fft as jf
from msu_latentafis_tpu.ops import maps as jm
from msu_latentafis_tpu.ops import minutiae as jmi
from msu_latentafis_tpu.ops import morphology as jmo
from msu_latentafis_tpu.ops import patches as jp
from msu_latentafis_tpu.ops import gaussian as jg
from msu_latentafis_tpu.pipeline import models_bundle as jbundle
from msu_latentafis_tpu.pipeline import rolled as jrolled
from msu_latentafis_tpu.training.synthetic_data import \
    render_ridge_image as jax_render
from msu_latentafis_tpu_torch import cli
from msu_latentafis_tpu_torch.config import AfisConfig
from msu_latentafis_tpu_torch.ops import contrast as tc
from msu_latentafis_tpu_torch.ops import fft as tf
from msu_latentafis_tpu_torch.ops import gaussian as tg
from msu_latentafis_tpu_torch.ops import maps as tm
from msu_latentafis_tpu_torch.ops import minutiae as tmi
from msu_latentafis_tpu_torch.ops import morphology as tmo
from msu_latentafis_tpu_torch.ops import patches as tp
from msu_latentafis_tpu_torch.pipeline import (ModelBundle,
                                               RolledFeatureExtractor)
from msu_latentafis_tpu_torch.pipeline import rolled as trolled
from msu_latentafis_tpu_torch.templates import (read_final_template,
                                                write_codebook)
from msu_latentafis_tpu_torch.utils import image_io
from msu_latentafis_tpu_torch.utils.synthetic import (
    random_bundle_variables, random_codebook, render_ridge_image,
    write_bundle_npz)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch on one intra-op thread: the suite's workers share the host's
    cores, and an intra-op pool in each spins waiting on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _uncached_dft_mats(monkeypatch):
    """The JAX package's ``ops.fft._dft_mats`` is an lru_cache of arrays
    made while ``fast_cartoon_texture`` is traced: a second image shape with
    the same DFT size then reads the first trace's tracers and raises
    (UnexpectedTracerError). The same matrices, uncached, for these
    tests."""
    monkeypatch.setattr(jf, "_dft_mats", jf._dft_mats.__wrapped__)


U = 2.0 ** -24
NF, WIDTHS = 8, (8, 16, 16, 32)      # the nets' widths in these tests


def close(got, want, tol):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol, (err, tol)


@pytest.fixture(scope="module")
def print_img():
    return render_ridge_image(np.random.default_rng(0), 160, 208)[0] \
        .astype(np.float32)


def test_render_ridge_image_equals_jax():
    a, ta = render_ridge_image(np.random.default_rng(3), 100, 130)
    b, tb = jax_render(np.random.default_rng(3), 100, 130)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ta, tb)


# ---------------------------------------------------------------------------
# classical ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(160, 208), (5, 7)])
def test_gaussian_blurs_match_jax(print_img, shape):
    img = print_img[:shape[0], :shape[1]]
    t = torch.as_tensor(img)
    top = float(np.abs(img).max())
    close(tg.gaussian_blur_cv2(t, 21, 7.0), jg.gaussian_blur_cv2(img, 21, 7.0),
          21 * U * top * 2)
    close(tg.gaussian_blur_cv2(t, 5), jg.gaussian_blur_cv2(img, 5),
          5 * U * top * 2)
    close(tg.gaussian_blur_reflect(t, 2.0),
          jg.gaussian_blur_reflect(img, 2.0), 17 * U * top * 2)


def test_contrast_matches_jax(print_img):
    t = torch.as_tensor(print_img)
    # mean and deviation each within 15 u 255 per pass; the quotient's
    # slope 0.75 / (dev + 10) <= 0.075 by 127.5 of range
    tol = 4 * 15 * U * 255 * (1 + 0.075 * 127.5)
    close(tc.local_contrast_enhancement(t),
          jc.local_contrast_enhancement(print_img), tol)
    close(tc.local_contrast_enhancement_gaussian(t),
          jc.local_contrast_enhancement_gaussian(print_img), tol)


def test_cartoon_texture_matches_jax(print_img):
    n = 256
    close(tf.fast_cartoon_texture(torch.as_tensor(print_img)),
          jf.fast_cartoon_texture(print_img), 4 * n * U * 255 * 255 / 40)
    # the low-pass alone against its f64 spec (the JAX package's own
    # lowpass_filter caches traced DFT matrices and runs only inside the jit
    # of fast_cartoon_texture)
    L = np.random.default_rng(2).uniform(0, 1, (256, 256)).astype(np.float32)
    p = np.zeros((256, 256))
    p[:160, :208] = print_img
    spec = np.real(np.fft.ifft2(np.fft.fft2(p) * np.fft.ifftshift(L)))
    close(tf.lowpass_filter(torch.as_tensor(print_img), torch.as_tensor(L)),
          spec[:160, :208], 4 * n * U * 255)
    gj = jf.gradient_norm(jnp.asarray(print_img))
    close(tf.gradient_norm(torch.as_tensor(print_img)), gj, 4 * U * 255)


@pytest.mark.parametrize("shape,inclusive", [((160, 208), True),
                                             ((160, 208), False),
                                             ((150, 201), True)])
def test_extract_blocks_match_jax(print_img, shape, inclusive):
    img = print_img[:shape[0], :shape[1]]
    pj, bhj, bwj = jf.extract_blocks(jnp.asarray(img), 64, 16, inclusive)
    pt, bh, bw = tf.extract_blocks(torch.as_tensor(img), 64, 16, inclusive)
    assert (bh, bw) == (bhj, bwj)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))


def test_stft_maps_match_jax(print_img):
    """The histograms, the peak masks, the maps and the smoothing: the
    tables are shared, the FFT and the sums reorder (64 x 64 blocks)."""
    tex = np.asarray(jf.fast_cartoon_texture(print_img))
    padded = np.pad(tex, 24, mode="symmetric")
    sj = jm._stft_histograms(jnp.asarray(padded), 64, 16)
    st = tm._stft_histograms(torch.as_tensor(padded), 64, 16)
    close(st[0], sj[0], 64 * 64 * U)
    np.testing.assert_array_equal(st[1].numpy(), np.asarray(sj[1]))
    assert st[3:] == tuple(sj[3:])
    dj, fj = jm.get_maps_stft(tex)
    dt, ft = tm.get_maps_stft(torch.tensor(tex))
    close(ft, fj, 64 * 64 * U * float(np.abs(np.asarray(fj)).max()))
    close(dt, dj, 64 * 64 * U * np.pi)
    dm = np.random.default_rng(1).uniform(-3, 3, (10, 13)).astype(np.float32)
    mask = (np.random.default_rng(2).random((10, 13)) > 0.3)
    close(tm.smooth_dir_map(torch.as_tensor(dm), 2.0,
                            torch.as_tensor(mask)),
          jm.smooth_dir_map(jnp.asarray(dm), 2.0, jnp.asarray(mask)),
          17 * U * 2 * np.pi)


def test_intensity_mask_matches_jax(print_img):
    img = print_img.copy()
    img[:40, :60] = 128.0                       # a flat corner outside
    t = torch.as_tensor(img)
    close(tm._intensity_mask_core(t), jm._intensity_mask_core(jnp.asarray(img)),
          4 * 21 * U * 255 * 2)
    got = tm.get_quality_map_intensity(t)
    np.testing.assert_array_equal(got, jm.get_quality_map_intensity(img))
    assert got.dtype == np.uint8 and 0 < got.mean() < 1
    m = got[::8, ::8].astype(bool)
    for name in ("binary_dilation", "binary_erosion", "binary_opening",
                 "binary_closing"):
        se = np.ones((3, 3), bool)
        np.testing.assert_array_equal(getattr(tmo, name)(m, se),
                                      getattr(jmo, name)(m, se))
    np.testing.assert_array_equal(tmo.distance_transform_edt(got),
                                  jmo.distance_transform_edt(got))


# ---------------------------------------------------------------------------
# minutiae decoding
# ---------------------------------------------------------------------------

def planted_cylinder(seed: int, h=96, w=112):
    """A smooth random heatmap with peaks, equal confidences planted at
    two pixels (the tie order) and an exact plateau (no strict peak)."""
    rng = np.random.default_rng(seed)
    cyl = rng.uniform(0, 0.3, (h, w, 12)).astype(np.float32)
    cyl[40, 50] = cyl[60, 30] = np.linspace(0.1, 0.9, 12)[::-1]
    cyl[20, 20:22] = 0.95
    return cyl


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_cylinder_matches_jax(seed):
    cyl = planted_cylinder(seed)
    mj, nj = jmi.decode_cylinder(jnp.asarray(cyl), 0.2)
    mt, nt = tmi.decode_cylinder(torch.as_tensor(cyl), 0.2)
    assert nt == int(nj) > 3
    np.testing.assert_array_equal(mt[:nt, :2].numpy(),
                                  np.asarray(mj)[:nt, :2])
    close(mt[:nt, 2:], np.asarray(mj)[:nt, 2:], ORI_TOL)
    small, ns = tmi.decode_cylinder(torch.as_tensor(cyl), 0.2, 3)
    assert ns == 3 and torch.equal(small, mt[:3])
    for refine in (True, False):
        for crowd in (True, False):
            same_minutiae(
                tmi.decode_minutiae(torch.as_tensor(cyl), 0.2, refine=refine,
                                    crowd_filter=crowd, refine_dist_thr=10),
                jmi.decode_minutiae(cyl, 0.2, refine=refine,
                                    crowd_filter=crowd, refine_dist_thr=10))
    cyls = np.stack([cyl, planted_cylinder(seed + 5)])
    for a, b in zip(tmi.decode_minutiae_batch(torch.as_tensor(cyls),
                                              [0.2, 0.25]),
                    jmi.decode_minutiae_batch(cyls, [0.2, 0.25])):
        same_minutiae(a, b)


ORI_TOL = 64 * U * 2 * np.pi       # the interpolated orientation and conf


def same_minutiae(a, b):
    """Equal positions, in the same order; orientation and confidence
    within the few roundings of the quadratic interpolation."""
    np.testing.assert_array_equal(a[:, :2], b[:, :2])
    close(a[:, 2:], b[:, 2:], ORI_TOL)


def test_minutiae_filters_match_jax():
    rng = np.random.default_rng(7)
    m = np.column_stack([rng.uniform(0, 200, 80), rng.uniform(0, 150, 80),
                         rng.uniform(0, 2 * np.pi, 80), rng.random(80)])
    for d in (10, 20):
        np.testing.assert_array_equal(tmi.refine_minutiae(m, d),
                                      jmi.refine_minutiae(m, d))
    np.testing.assert_array_equal(tmi.remove_crowded_minutiae(m),
                                  jmi.remove_crowded_minutiae(m))
    mask = np.zeros((150, 200), np.uint8)
    mask[20:130, 30:180] = 1
    for r in (5, 10):
        np.testing.assert_array_equal(
            tmi.remove_spurious_minutiae(m, mask, r),
            jmi.remove_spurious_minutiae(m, mask, r))
    sets = [m[rng.permutation(80)[:50]] + rng.normal(0, 2, (50, 4))
            for _ in range(5)]
    for thr in (2, 3):
        np.testing.assert_array_equal(tmi.get_common_minutiae(sets, thr),
                                      jmi.get_common_minutiae(sets, thr))


# ---------------------------------------------------------------------------
# patches and descriptors
# ---------------------------------------------------------------------------

def test_patches_match_jax(print_img):
    rng = np.random.default_rng(8)
    m = np.column_stack([rng.uniform(-5, 215, 12), rng.uniform(-5, 165, 12),
                         rng.uniform(0, 2 * np.pi, 12), rng.random(12)])
    for a, b in zip(tp.get_patch_index(), jp.get_patch_index()):
        np.testing.assert_array_equal(a, b)
    for pt in (1, 2, 8, 11, 13):
        np.testing.assert_array_equal(tp.extract_patches(m, print_img, pt),
                                      jp.extract_patches(m, print_img, pt))
    x = rng.uniform(0, 255, (3, 80, 80)).astype(np.float32)
    np.testing.assert_array_equal(tp._bilinear_resize(x, 96),
                                  jp._bilinear_resize(x, 96))
    table = tp.device_patch_index_table((2, 8, 11), 464)
    np.testing.assert_array_equal(
        table.numpy(), np.asarray(jp.device_patch_index_table((2, 8, 11),
                                                              464)))
    with pytest.raises(ValueError):
        tp.device_patch_index_table((1,), 464)


@pytest.fixture(scope="module")
def trees():
    """Seeded narrow weights of every net, Flax layout."""
    return random_bundle_variables(11, nf_enh=4, nf_minu=NF, widths=WIDTHS)


def port_bundle(paths: dict, device="cpu") -> ModelBundle:
    return ModelBundle.initialize(AfisConfig(**paths), device=device)


def jax_bundle(trees: dict):
    """A JAX ModelBundle of the same narrow nets holding the same
    variables."""
    jx = lambda k: jax.tree_util.tree_map(jnp.asarray, trees[k])  # noqa
    pts = (2, 8, 11)
    return jbundle.ModelBundle(
        enhancement=jmod.EnhancementAEC(nf=4),
        enhancement_vars=jx("EnhancementModel"),
        minutiae=[jmod.MinutiaeAEC(nf=NF), jmod.MinutiaeAEC(nf=NF),
                  jmod.MinutiaeAEC64(nf=NF)],
        minutiae_vars=[jx("MinutiaeExtractionModelLatentSTFT"),
                       jx("MinutiaeExtractionModel"),
                       jx("MinutiaeExtractionModelRolled")],
        descriptors=[jmod.DescriptorNet(widths=WIDTHS) for _ in pts],
        descriptor_vars=[jx(f"DescriptorModelPatch{p}") for p in pts],
        patch_types=pts, compnet=jmod.CompNet(),
        compnet_vars=jx("DimensionalityReductionModel"))


@pytest.fixture(scope="module")
def bundles(trees, tmp_path_factory):
    paths = write_bundle_npz(str(tmp_path_factory.mktemp("npz")), trees)
    return paths, port_bundle(paths), jax_bundle(trees)


DES_TOL = 9 * 32 * U * 4      # unit embeddings, the narrow nets' K


def test_describe_stack_matches_host_and_jax(bundles, print_img):
    _, pb, jb = bundles
    rng = np.random.default_rng(9)
    n = 7
    m = np.column_stack([rng.uniform(0, 208, n), rng.uniform(0, 160, n),
                         rng.uniform(0, 2 * np.pi, n), rng.random(n)])
    img2 = np.asarray(tc.local_contrast_enhancement(torch.as_tensor(
        print_img)))
    got = pb.describe_stack(pb.prepare_image_stack([print_img, img2]), m)
    for i, im in enumerate((print_img, img2)):
        host = pb.describe_host(im, m)
        want = jb.describe_host(im, m)
        assert len(got[i]) == len(host) == 3
        for k in range(3):
            close(got[i][k], host[k], DES_TOL)
            close(got[i][k], want[k], DES_TOL)
            np.testing.assert_allclose(np.linalg.norm(got[i][k], axis=1), 1,
                                       rtol=1e-5)
    # outside the image the device path clips the minutia's own position
    # first (the host path only the sampled ones), in both packages
    out = np.array([[-3.5, 40, 1.0, 1], [215, 170, 4.0, 1]])
    stack = jb.prepare_image_stack([print_img])
    for a, b in zip(pb.describe(print_img, out),
                    jb.describe_stack(stack, out, batch_size=8)[0]):
        close(a, b, DES_TOL)
    assert pb.describe(print_img, m[:0]) == []
    resize = ModelBundle(pb.compnet, "cpu", descriptors=pb.descriptors,
                         patch_types=(1, 8, 13))
    stack = resize.prepare_image_stack([print_img])
    for a, b in zip(resize.describe_stack(stack, m)[0],
                    resize.describe_host(print_img, m)):
        np.testing.assert_array_equal(a, b)


def test_detect_minutiae_matches_jax(bundles, print_img):
    _, pb, jb = bundles
    tex = tf.fast_cartoon_texture(torch.as_tensor(print_img))
    got = pb.detect_minutiae(2, tex, 0.15)
    want = jb.detect_minutiae(2, np.asarray(tex), 0.15)
    assert len(got) > 5
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    close(got[:, 2:], want[:, 2:], 16 * 64 * U * 16)
    for a, b in zip(pb.detect_minutiae_batch(2, [tex, tex], [0.15, 0.3]),
                    jb.detect_minutiae_batch(2, [np.asarray(tex)] * 2,
                                             [0.15, 0.3])):
        np.testing.assert_array_equal(a[:, :2], b[:, :2])


# ---------------------------------------------------------------------------
# image files
# ---------------------------------------------------------------------------

def test_image_files_match_imageio_and_cv2(tmp_path):
    rng = np.random.default_rng(10)
    grey = rng.integers(0, 256, (37, 53)).astype(np.uint8)
    image_io.write_bmp(str(tmp_path / "a.bmp"), grey)
    image_io.write_png(str(tmp_path / "a.png"), grey, filters=(0, 1, 2, 3, 4))
    files = {"a.bmp": grey, "a.png": grey}
    for name, arr in (("rgb.png", rng.integers(0, 256, (20, 31, 3))),
                      ("rgb.bmp", rng.integers(0, 256, (20, 31, 3))),
                      ("g.png", grey), ("g.bmp", grey),
                      ("g16.png", rng.integers(0, 65536, (10, 13))
                       .astype(np.uint16)),
                      ("rgba.png", rng.integers(0, 256, (9, 11, 4)))):
        arr = arr.astype(np.uint16 if arr.dtype == np.uint16 else np.uint8)
        imageio.imwrite(str(tmp_path / name), arr)
        files[name] = arr
    for name, arr in files.items():
        got = image_io.read_image(str(tmp_path / name))
        want = np.asarray(imageio.imread(str(tmp_path / name)))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(image_io.read_grey(str(tmp_path / "rgb.png")),
                                  files["rgb.png"] @ [0.299, 0.587, 0.114])
    x = rng.uniform(0, 255, (300, 257)).astype(np.float32)
    for f in (500 / 1200, 0.5, 1.7, 0.37):
        close(image_io.resize_linear(x, f, f),
              cv2.resize(x, (0, 0), fx=f, fy=f), 8 * U * 256)


# ---------------------------------------------------------------------------
# the extractor and the CLI
# ---------------------------------------------------------------------------

def compare_templates(a, b):
    """Port template a against the JAX template b: the minutiae equal in
    position, their orientation and confidence and the descriptors within
    the nets' bounds."""
    ma, mb = a.minu_template[0], b.minu_template[0]
    np.testing.assert_array_equal(ma.minutiae[:, :2], mb.minutiae[:, :2])
    close(ma.minutiae[:, 2:], mb.minutiae[:, 2:], 16 * 64 * U * 16)
    np.testing.assert_array_equal(ma.mask, mb.mask)
    close(ma.oimg, mb.oimg, 64 * 64 * U * np.pi)
    for x, y in zip(ma.des, mb.des):
        close(x, y, DES_TOL)
    assert len(a.texture_template) == len(b.texture_template) == 1
    ta, tb = a.texture_template[0], b.texture_template[0]
    close(ta.minutiae, tb.minutiae, 64 * 64 * U * np.pi)
    for x, y in zip(ta.des, tb.des):
        close(x, y, DES_TOL)


def test_rolled_extractor_matches_jax(bundles):
    _, pb, jb = bundles
    img = render_ridge_image(np.random.default_rng(4), 208, 224)[0]
    got = RolledFeatureExtractor(models=pb).extract(img)
    want = jrolled.RolledFeatureExtractor(models=jb).extract(img)
    assert len(got.minu_template[0].minutiae) > 3
    compare_templates(got, want)
    img_big = render_ridge_image(np.random.default_rng(5), 400, 420)[0]
    got = RolledFeatureExtractor(models=pb).extract(img_big, ppi=1000)
    want = jrolled.RolledFeatureExtractor(models=jb).extract(img_big,
                                                             ppi=1000)
    compare_templates(got, want)


@pytest.mark.parametrize("layout", ["flat", "longitudinal", "msp", "n2n"])
def test_enumerate_rolled_dataset_matches_jax(tmp_path, layout):
    for s in ("s1", "s2"):
        for f in range(10):
            for i in range(6 if f < 3 else 2):
                (tmp_path / s).mkdir(exist_ok=True)
                (tmp_path / s / f"i{i}_{f}.bmp").write_bytes(b"")
        (tmp_path / s / "x.png").write_bytes(b"")
    for i in (0, 2, 3):
        (tmp_path / f"{i}.bmp").write_bytes(b"")
    (tmp_path / "z.png").write_bytes(b"")
    for N1, N2 in ((0, 10), (1, 3)):
        got = list(trolled.enumerate_rolled_dataset(str(tmp_path), layout,
                                                    N1=N1, N2=N2))
        want = list(jrolled.enumerate_rolled_dataset(str(tmp_path), layout,
                                                     N1=N1, N2=N2))
        assert got == want and (got or N1 == 1)
    with pytest.raises(ValueError):
        list(trolled.enumerate_rolled_dataset(str(tmp_path), "nope"))


def test_extract_rolled_cli_matches_jax(bundles, trees, tmp_path,
                                        monkeypatch, capsys):
    """Both CLIs over the same directory (a BMP and a PNG print, a bad
    file) with the same weights and codebook: the same files; minutiae
    equal, descriptors within the nets' and the DR's bounds, PQ codes equal
    but where the two DR outputs' codes lie within their rounding bound of
    each other (none, on these prints). A second run skips every
    existing template."""
    paths, _, jb = bundles
    idir = tmp_path / "img"
    idir.mkdir()
    for i, (h, w) in enumerate(((192, 208), (176, 224))):
        img = render_ridge_image(np.random.default_rng(20 + i), h, w)[0]
        write = image_io.write_bmp if i == 0 else image_io.write_png
        write(str(idir / f"p{i}.{'bmp' if i == 0 else 'png'}"),
              np.round(img).astype(np.uint8))
    (idir / "broken.bmp").write_bytes(b"BM not an image")
    cb_path = str(tmp_path / "cb.dat")
    write_codebook(cb_path, random_codebook(np.random.default_rng(3)))
    monkeypatch.setattr(jbundle.ModelBundle, "initialize",
                        classmethod(lambda cls, cfg=None: jb))
    out = {}
    for who in ("port", "jax"):
        tdir = str(tmp_path / who)
        cfg_path = str(tmp_path / f"{who}.config")
        (AfisConfig(**paths, CodebookPath=cb_path) if who == "port"
         else JaxConfig(CodebookPath=cb_path)).save(cfg_path)
        args = ["extract-rolled", "--idir", str(idir), "--tdir", tdir,
                "--config", cfg_path]
        if who == "port":
            assert cli.main(args + ["--device", "cpu"]) == 0
        else:
            assert jcli.main(args) == 0
        printed = capsys.readouterr().out
        assert printed.count("extraction FAILED") == 1, printed
        out[who] = tdir
    names = sorted(os.listdir(out["jax"]))
    assert sorted(os.listdir(out["port"])) == names == ["p0.dat", "p1.dat"]
    for name in names:
        a, b = (read_final_template(os.path.join(out[w], name), "rolled")
                for w in ("port", "jax"))
        ma, mb = a.minu_template[0], b.minu_template[0]
        assert len(ma.minutiae) > 3
        same_minutiae(ma.minutiae, mb.minutiae)
        np.testing.assert_allclose(ma.des, mb.des, rtol=1e-5, atol=1e-5)
        ta, tb = a.texture_template[0], b.texture_template[0]
        np.testing.assert_array_equal(ta.minutiae[:, :2], tb.minutiae[:, :2])
        close(ta.minutiae[:, 2:], tb.minutiae[:, 2:], 64 * 64 * U * np.pi)
        np.testing.assert_array_equal(ta.des, tb.des)
    os.remove(idir / "broken.bmp")
    stamp = {n: os.path.getmtime(os.path.join(out["port"], n)) for n in names}
    assert cli.main(["extract-rolled", "--idir", str(idir), "--tdir",
                     out["port"], "--config", str(tmp_path / "port.config"),
                     "--device", "cpu"]) == 0
    assert stamp == {n: os.path.getmtime(os.path.join(out["port"], n))
                     for n in names}
    assert "extracted" not in capsys.readouterr().out


def test_extract_rolled_cli_n2n_layout(bundles, tmp_path, capsys):
    """A 1200 ppi PNG in an n2n subject directory is resized to 500 ppi
    before extraction (its template's size is the resized image's)."""
    paths, pb, _ = bundles
    sdir = tmp_path / "img" / "subject1"
    sdir.mkdir(parents=True)
    img = render_ridge_image(np.random.default_rng(30), 480, 520)[0]
    image_io.write_png(str(sdir / "f1.png"), np.round(img).astype(np.uint8),
                       filters=(1, 2, 4))
    cfg = str(tmp_path / "c.config")
    AfisConfig(**paths).save(cfg)
    assert cli.main(["extract-rolled", "--idir", str(tmp_path / "img"),
                     "--tdir", str(tmp_path / "t"), "--layout", "n2n",
                     "--config", cfg, "--device", "cpu"]) == 0
    assert "FAILED" not in capsys.readouterr().out
    t = read_final_template(str(tmp_path / "t" / "f1.dat"), "rolled")
    # 480 x 520 at 500 / 1200: 200 x 217, cropped to whole 16-px blocks
    assert (t.minu_template[0].h, t.minu_template[0].w) == (192, 208)
