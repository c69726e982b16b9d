"""The port's latent extraction against the JAX package on the CPU: each
classical stage fed the JAX stage's own inputs (the STFT enhancement, the
ridge dictionary and its maps, SSIM, the ridge-flow and coarse maps, the
Gabor bank, plan and filtering, the mask upsample, the virtual grid), then
the ``LatentFeatureExtractor`` and the ``extract-latent`` CLI end to end
with the same (seeded, narrow) weights.

Tolerances, from the sums (u = 2^-24, both packages each within the bound
of the exact value, so their difference within twice it):
- ``median`` equals ``jnp.median`` bit for bit (a selection, then
  0.5 lo + 0.5 hi); the population std of N values within N u of it;
- the STFT: each patch's reconstruction within (4 n + 4096) u of the sum
  of its terms' magnitudes (four length-n transform passes, n = 64, and
  the 4,096-term energy sum), overlap-added; then the median within the
  reconstruction's bound (a 1-Lipschitz selection), the std within the
  measured difference, bounded by the same and N u; the output
  14 (|d rec| + |d median|) / std + |out - 127| |d std| / std;
- the dictionary similarity: 1,024-term dots of vectors of norm <= 1 after
  a 1,024-term normalization, each within 2 * 1,024 u: the argmax may
  differ only where the top two lie within 4 * 1,024 u, and the smoothed
  maps are compared away from such blocks (the blurs' and smoothing's
  reach); the blurs as test_torch_extract states;
- SSIM: each patch pair's dot of 4,096 terms, after two 4,096-term
  normalizations, within 3 * 4,096 u, spread by the 4 x 4 block weights;
- the Gabor plan: c, s and f from two f32 products with the zoom
  matrices, within (blkH + blkW + 2) u ||My|| ||Mx|| max|a|; a pixel's
  bucket may differ only where its degrees lie within the bound of an
  integer or f * 100 within it of k + 1/2;
- the Gabor filtering: each pixel's 361-tap sum within 361 u sum|p_t k_t|,
  then scaled by 255 / (hi - lo) (the min and max within the largest
  pixel's bound);
- the nets and descriptors as test_torch_extract states them.
A decision that differs is counted and must lie within its bound; none
does on these inputs."""
import math
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msu_latentafis_tpu import cli as jcli
from msu_latentafis_tpu.config import AfisConfig as JaxConfig
from msu_latentafis_tpu.ops import fft as jf
from msu_latentafis_tpu.ops import gabor as jg
from msu_latentafis_tpu.ops import maps as jm
from msu_latentafis_tpu.pipeline import latent as jl
from msu_latentafis_tpu.pipeline import models_bundle as jbundle
from msu_latentafis_tpu_torch import cli
from msu_latentafis_tpu_torch.config import AfisConfig
from msu_latentafis_tpu_torch.ops import fft as tf
from msu_latentafis_tpu_torch.ops import gabor as tg
from msu_latentafis_tpu_torch.ops import maps as tm
from msu_latentafis_tpu_torch.pipeline import (LatentFeatureExtractor,
                                               ModelBundle)
from msu_latentafis_tpu_torch.pipeline.latent import upsample_block_mask
from msu_latentafis_tpu_torch.templates import read_final_template
from msu_latentafis_tpu_torch.utils import image_io
from msu_latentafis_tpu_torch.utils.synthetic import (
    PassThroughEnhancement, latent_image, random_bundle_variables,
    render_ridge_image, write_bundle_npz)


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
    """The JAX package's ``ops.fft._dft_mats`` caches arrays made while
    a jit traces, and a second image shape then reads the first trace's
    tracers (ROADMAP Queue 3): the same matrices, uncached, here."""
    monkeypatch.setattr(jf, "_dft_mats", jf._dft_mats.__wrapped__)


U = 2.0 ** -24
NF, WIDTHS = 8, (4, 8, 8, 8)          # the nets' widths in these tests
DES_TOL = 9 * max(WIDTHS) * U * 4     # unit embeddings, the nets' longest K
LATENT_HW = (256, 288)


def close(got, want, tol):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got.astype(np.float64) - want) if got.size else np.zeros(1)
    assert np.all(err <= tol), (float(err.max()),
                                float(np.min(np.asarray(tol))))


@pytest.fixture(scope="module")
def small():
    return render_ridge_image(np.random.default_rng(0), 160, 208)[0] \
        .astype(np.float32)


@pytest.fixture(scope="module")
def latent():
    """A partial, low-contrast crop of a rendered print."""
    rng = np.random.default_rng(4)
    rolled = np.round(render_ridge_image(rng, 320, 320)[0]).astype(np.uint8)
    return latent_image(rng, rolled, *LATENT_HW).astype(np.float32)


@pytest.fixture(scope="module")
def dictionary():
    return tm.construct_dictionary(ori_num=60)


# ---------------------------------------------------------------------------
# median, std, STFT
# ---------------------------------------------------------------------------

def test_median_and_std_match_jnp():
    rng = np.random.default_rng(1)
    cases = [np.array([1, 2, 3, 10], np.float32), np.array([1, 2, 3],
                                                           np.float32),
             rng.standard_normal((7, 4096)).astype(np.float32),
             rng.standard_normal((5, 1001)).astype(np.float32),
             np.round(rng.standard_normal((6, 64)) * 2).astype(np.float32)]
    for x in cases:
        got = tf.median(torch.as_tensor(x), dim=-1)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jnp.median(x, axis=-1)))
        n = x.shape[-1]
        want = np.asarray(jnp.std(x, axis=-1))
        close(torch.as_tensor(x).std(dim=-1, correction=0), want,
              2 * n * U * want)
    assert float(tf.median(torch.tensor([1., 2., 3., 10.]))) == 2.5
    assert float(torch.median(torch.tensor([1., 2., 3., 10.]))) == 2.0
    x = torch.as_tensor(cases[2])
    np.testing.assert_array_equal(tf.median(x.T, dim=0, keepdim=True).numpy(),
                                  np.asarray(jnp.median(cases[2].T, axis=0,
                                                        keepdims=True)))


def stft_bound(padded: np.ndarray) -> np.ndarray:
    """Per pixel: twice (4 n + 4096) u times the overlap-add of each
    windowed patch's term magnitudes, the patch's reconstruction bounded by
    its spectrum's l1 norm over n^2 (the spectrum at unit energy)."""
    x = torch.as_tensor(padded)[None]
    rec, bh, bw = tf.stft_patches(x)
    _, weight = tf._stft_tables("cpu")
    p = x.unfold(1, 64, 16).unfold(2, 64, 16)[:, :bh, :bw] \
        .reshape(1, bh * bw, 64, 64)
    p = p - tf.median(p.reshape(1, bh * bw, -1), dim=-1)[..., None, None]
    band, _ = tf._stft_tables("cpu")
    spec = (torch.fft.fft2(p.double()) * band).abs()
    unit = spec / (spec.square().sum(dim=(-2, -1), keepdim=True).sqrt()
                   + 1e-4)
    scale = unit.sum(dim=(-2, -1)) / 64 ** 2          # >= max |rec| per patch
    per = scale[..., None, None] * weight.double()
    sums = tf.overlap_add(per, *padded.shape, bh, bw)[0]
    return (2 * (4 * 64 + 4096) * U * sums).numpy()


def test_stft_enhance_batch_matches_jax(small):
    imgs = np.stack([small, small[::-1].copy(), 255.0 - small])
    h0, w0 = small.shape
    want = np.asarray(jf.stft_enhance_batch(jnp.asarray(imgs)))
    got = tf.stft_enhance_batch(torch.as_tensor(imgs))
    half = 32
    x, y = np.meshgrid(np.arange(-half, half), np.arange(-half, half))
    weight = jnp.asarray(np.exp(-(x * x + y * y) / (64 / 3.0) ** 2),
                         jnp.float32)
    band = jnp.asarray(jf._bandpass(64), jnp.float32)
    for i, img in enumerate(imgs):
        padded = np.pad(img, 24)
        rec_j = np.asarray(jf._stft_core(jnp.asarray(padded), band, weight))
        rec_t = tf._stft_core(torch.as_tensor(padded)[None])[0]
        bound = stft_bound(padded)
        close(rec_t, rec_j, bound)
        rec_j = rec_j[24:24 + h0, 24:24 + w0]
        rec_t = rec_t[24:24 + h0, 24:24 + w0]
        d_rec = float(bound[24:24 + h0, 24:24 + w0].max())
        std = float(np.std(rec_j))
        d_std = abs(float(rec_t.std(correction=0)) - float(jnp.std(rec_j)))
        n = rec_j.size
        assert d_std <= d_rec + 2 * n * U * std
        # the tail alone, on JAX's reconstruction: the sums' order only
        close(tf.stft_normalize(torch.as_tensor(rec_j)),
              np.clip((rec_j - np.asarray(jnp.median(rec_j)))
                      / (np.asarray(jnp.std(rec_j)) + 1e-6) * 14 + 127,
                      0, 255),
              128 * 2 * n * U + 8 * 255 * U)
        out_tol = 14 * 2 * d_rec / std + 128 * d_std / std + 8 * 255 * U
        close(got[i], want[i], out_tol)
    assert torch.equal(tf.stft_enhance(torch.as_tensor(small)), got[0])


def test_overlap_add_matches_jax():
    rng = np.random.default_rng(2)
    for p, stride, bh, bw, h, w in ((64, 16, 5, 7, 144, 176),
                                    (32, 16, 3, 4, 64, 80),
                                    (20, 16, 3, 4, 60, 70)):
        x = rng.standard_normal((bh * bw, p, p)).astype(np.float32)
        want = np.asarray(jf.overlap_add(jnp.asarray(x), h, w, bh, bw,
                                         stride))
        got = tf.overlap_add(torch.as_tensor(x), h, w, bh, bw, stride)
        close(got, want, 16 * U * 4 * 4)


# ---------------------------------------------------------------------------
# the dictionary and its maps, SSIM
# ---------------------------------------------------------------------------

def test_construct_dictionary_equals_jax(dictionary):
    for got, want in zip(dictionary, jm.construct_dictionary(ori_num=60)):
        np.testing.assert_array_equal(got, want)
    assert dictionary[0].shape == (1024, 3240)
    for got, want in zip(tm.construct_dictionary(30, rolled=True),
                         jm.construct_dictionary(30, rolled=True)):
        np.testing.assert_array_equal(got, want)


DICT_GAP = 4 * 1024 * U


def dict_near_ties(simi: torch.Tensor, blk: tuple) -> np.ndarray:
    """Inner blocks whose two best atoms lie within DICT_GAP, on the
    [blkH, blkW] grid."""
    top = simi.topk(2, dim=1).values
    near = np.zeros(blk, bool)
    near[1:-1, 1:-1] = ((top[:, 0] - top[:, 1]) <= DICT_GAP).numpy() \
        .reshape(blk[0] - 2, blk[1] - 2)
    return near


def reach(mask: np.ndarray, r: int) -> np.ndarray:
    from scipy.ndimage import binary_dilation
    return binary_dilation(mask, np.ones((2 * r + 1, 2 * r + 1), bool)) \
        if mask.any() else mask


@pytest.mark.parametrize("bug", [True, False])
def test_quality_map_dict_matches_jax(small, dictionary, bug):
    img = tf.stft_enhance(torch.as_tensor(small)).numpy()
    want = [np.asarray(a) for a in jm.get_quality_map_dict(
        img, *dictionary, replicate_border_bug=bug)]
    got = tm.get_quality_map_dict(img, *dictionary, replicate_border_bug=bug)
    simi = tm.dict_similarity(torch.as_tensor(img),
                              torch.as_tensor(dictionary[0]))
    near = dict_near_ties(simi, want[0].shape)
    print(f"dictionary near ties: {int(near.sum())} blocks")
    close(got[0], want[0], DICT_GAP + 25 * U)
    keep_d, keep_f = ~reach(near, 6), ~reach(near, 1)
    close(got[1].numpy()[keep_d], want[1][keep_d], 2 * 13 * U * 2 * np.pi)
    close(got[2].numpy()[keep_f], want[2][keep_f],
          2 * 9 * U * float(np.abs(want[2]).max()))


def ssim_bound() -> float:
    w_blk = tm._ssim_weight(4, 4.0)
    return 2 * 3 * 4096 * U * float(w_blk.sum())


def test_ssim_matches_jax(small, dictionary):
    stft = tf.stft_enhance(torch.as_tensor(small)).numpy()
    other = np.asarray(small)
    want = np.asarray(jm.ssim_mask_quality(jnp.asarray(stft),
                                           jnp.asarray(other)))
    got = tm.ssim_mask_quality(torch.as_tensor(stft), torch.as_tensor(other))
    close(got, want, ssim_bound())
    blurred = np.asarray(jm.gaussian_blur_cv2(jnp.asarray(want), 5))
    for thr in (0.2, 0.65):
        near = np.abs(blurred - thr) <= ssim_bound() + 2 * 25 * U
        a, b = tm.ssim_mask(stft, other, thr), jm.ssim_mask(stft, other, thr)
        odd = a != b
        print(f"SSIM thr {thr}: {int(near.sum())} near ties, "
              f"{int(odd.sum())} blocks differ")
        assert not (odd & ~reach(near, 2)).any()
        np.testing.assert_array_equal(tm._ssim_mask_host(blurred, thr),
                                      jm._ssim_mask_host(blurred, thr))
    fused_j = jm.quality_ssim_fused(other, stft, *(jnp.asarray(d)
                                                   for d in dictionary))
    fused_t = tm.quality_ssim_fused(other, stft, *dictionary)
    close(fused_t[0], fused_j[0], DICT_GAP + 25 * U)
    close(fused_t[3], fused_j[3], ssim_bound() + 2 * 25 * U)


def test_ridge_flow_and_coarse_maps_match_jax(small, dictionary):
    """The ridge flow (table values): blocks may differ only within the
    5 x 5 reach of a block whose histogram decision (neighbouring bins,
    the two best peaks, the 2x pruning ratio) lies within the histograms'
    bound, from the port's own histograms; the coarse maps as the fine
    ones, away from dictionary near ties."""
    tex = np.asarray(jf.fast_cartoon_texture(small))
    padded = np.pad(tex, 24, mode="symmetric")
    sm, is_peak, _, bh, bw = tm._stft_histograms(torch.as_tensor(padded),
                                                 64, 16)
    hist_tol = 2 * 64 * 64 * U
    conf = torch.where(is_peak, sm, 0.0).sort(dim=1, descending=True).values
    near = ((sm - torch.roll(sm, 1, dims=1)).abs() <= hist_tol).any(dim=1)
    near |= (conf[:, 1] > 0) & (((conf[:, 0] - conf[:, 1]) <= 2 * hist_tol)
                                | ((conf[:, 0] - 2 * conf[:, 1]).abs()
                                   <= 3 * hist_tol))
    near = near.reshape(bh, bw).numpy()
    got = tm.get_ridge_flow_optimal_n(torch.as_tensor(tex)).numpy()
    want = np.asarray(jm.get_ridge_flow_optimal_n(tex))
    odd = got != want
    print(f"ridge flow: {int(near.sum())} near-tie blocks, {int(odd.sum())} "
          f"differ")
    assert not (odd & ~reach(near, 2)).any()
    o2 = np.random.default_rng(3).uniform(-1, 1, (1024, 3240)) \
        .astype(np.float32)
    d_all = dictionary[0]
    for ori, spacing in ((dictionary[1], dictionary[2]), (o2, o2)):
        want = [np.asarray(a) for a in jm.get_quality_map_dict_coarse(
            small, d_all, ori, spacing)]
        got = tm.get_quality_map_dict_coarse(small, torch.as_tensor(d_all),
                                             ori, spacing)
        simi = tm._coarse_similarity(torch.as_tensor(small),
                                     torch.as_tensor(d_all), 0.5)
        near = dict_near_ties(simi, want[0].shape)
        print(f"coarse dictionary near ties: {int(near.sum())} blocks")
        close(got[0], want[0], DICT_GAP + 25 * U)
        keep_d, keep_f = ~reach(near, 6), ~reach(near, 1)
        close(got[1].numpy()[keep_d], want[1][keep_d],
              2 * 13 * U * 2 * np.pi + 4 * U * np.pi)
        close(got[2].numpy()[keep_f], want[2][keep_f],
              2 * 9 * U * float(np.abs(want[2]).max()))


# ---------------------------------------------------------------------------
# Gabor
# ---------------------------------------------------------------------------

def gabor_near_ties(dir_map, fre_map, shape, device="cpu") -> np.ndarray:
    """Pixels whose bucket decision lies within its rounding bound: the
    degrees within the bound of an integer (truncation, the fold), or
    f * 100 within it of k + 1/2."""
    c, s, f = (a.double() for a in tg.plan_fields(dir_map, fre_map, shape,
                                                   16, device))
    norm = lambda m: float(np.abs(m).sum(axis=1).max())  # noqa: E731
    My = tg._zoom_mat(dir_map.shape[0], 16)
    Mx = tg._zoom_mat(dir_map.shape[1], 16)
    e = 2 * (sum(dir_map.shape) + 2) * U * norm(My) * norm(Mx)
    r = torch.sqrt(c * c + s * s).clamp(min=1e-30)
    d_deg = (2 * e / (2 * r) + 4 * U * np.pi) * 180 / np.pi + 180 * U
    deg = torch.atan2(s, c) * 0.5 / np.pi * 180
    near = (deg - deg.round()).abs() <= d_deg
    e_f = e * float(np.abs(fre_map).max()) * 100 + 100 * U
    f100 = f * 100
    near |= ((f100 - 0.5) - (f100 - 0.5).round()).abs() <= e_f
    return near.cpu().numpy()


@pytest.fixture(scope="module")
def gabor_maps(small, dictionary):
    q, d, f = (np.asarray(a) for a in jm.get_quality_map_dict(small,
                                                              *dictionary))
    mask = np.ones(small.shape, np.uint8)
    mask[:40, :50] = 0
    return d + math.pi / 2, f, mask


def test_gabor_bank_and_plan_match_jax(small, gabor_maps):
    np.testing.assert_array_equal(tg.get_gabor_filters(),
                                  jg.get_gabor_filters())
    np.testing.assert_array_equal(tg.get_gabor_filters(6, 20),
                                  jg.get_gabor_filters(6, 20))
    d, f, mask = gabor_maps
    for m in (mask, None):
        jb, ja, _, _ = jg.gabor_plan(d, f, small.shape, mask=m)
        tb, ta, ai, fn = tg.gabor_plan(d, f, small.shape, mask=m)
        assert (ai, fn) == (3, 30) and tb.dtype == torch.int16
        odd = (np.asarray(jb) != tb.numpy()) | (np.asarray(ja) != ta.numpy())
        near = gabor_near_ties(d, f, small.shape)
        print(f"Gabor plan: {int(near.sum())} near-tie pixels, "
              f"{int(odd.sum())} differ")
        assert not (odd & ~near).any()
    # block_size 1: pixel maps in f64, the same arithmetic
    rng = np.random.default_rng(5)
    ang = rng.uniform(-3.2, 3.2, small.shape)
    ang[0, :4] = [math.pi, -math.pi, 0.0, -1e-9]
    fr = rng.uniform(0.0, 0.35, small.shape)
    jb, ja, _, _ = jg.gabor_plan(ang, fr, small.shape, mask=mask,
                                 block_size=1)
    tb, ta, _, _ = tg.gabor_plan(ang, fr, small.shape, mask=mask,
                                 block_size=1)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    for a, b in zip(tg.gabor_plan_host(ang, fr, small.shape, mask=mask),
                    jg.gabor_plan_host(ang, fr, small.shape, mask=mask)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tg.gabor_plan_host(0.3, 0.11, small.shape),
                    jg.gabor_plan_host(0.3, 0.11, small.shape)):
        np.testing.assert_array_equal(a, b)


def gabor_tol(imgs, plan) -> float:
    """Three times the largest pixel's 361-tap bound, both sides, over the
    smallest image's span hi - lo, times 255: the pixel, the min and the
    max each within that bound."""
    taps = tg.gabor_taps(plan)
    worst, span = 0.0, math.inf
    for img in imgs:
        p = torch.nn.functional.unfold(torch.as_tensor(img)[None, None],
                                       19, padding=9)[0].T
        worst = max(worst, float((p.abs() * taps.abs()).sum(dim=1).max()))
        enh = torch.where(plan[1].reshape(-1), (p * taps).sum(dim=1), 0.0)
        span = min(span, float(enh.max() - enh.min()))
    return 255.0 * 3 * 2 * 361 * U * worst / span + 8 * 255 * U


def test_gabor_filtering_matches_jax(small, gabor_maps):
    d, f, mask = gabor_maps
    jplan = jg.gabor_plan(d, f, small.shape, mask=mask)
    plan = (torch.as_tensor(np.asarray(jplan[0])),
            torch.as_tensor(np.asarray(jplan[1])), 3, 30)
    other = np.asarray(255.0 - small[:, ::-1], np.float32)
    want = [np.asarray(a) for a in jg.gabor_apply_planned_multi(
        [small, other], jplan)]
    got = tg.gabor_apply_planned_multi([small, other], plan)
    tol = gabor_tol([small, other], plan)
    for a, b in zip(got, want):
        close(a, b, tol)
    close(tg.gabor_apply_planned(small, plan), want[0], tol)
    close(tg.gabor_filtering_pixel2(torch.as_tensor(small), d, f, mask=mask),
          jg.gabor_filtering_pixel2(small, d, f, mask=mask), tol)
    # the host twins: few buckets, f64 FFT correlation
    bucket, active = jg.gabor_plan_host(0.4, 0.09, small.shape, mask=mask)
    np.testing.assert_array_equal(
        tg.gabor_apply_host(small, bucket, active),
        jg.gabor_apply_host(small, bucket, active))
    # the taps are the bank's rows, exactly
    taps = tg.gabor_taps(plan)
    bank = tg.get_gabor_filters().reshape(-1, 361)
    np.testing.assert_array_equal(
        taps.numpy(), bank[np.asarray(jplan[0]).reshape(-1).astype(int)])


# ---------------------------------------------------------------------------
# the mask, the virtual grid, the extractor, the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(50, 48), (1, 1), (2, 3), (13, 17)])
def test_mask_upsample_equals_cv2(shape):
    rng = np.random.default_rng(sum(shape))
    for p in (0.0, 1.0, 0.05, 0.5, 0.9):
        blk = (rng.random(shape) < p).astype(np.int32)
        want = (cv2.resize(blk.astype(float), (16 * shape[1], 16 * shape[0]),
                           interpolation=cv2.INTER_LINEAR) > 0) \
            .astype(np.float64)
        got = upsample_block_mask(blk)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)


def test_virtual_minutiae_equal_jax():
    rng = np.random.default_rng(6)
    blk = np.zeros((16, 18), np.int32)
    blk[3:13, 2:15] = 1
    blk[6, 7] = 0
    mask = upsample_block_mask(blk)
    dir_map = rng.uniform(-1.5, 1.5, blk.shape).astype(np.float32)
    for both in (True, False):
        got = LatentFeatureExtractor._virtual_minutiae(
            mask, dir_map, 256, 288, both_directions=both)
        want = jl.LatentFeatureExtractor._virtual_minutiae(
            mask, dir_map, 256, 288, both_directions=both)
        assert len(got) > 10
        np.testing.assert_array_equal(got, want)


def test_consensus_matches_jax_on_large_sets():
    """get_common_minutiae grows its points in one array: the same votes
    as the JAX package's list when hundreds of points are appended, and at
    both thresholds."""
    from msu_latentafis_tpu.ops import minutiae as jmi
    from msu_latentafis_tpu_torch.ops import minutiae as tmi
    rng = np.random.default_rng(8)
    sets = []
    for n in (600, 600, 120, 110, 130):
        m = np.column_stack([rng.integers(0, 768, n), rng.integers(0, 800, n),
                             rng.uniform(0, 2 * np.pi, n), rng.random(n)])
        sets.append(m.astype(np.float32))
    sets[1][:300] = sets[0][:300]
    for thr in (2, 3):
        np.testing.assert_array_equal(tmi.get_common_minutiae(sets, thr),
                                      jmi.get_common_minutiae(sets, thr))
    assert len(tmi.get_common_minutiae(sets, 2)) > 300
    assert tmi.get_common_minutiae([sets[0]] * 3 + [sets[0][:0]] * 2,
                                   2).shape == (0, 4)


@pytest.fixture(scope="module")
def trees():
    return random_bundle_variables(17, nf_enh=4, nf_minu=NF, widths=WIDTHS)


def jax_bundle(trees, stand_in: bool):
    import jax
    from msu_latentafis_tpu import models as jmod
    jx = lambda k: jax.tree_util.tree_map(jnp.asarray, trees[k])  # noqa
    pts = (2, 8, 11)
    b = jbundle.ModelBundle(
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
    if stand_in:      # PassThroughEnhancement's function
        b._enh_apply = lambda v, x: jnp.tanh(8.0 * x)
    return b


@pytest.fixture(scope="module")
def bundles(trees, tmp_path_factory):
    paths = write_bundle_npz(str(tmp_path_factory.mktemp("npz")), trees)
    port = ModelBundle.initialize(AfisConfig(**paths), device="cpu")
    stand = ModelBundle.initialize(AfisConfig(**paths), device="cpu")
    stand.enhancement = PassThroughEnhancement()
    return paths, port, stand, jax_bundle(trees, False), \
        jax_bundle(trees, True)


MINU_TOL = 16 * 64 * U * 16     # orientation and confidence, as rolled


def compare_latent_templates(a, b):
    """Port template a against the JAX template b: 28 minutiae templates,
    minutiae equal in position, orientation and confidence within the
    nets' bound, descriptors within DES_TOL, the mask and the orientation
    map; the texture template likewise."""
    assert len(a.minu_template) == len(b.minu_template) == 28
    for ma, mb in zip(a.minu_template, b.minu_template):
        assert ma.minutiae.shape == mb.minutiae.shape
        np.testing.assert_array_equal(ma.minutiae[:, :2], mb.minutiae[:, :2])
        close(ma.minutiae[:, 2:], mb.minutiae[:, 2:], MINU_TOL)
        np.testing.assert_array_equal(ma.mask, mb.mask)
        close(ma.oimg, mb.oimg, 2 * 13 * U * 2 * np.pi)
        assert len(ma.des) == len(mb.des)
        for x, y in zip(ma.des, mb.des):
            close(x, y, DES_TOL)
    assert len(a.texture_template) == len(b.texture_template)
    for ta, tb in zip(a.texture_template, b.texture_template):
        close(ta.minutiae, tb.minutiae, 2 * 13 * U * 2 * np.pi)
        for x, y in zip(ta.des, tb.des):
            close(x, y, DES_TOL)


def test_latent_extractor_matches_jax(bundles, latent):
    """With a stand-in enhancement (the seeded autoencoder's output is
    noise, which leaves the mask empty), the whole extractor; then at
    1000 ppi (the image resized to the same shape); then the seeded
    autoencoder itself: an empty mask and no texture template in both."""
    _, port, stand, jseed, jstand = bundles
    ext = LatentFeatureExtractor(models=stand)
    jext = jl.LatentFeatureExtractor(models=jstand)
    got, want = ext.extract(latent), jext.extract(latent)
    print(f"latent: {ext.diag}")
    assert ext.diag["mask_frac"] > 0.1 and len(got.texture_template) == 1
    assert ext.diag["minutiae_per_set"] == jext.diag["minutiae_per_set"]
    assert all(n > 0 for n in ext.diag["minutiae_per_set"])
    compare_latent_templates(got, want)
    assert set(ext.timings) == {"cartoon", "stft_x3", "aec", "maps_mask",
                                "detect_3", "gabor_x2", "detect_2",
                                "consensus", "minutiae", "descriptors",
                                "texture"} == set(jext.timings)
    big = image_io.resize_linear(latent, 2.0, 2.0)
    compare_latent_templates(ext.extract(big, ppi=1000),
                             jext.extract(big, ppi=1000))
    assert ext.extract(np.zeros((1040, 1056), np.float32)) is None
    seeded = LatentFeatureExtractor(models=port)
    got = seeded.extract(latent)
    compare_latent_templates(got, jl.LatentFeatureExtractor(
        models=jseed).extract(latent))
    assert seeded.diag["mask_frac"] == 0.0 and not got.texture_template


def test_extract_latent_cli_matches_jax(bundles, tmp_path, monkeypatch,
                                        capsys, latent):
    """Both CLIs over the same directory (a BMP and a PNG latent, a bad
    file) with the same weights: the same files; each one read back as a
    final latent .dat holds 28 minutiae templates and a texture template,
    minutiae equal, descriptors within the nets' and the DR's bounds. A
    second run skips every existing template; ``--i`` writes one."""
    paths, _, _, _, jstand = bundles
    idir = tmp_path / "img"
    idir.mkdir()
    rng = np.random.default_rng(40)
    rolled = np.round(render_ridge_image(rng, 300, 320)[0]).astype(np.uint8)
    image_io.write_bmp(str(idir / "l0.bmp"), np.round(latent)
                       .astype(np.uint8))
    image_io.write_png(str(idir / "l1.png"), latent_image(rng, rolled,
                                                          *LATENT_HW),
                       filters=(0, 1, 4))
    (idir / "broken.png").write_bytes(b"\x89PNG\r\n\x1a\n not an image")
    monkeypatch.setattr(jbundle.ModelBundle, "initialize",
                        classmethod(lambda cls, cfg=None: jstand))
    init = ModelBundle.initialize

    def with_stand_in(cfg=None, device="cuda"):
        b = init(cfg, device=device)
        b.enhancement = PassThroughEnhancement().to(b.device)
        return b
    monkeypatch.setattr(ModelBundle, "initialize", with_stand_in)
    out = {}
    for who in ("port", "jax"):
        tdir = str(tmp_path / who)
        cfg_path = str(tmp_path / f"{who}.config")
        (AfisConfig(**paths) if who == "port"
         else JaxConfig()).save(cfg_path)
        args = ["extract-latent", "--idir", str(idir), "--tdir", tdir,
                "--config", cfg_path]
        if who == "port":
            assert cli.main(args + ["--device", "cpu"]) == 0
        else:
            assert jcli.main(args) == 0
        printed = capsys.readouterr().out
        assert printed.count("extraction FAILED") == 1, printed
        out[who] = tdir
    names = sorted(os.listdir(out["jax"]))
    assert sorted(os.listdir(out["port"])) == names == ["l0.dat", "l1.dat"]
    for name in names:
        a, b = (read_final_template(os.path.join(out[w], name), "latent")
                for w in ("port", "jax"))
        assert len(a.minu_template) == 28 and len(a.texture_template) == 1
        assert sum(len(m.minutiae) for m in a.minu_template) > 0
        for ma, mb in zip(a.minu_template, b.minu_template):
            np.testing.assert_array_equal(ma.minutiae[:, :2],
                                          mb.minutiae[:, :2])
            close(ma.minutiae[:, 2:], mb.minutiae[:, 2:], MINU_TOL)
            np.testing.assert_allclose(ma.des, mb.des, rtol=1e-5, atol=1e-5)
        ta, tb = a.texture_template[0], b.texture_template[0]
        np.testing.assert_array_equal(ta.minutiae[:, :2], tb.minutiae[:, :2])
        close(ta.minutiae[:, 2:], tb.minutiae[:, 2:], 2 * 13 * U * 2 * np.pi)
        np.testing.assert_allclose(ta.des, tb.des, rtol=1e-5, atol=1e-5)
    os.remove(idir / "broken.png")
    stamp = {n: os.path.getmtime(os.path.join(out["port"], n))
             for n in names}
    assert cli.main(["extract-latent", "--idir", str(idir), "--tdir",
                     out["port"], "--config", str(tmp_path / "port.config"),
                     "--device", "cpu"]) == 0
    assert stamp == {n: os.path.getmtime(os.path.join(out["port"], n))
                     for n in names}
    assert "extracted" not in capsys.readouterr().out
    one = str(tmp_path / "one")
    assert cli.main(["extract-latent", "--i", str(idir / "l0.bmp"),
                     "--tdir", one, "--config",
                     str(tmp_path / "port.config"), "--device", "cpu"]) == 0
    assert os.listdir(one) == ["l0.dat"]
    with pytest.raises(SystemExit):
        cli.main(["extract-latent", "--tdir", one])
    # larger than 1,000 px both ways: an empty .dat, and the run goes on
    # (the JAX CLI raises there: ROADMAP Queue 3)
    image_io.write_png(str(tmp_path / "big.png"),
                       np.full((1008, 1024), 128, np.uint8))
    assert cli.main(["extract-latent", "--i", str(tmp_path / "big.png"),
                     "--tdir", one, "--config",
                     str(tmp_path / "port.config"), "--device", "cpu"]) == 0
    t = read_final_template(os.path.join(one, "big.dat"), "latent")
    assert not t.minu_template and not t.texture_template
