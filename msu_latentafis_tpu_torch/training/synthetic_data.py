"""Synthetic fingerprint generation for stand-in model training.

Counterpart of the JAX package's ``training/synthetic_data.py``: smooth
random orientation fields rendered through the ridge-wave dictionary prior
(the reference implementation's get_maps.py:255-299 doubles as a
fingerprint prior), synthetic minutiae carved as local ridge terminations
with their 12-channel cylinder targets, latent-lift clutter, and labeled
descriptor patch batches in the deployment's enhancement domains.

Every function draws from its ``np.random.Generator`` in the JAX package's
order, so one seed gives the same minutiae, labels and crop centres. The
image operations (STFT, cartoon texture, local contrast) are the port's
``ops``, run on ``device``; the Gabor filtering of the descriptor batch is
the host twin (``ops.gabor.gabor_apply_host``), as in the JAX package. The
ridge renderer is ``utils.synthetic.render_ridge_image``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils.synthetic import render_ridge_image

__all__ = ["random_orientation_field", "render_ridge_image",
           "cylinder_target_np", "synthetic_minutiae_sample",
           "add_latent_clutter", "synthetic_latent_sample",
           "synthetic_enhancement_sample", "synthetic_descriptor_batch"]


def _on(img: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(img), dtype=torch.float32,
                           device=device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.float64)


def random_orientation_field(rng: np.random.Generator, blkH: int, blkW: int,
                             smooth: int = 5) -> np.ndarray:
    """Smooth random orientation field in radians (doubled-angle Gaussian
    smoothed noise)."""
    from scipy.ndimage import gaussian_filter
    c = gaussian_filter(rng.standard_normal((blkH, blkW)), smooth)
    s = gaussian_filter(rng.standard_normal((blkH, blkW)), smooth)
    return np.arctan2(s, c) * 0.5


def cylinder_target_np(minutiae: np.ndarray, h: int, w: int,
                       num_ori: int = 12) -> np.ndarray:
    """NumPy minutiae-cylinder target (the math of ``ops.cylinder``) for
    host-side data generation."""
    sigma2 = 25.0
    out = np.zeros((h, w, num_ori), np.float32)
    if len(minutiae) == 0:
        return out
    Y, X = np.mgrid[0:h, 0:w].astype(np.float32)
    ch = np.arange(num_ori) * 2 * np.pi / num_ori
    for x, y, ori in np.asarray(minutiae)[:, :3]:
        if x < 0 or y < 0:
            continue
        ori = ori % (2 * np.pi)
        spatial = np.exp(-((X - x) ** 2 + (Y - y) ** 2) / sigma2)
        od = np.abs(ori - ch)
        od = np.minimum(od, 2 * np.pi - od)
        out += spatial[:, :, None] * np.exp(-od / np.pi * 6.0)[None, None, :]
    return out


def synthetic_minutiae_sample(rng: np.random.Generator, size: int = 128,
                              n_minutiae: int = 8, num_ori: int = 12,
                              preprocess: str = "none", device="cpu"):
    """(image [size, size, 1] raw units, cylinder target [size, size, 12],
    minutiae [n, 4]). ``preprocess`` applies the pipeline's normalization
    for the detector ('stft' on the latent path, 'cartoon' on the rolled
    path) on ``device``."""
    img, theta = render_ridge_image(rng, size, size,
                                    spacing=float(rng.uniform(8, 10.5)))
    clutter = rng.random() < 0.5
    minutiae = np.zeros((n_minutiae, 4), np.float64)
    minutiae[:, 0] = rng.uniform(12, size - 12, n_minutiae)
    minutiae[:, 1] = rng.uniform(12, size - 12, n_minutiae)
    # orientation from the local ridge flow (+pi flip at random)
    for i in range(n_minutiae):
        t = theta[int(minutiae[i, 1]), int(minutiae[i, 0])]
        minutiae[i, 2] = (-t + (np.pi if rng.random() < 0.5 else 0.0)) \
            % (2 * np.pi)
    # carve ridge endings: damp the ridge wave locally past each minutia
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    for x, y, o, _ in minutiae:
        d2 = (xx - x) ** 2 + (yy - y) ** 2
        along = (xx - x) * np.cos(-o) + (yy - y) * np.sin(-o)
        wedge = (along > 0) & (d2 < 15 ** 2)
        img[wedge] = 0.5 * img[wedge] + 0.5 * 200.0
    if clutter:
        img = add_latent_clutter(rng, img,
                                 strength=float(rng.uniform(0.3, 0.9)))
    if preprocess == "stft":
        from ..ops.fft import stft_enhance
        img = _host(stft_enhance(_on(img, device)))
    elif preprocess == "cartoon":
        from ..ops.fft import fast_cartoon_texture
        img = _host(fast_cartoon_texture(_on(img, device)))
    cyl = cylinder_target_np(minutiae, size, size, num_ori=num_ori)
    return img[:, :, None].astype(np.float32), cyl, minutiae


def add_latent_clutter(rng: np.random.Generator, img: np.ndarray,
                       strength: float = 1.0) -> np.ndarray:
    """Latent-lift clutter over a clean ridge image: low-frequency shading,
    smooth contrast falloff, dark / bright strokes, blobs and sensor
    noise."""
    from scipy.ndimage import gaussian_filter
    h, w = img.shape
    out = img.astype(np.float64).copy()
    bg = gaussian_filter(rng.standard_normal((h, w)), max(h, w) / 8.0)
    bg /= np.abs(bg).max() + 1e-9
    out += bg * rng.uniform(20, 80) * strength
    amp = gaussian_filter(rng.random((h, w)), max(h, w) / 6.0)
    amp = (amp - amp.min()) / (amp.max() - amp.min() + 1e-9)
    lo = rng.uniform(0.25, 0.6)
    out = 128.0 + (out - 128.0) * (lo + (1.0 - lo) * amp)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    for _ in range(int(rng.integers(0, 6))):
        theta = rng.uniform(0, np.pi)
        c, s = np.cos(theta), np.sin(theta)
        offset = rng.uniform(-0.5, 0.5) * (h + w)
        d = np.abs((xx - w / 2) * c + (yy - h / 2) * s - offset)
        mask = d < rng.uniform(1.0, 4.0)
        shade = rng.uniform(0, 255)
        alpha = rng.uniform(0.4, 0.9) * strength
        out[mask] = (1 - alpha) * out[mask] + alpha * shade
    for _ in range(int(rng.integers(0, 4))):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r2 = rng.uniform(5.0, h / 3.0) ** 2
        m = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / r2) \
            * 0.6 * strength
        out = out * (1 - m) + rng.uniform(0, 255) * m
    out += rng.standard_normal((h, w)) * rng.uniform(3, 15)
    return np.clip(out, 0, 255)


def synthetic_latent_sample(rng: np.random.Generator, size: int = 128):
    """(cluttered latent-style raw image [size, size], noise-free ridge
    target [size, size, 1] in [-1, 1]): the enhancement net's training
    pair before the pipeline's preprocessing of the input side."""
    seed = rng.integers(0, 2**31)
    clean_img, _ = render_ridge_image(np.random.default_rng(seed), size,
                                      size,
                                      spacing=float(rng.uniform(8, 10.5)),
                                      noise_sigma=0.0)
    clean = (clean_img / 128.0 - 1.0)[:, :, None].astype(np.float32)
    noisy = np.clip(clean_img
                    + rng.standard_normal((size, size)) * 12.0, 0, 255)
    dirty = add_latent_clutter(rng, noisy)
    return dirty, clean


def synthetic_enhancement_sample(rng: np.random.Generator, size: int = 128):
    """(noisy ridge image [size, size, 1] raw, noise-free target in
    [-1, 1])."""
    img, _ = render_ridge_image(rng, size, size,
                                spacing=float(rng.uniform(8, 10.5)),
                                noise_sigma=0.0)
    noisy = np.clip(img + rng.standard_normal(img.shape) * 12.0, 0, 255)
    x = noisy[:, :, None].astype(np.float32)
    return x, (img[:, :, None].astype(np.float32) / 128.0 - 1.0)


def finger_renditions(rng: np.random.Generator, big: int, sp: float,
                      device="cpu") -> Tuple[list, list]:
    """One finger of ``synthetic_descriptor_batch``: (rolled renditions,
    latent renditions), each [big, big] f64, drawing as the JAX package
    does."""
    from ..ops.contrast import local_contrast_enhancement_gaussian
    from ..ops.fft import fast_cartoon_texture, stft_enhance
    from ..ops.gabor import gabor_apply_host, gabor_plan_host
    base, theta = render_ridge_image(rng, big, big, spacing=sp,
                                     noise_sigma=0.0)
    noisy = np.clip(base + rng.standard_normal(base.shape) * 10, 0, 255)
    lifted = add_latent_clutter(rng, noisy,
                                strength=float(rng.uniform(0.4, 1.0)))
    lifted_t = _on(lifted, device)
    cartoon_l = _host(fast_cartoon_texture(lifted_t))
    contrast_l = _host(local_contrast_enhancement_gaussian(lifted_t))
    bucket, active = gabor_plan_host(theta + np.pi / 2,
                                     np.full((big, big), 1.0 / sp),
                                     (big, big))
    rolled = [noisy,
              _host(local_contrast_enhancement_gaussian(_on(noisy, device)))]
    latent = [_host(stft_enhance(lifted_t)), cartoon_l,
              gabor_apply_host(contrast_l, bucket, active).astype(np.float64),
              gabor_apply_host(cartoon_l, bucket, active).astype(np.float64)]
    return rolled, latent


def synthetic_descriptor_batch(rng: np.random.Generator, n_ids: int = 16,
                               samples_per_id: int = 4, size: int = 96,
                               device="cpu"):
    """Labeled patch batch for triplet training: (x [n_ids *
    samples_per_id, size, size, 1] in [-1, 1], labels int32).

    Identities are locations on a shared finger (4 per finger), each
    rendered in the deployment's domains: the rolled side's raw print and
    contrast image, the latent side's STFT, cartoon texture and the Gabor
    filterings of the contrast and cartoon images (the plan from the
    renderer's orientation + pi / 2 and its ridge frequency). Each id's
    first two samples are a (rolled, Gabor-latent) pair; every sample is
    shifted by up to 6 px, rotated by up to 10 degrees, and jittered in
    brightness, contrast and noise."""
    from scipy.ndimage import rotate
    n_fingers = max(1, n_ids // 4)
    ids_per_finger = -(-n_ids // n_fingers)
    big = 256
    xs, ys = [], []
    label = 0
    for _ in range(n_fingers):
        sp = float(np.round(rng.uniform(8, 10.5)))
        rolled, latent = finger_renditions(rng, big, sp, device)
        renditions = rolled + latent
        centers = rng.uniform(size // 2 + 8, big - size // 2 - 8,
                              (ids_per_finger, 2))
        for cy, cx in centers:
            if label >= n_ids:
                break
            for k in range(samples_per_id):
                if k == 0:
                    j = rolled[int(rng.integers(0, 2))]
                elif k == 1:
                    j = latent[int(rng.integers(2, 4))]
                else:
                    j = renditions[int(rng.integers(0, len(renditions)))]
                ang = float(rng.uniform(-10, 10))
                dy = int(cy - size // 2 + rng.integers(-6, 7))
                dx = int(cx - size // 2 + rng.integers(-6, 7))
                patch = j[dy:dy + size, dx:dx + size].copy()
                if abs(ang) > 0.5:
                    patch = rotate(patch, ang, reshape=False,
                                   mode="nearest", order=1)
                patch = patch * float(rng.uniform(0.7, 1.3)) \
                    + float(rng.uniform(-20, 20))
                patch = patch + rng.standard_normal(patch.shape) \
                    * float(rng.uniform(2, 12))
                xs.append(np.clip(patch, 0, 255)[:, :, None])
                ys.append(label)
            label += 1
    x = np.stack(xs).astype(np.float32) / 128.0 - 1.0
    return x, np.asarray(ys, np.int32)
