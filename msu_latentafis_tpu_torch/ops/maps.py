"""Ridge orientation / frequency maps and the rolled segmentation mask.

Counterpart of the JAX package's ``ops/maps.py``, its rolled half
(reference: get_maps.py):
- ``get_maps_stft`` (:587-643): a block FFT directional-energy histogram
  with smoothed peak picking, then ``smooth_dir_map`` (:237-252), circular
  smoothing in the doubled-angle domain;
- ``get_quality_map_intensity`` (:349-366): the intensity-based rolled
  mask.
The dictionary quality, SSIM and ridge-flow parts belong to the latent
path.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..utils.precision import f32_compute
from .contrast import local_contrast_enhancement
from .fft import extract_blocks
from .gaussian import gaussian_blur_cv2, gaussian_blur_reflect, pad2d

BLOCK = 16


def smooth_dir_map(dir_map: torch.Tensor, sigma: float = 2.0,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Circular smoothing in the doubled-angle domain (get_maps.py:237-252)."""
    c = torch.cos(dir_map * 2)
    s = torch.sin(dir_map * 2)
    if mask is not None:
        c = torch.where(mask == 0, 0.0, c)
        s = torch.where(mask == 0, 0.0, s)
    c = gaussian_blur_reflect(c, sigma)
    s = gaussian_blur_reflect(s, sigma)
    return torch.atan2(s, c) * 0.5


def _stft_direction_tables(patch_size: int, nrof_dirs: int = 16):
    half = patch_size // 2
    x, y = np.meshgrid(np.arange(-half, half), np.arange(-half, half))
    # f64 tables: direction binning at exact pi/nd boundaries must not
    # depend on f32 arctan2 rounding
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    r = np.sqrt(x * x + y * y) + 1e-4
    f_low = patch_size / 18.0
    f_high = patch_size / 3.0
    band = (1.0 / (1 + (r / f_high) ** 4)) * (1.0 / (1 + (f_low / r) ** 4))
    d = np.arctan2(y, x)
    d[d < 0] += np.pi
    dir_ind = np.floor(d / (np.pi / nrof_dirs)).astype(int)
    dir_ind[dir_ind == nrof_dirs] = 0
    onehot = np.stack([(dir_ind == i).astype(np.float32)
                       for i in range(nrof_dirs)])      # [nd, P, P]
    sigma = patch_size / 3.0
    weight = np.exp(-(x * x + y * y) / (sigma * sigma)).astype(np.float32)
    return band.astype(np.float32), onehot, weight, r.astype(np.float32)


def _stft_histograms(img: torch.Tensor, patch_size: int, nrof_dirs: int):
    """Directional-energy analysis (get_maps.py:33-99) -> (sm, is_peak,
    fre_by_dir, bh, bw): the smoothed, normalized histogram [n, nd], its
    circular peak mask and the per-direction ridge frequency, with two
    quirks of the reference's ``local_STFT.analysis`` kept: the [1, 4, 1] / 6
    smoothing is IN PLACE (``smoothed_dir_norm = dir_norm`` aliases, so each
    step reads the already smoothed left neighbor: a recursive filter, not a
    convolution), and the frequency normalizer is that same aliased,
    smoothed and normalized array, not the raw bin energy."""
    band, onehot, weight, r = (torch.as_tensor(t, device=img.device)
                               for t in _stft_direction_tables(patch_size,
                                                               nrof_dirs))
    patches, bh, bw = extract_blocks(img, patch=patch_size, stride=BLOCK)
    n = patches.shape[0]
    p = patches * weight[None]
    p = p - p.mean(dim=(1, 2), keepdim=True)
    p = p / (p.reshape(n, -1).norm(dim=1)[:, None, None] + 1e-6)
    f = torch.fft.fftshift(torch.fft.fft2(p), dim=(1, 2)) * band[None]

    energy = f.abs()
    energy = energy / (energy.sum(dim=(1, 2), keepdim=True) + 1e-5)
    onehot = onehot.reshape(nrof_dirs, -1)
    with f32_compute():
        dir_norm = energy.reshape(n, -1) @ onehot.T             # [n, nd]
        wenergy = (energy * r[None]).reshape(n, -1) @ onehot.T

    # sequential in-place circular smoothing (get_maps.py:52-58): the left
    # neighbor is the smoothed one, the right neighbor always the raw value
    prev = dir_norm[:, nrof_dirs - 1]
    cols = []
    for i in range(nrof_dirs):
        prev = (prev + 4.0 * dir_norm[:, i]
                + dir_norm[:, (i + 1) % nrof_dirs]) / 6.0
        cols.append(prev)
    sm = torch.stack(cols, dim=1)
    sm = sm / (sm.sum(dim=1, keepdim=True) + 1e-5)

    is_peak = (sm > torch.roll(sm, 1, dims=1)) & (sm > torch.roll(sm, -1,
                                                                 dims=1))
    # aliased normalizer: the reference divides by smoothed_dir_norm
    fre_by_dir = 1.0 / (wenergy / (sm + 1e-12) + 1e-5)
    return sm, is_peak, fre_by_dir, bh, bw


def _stft_maps_core(img: torch.Tensor, patch_size: int = 64,
                    nrof_dirs: int = 16):
    """Each block's strongest smoothed peak -> (ori, fre) [bh, bw]; -10
    where a block has no peak."""
    sm, is_peak, fre_by_dir, bh, bw = _stft_histograms(img, patch_size,
                                                       nrof_dirs)
    conf = torch.where(is_peak, sm, -math.inf)
    best = torch.argmax(conf, dim=1)          # the first maximum
    ori_interval = math.pi / nrof_dirs
    ori = best * ori_interval + ori_interval / 2 + math.pi / 2
    fre = fre_by_dir.gather(1, best[:, None])[:, 0]
    has_peak = is_peak.any(dim=1)
    ori = torch.where(has_peak, ori, -10.0).to(torch.float32)
    fre = torch.where(has_peak, fre, -10.0)
    return ori.reshape(bh, bw), fre.reshape(bh, bw)


def get_maps_stft(img: torch.Tensor, patch_size: int = 64,
                  block_size: int = BLOCK):
    """Direction + frequency maps via block STFT (get_maps.py:587-643):
    the top-confidence smoothed peak per block, then circular smoothing."""
    img = torch.as_tensor(img, dtype=torch.float32)
    ovp = (patch_size - block_size) // 2
    dir_map, fre_map = _stft_maps_core(pad2d(img, ovp, "symmetric"),
                                       patch_size=patch_size)
    return smooth_dir_map(dir_map, sigma=2.0), fre_map


def _intensity_mask_core(dimg: torch.Tensor) -> torch.Tensor:
    """Device half of get_quality_map_intensity: contrast-normalize ->
    gradient magnitude -> Gaussian blur -> x8 downsample."""
    nimg = local_contrast_enhancement(dimg)
    gy, gx = torch.gradient(nimg)
    mag = gaussian_blur_cv2(gx.abs() + gy.abs(), ksize=21, sigma=7.0)
    return mag[::8, ::8]


def get_quality_map_intensity(img) -> np.ndarray:
    """Rolled segmentation mask from the contrast-normalized gradient
    magnitude (get_maps.py:349-366), uint8 [h, w] on the host. Takes a
    host array or a tensor on its device."""
    from . import morphology
    dimg = torch.as_tensor(img, dtype=torch.float32)
    mag = _intensity_mask_core(dimg).cpu().numpy()
    mask = (mag > 0.3 * 127.5).astype(np.uint8)
    mask = morphology.binary_opening(mask.astype(bool), np.ones((5, 5), bool))
    mask = np.kron(mask.astype(np.uint8), np.ones((8, 8), np.uint8))
    h, w = img.shape[:2]
    return mask[:h, :w]
