"""Pixelwise Gabor enhancement (filtering.py:136-216).

Counterpart of the JAX package's ``ops/gabor.py``. For every pixel the
reference picks a Gabor kernel by the local (orientation, frequency)
bucket and correlates at that pixel. Here every kernel lives in one bank
[n_ori * n_freq, 361] (kernels zero-embedded in the 19 x 19 footprint, the
sums unchanged); ``gabor_plan`` turns the block maps into each pixel's
bucket and whether it is filtered at all, and ``gabor_apply_planned``
gathers each pixel's 361 taps from the bank (``bank_flat[bucket]``, exact:
the bank holds integers) and multiply-reduces them against the pixel's
19 x 19 neighbourhood (``unfold``, zero padding) in f32, then masks and
min-max scales to [0, 255]. Several images under one plan share the
gathered taps. ``gabor_plan_host`` / ``gabor_apply_host`` are the NumPy
twins for host-side training data.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.precision import f32_compute

KMAX = 19          # the largest kernel footprint at sigma 3, n_stds 3
KHALF = KMAX // 2
BORDER = 15        # pixels of each image edge left unfiltered


def _gabor_kernel_real(frequency: float, theta: float, sigma: float = 3.0,
                       n_stds: float = 3.0) -> np.ndarray:
    """Real part of the skimage-style complex Gabor kernel at its natural
    (theta-dependent) size."""
    x0 = int(np.ceil(max(abs(n_stds * sigma * np.cos(theta)),
                         abs(n_stds * sigma * np.sin(theta)), 1)))
    y0 = int(np.ceil(max(abs(n_stds * sigma * np.sin(theta)),
                         abs(n_stds * sigma * np.cos(theta)), 1)))
    y, x = np.mgrid[-y0:y0 + 1, -x0:x0 + 1]
    rotx = x * np.cos(theta) + y * np.sin(theta)
    roty = -x * np.sin(theta) + y * np.cos(theta)
    g = np.exp(-0.5 * (rotx ** 2 / sigma ** 2 + roty ** 2 / sigma ** 2))
    g /= 2 * np.pi * sigma * sigma
    return g * np.cos(2 * np.pi * frequency * rotx)


@functools.lru_cache(maxsize=4)
def get_gabor_filters(angle_inc: int = 3, fre_num: int = 30) -> np.ndarray:
    """The normalized, int16-quantized kernel bank [n_ori, fre_num, 19, 19]
    (filtering.py:61-81), zero-embedded in the largest footprint."""
    n_ori = 180 // angle_inc
    bank = np.zeros((n_ori, fre_num, KMAX, KMAX), np.float32)
    for i in range(n_ori):
        ori = i * angle_inc / 180.0 * math.pi
        for j in range(fre_num):
            if j < 5:
                continue
            k = _gabor_kernel_real(j * 0.01, theta=ori)
            k = k - k.mean()
            k = k / (np.linalg.norm(k) + 1e-5)
            k = np.asarray(k * 255, np.int16).astype(np.float32)
            kh, kw = k.shape
            oy, ox = (KMAX - kh) // 2, (KMAX - kw) // 2
            bank[i, j, oy:oy + kh, ox:ox + kw] = k
    return bank


@functools.lru_cache(maxsize=8)
def _zoom_mat(n: int, factor: int) -> np.ndarray:
    """scipy.ndimage.zoom(order=3) along one axis as an [n * factor, n]
    matrix: the zoom (spline prefilter and evaluation) is linear in its
    input, so the matrix is the zoom of an identity."""
    from scipy.ndimage import zoom
    return zoom(np.eye(n), (factor, 1), order=3).astype(np.float32)


def _border_mask(h: int, w: int, mask=None) -> np.ndarray:
    """True inside the 15-px border (and inside ``mask`` where given)."""
    border = np.ones((h, w), bool)
    border[:BORDER, :] = False
    border[:, :BORDER] = False
    border[h - BORDER:, :] = False
    border[:, w - BORDER:] = False
    if mask is not None:
        border &= np.asarray(mask)[:h, :w] > 0
    return border


def plan_fields(dir_map, fre_map, shape: Tuple[int, int], block_size: int,
                device) -> tuple:
    """The block maps zoomed to pixels (filtering.py:143-148): cos and sin
    of twice the direction and the frequency, each through two f32
    products with the cubic zoom matrices, cropped to ``shape``. ->
    (c, s, f), [h, w] each."""
    h, w = shape
    dm = torch.as_tensor(dir_map, dtype=torch.float32, device=device)
    fm = torch.as_tensor(fre_map, dtype=torch.float32, device=device)
    My = torch.as_tensor(_zoom_mat(dm.shape[0], block_size), device=device)
    Mx = torch.as_tensor(_zoom_mat(dm.shape[1], block_size), device=device)
    with f32_compute():
        up = lambda a: ((My @ a) @ Mx.T)[:h, :w]  # noqa: E731
        return up(torch.cos(dm * 2)), up(torch.sin(dm * 2)), up(fm)


def buckets(angle: torch.Tensor, f: torch.Tensor, allowed: torch.Tensor,
            angle_inc: int, fre_num: int):
    """Each pixel's bank row and whether it is filtered: the angle in
    degrees truncated toward 0, 180 folded to 0; the frequency index
    round(f * 100) (half to even) within [5, fre_num)."""
    deg = (angle / math.pi * 180).to(torch.int32)
    deg = torch.where(deg < 0, deg + 180, deg)
    deg = torch.where(deg == 180, 0, deg)
    f_ind = torch.round(f * 100).to(torch.int32)
    active = (f_ind >= 5) & (f_ind < fre_num) & allowed
    bucket = (deg // angle_inc) * fre_num + torch.clamp(f_ind, 0,
                                                        fre_num - 1)
    return bucket.to(torch.int16), active


def gabor_plan(dir_map, fre_map, shape: Tuple[int, int], mask=None,
               block_size: int = 16, angle_inc: int = 3, device=None):
    """Per-pixel (bucket, active) maps for :func:`gabor_apply_planned`, on
    ``device`` (default: that of ``dir_map`` if a tensor, else the CPU):
    block maps (``block_size`` > 1) go through the cubic zoom, pixel maps
    (``block_size`` 1) are used as they are. -> (bucket [h, w] int16,
    active [h, w] bool, angle_inc, fre_num)."""
    h, w = shape
    fre_num = 30
    if device is None:
        device = dir_map.device if torch.is_tensor(dir_map) else "cpu"
    if block_size > 1:
        allowed = torch.as_tensor(_border_mask(h, w, mask), device=device)
        c, s, f = plan_fields(dir_map, fre_map, shape, block_size, device)
        angle = torch.atan2(s, c) * 0.5
    else:
        m = np.ones((h, w), np.uint8) if mask is None else mask
        allowed = torch.as_tensor(_border_mask(h, w, m), device=device)
        angle = torch.as_tensor(dir_map, device=device)
        f = torch.as_tensor(fre_map, device=device)
    bucket, active = buckets(angle, f, allowed, angle_inc, fre_num)
    return bucket, active, angle_inc, fre_num


@functools.lru_cache(maxsize=8)
def _bank_flat(angle_inc: int, fre_num: int, device: str) -> torch.Tensor:
    bank = get_gabor_filters(angle_inc, fre_num)
    return torch.as_tensor(bank.reshape(-1, KMAX * KMAX), device=device)


def gabor_taps(plan) -> torch.Tensor:
    """Each pixel's 361 taps [h * w, 361], gathered from the bank (exact:
    its entries are integers of at most 255)."""
    bucket, _, angle_inc, fre_num = plan
    bank = _bank_flat(angle_inc, fre_num, str(bucket.device))
    return bank[bucket.reshape(-1).long()]


def gabor_apply_taps(imgs: torch.Tensor, taps: torch.Tensor,
                     active: torch.Tensor) -> torch.Tensor:
    """enh[i, j] = sum over the 361 taps t = dy * 19 + dx of
    img[i + dy - 9, j + dx - 9] * taps[(i, j), t] (zero outside), for each
    image of [N, h, w]; inactive pixels 0; each image min-max scaled to
    [0, 255] (filtering.py:214-216)."""
    n, h, w = imgs.shape
    out = []
    for img in imgs:
        patches = F.unfold(img[None, None].to(torch.float32), KMAX,
                           padding=KHALF)[0]           # [361, h * w]
        enh = (patches.T * taps).sum(dim=1).reshape(h, w)
        enh = torch.where(active, enh, 0.0)
        lo, hi = enh.min(), enh.max()
        out.append((enh - lo + 1e-4) / (hi - lo + 1e-4) * 255.0)
    return torch.stack(out)


def gabor_apply_planned(img, plan) -> torch.Tensor:
    bucket, active = plan[0], plan[1]
    img = torch.as_tensor(img, dtype=torch.float32, device=bucket.device)
    return gabor_apply_taps(img[None], gabor_taps(plan), active)[0]


def gabor_apply_planned_multi(imgs: Sequence, plan) -> list:
    """Several same-shape images under one plan: the gathered taps are
    shared (the latent path enhances its contrast and texture images with
    one orientation / frequency plan, extraction_latent.py:135-148)."""
    bucket, active = plan[0], plan[1]
    stack = torch.stack([torch.as_tensor(im, dtype=torch.float32,
                                         device=bucket.device)
                         for im in imgs])
    out = gabor_apply_taps(stack, gabor_taps(plan), active)
    return [out[i] for i in range(len(imgs))]


def gabor_plan_host(angle: np.ndarray, frequency: np.ndarray,
                    shape: Tuple[int, int], mask=None, angle_inc: int = 3,
                    fre_num: int = 30):
    """NumPy twin of :func:`gabor_plan` at block_size 1 (pixel-resolution
    maps; broadcast scalars) for host-side training data. -> (bucket int32,
    active bool)."""
    h, w = shape
    allowed = _border_mask(h, w, np.ones((h, w), np.uint8) if mask is None
                           else mask)
    angle = np.broadcast_to(np.asarray(angle), (h, w))
    frequency = np.broadcast_to(np.asarray(frequency), (h, w))
    deg = (angle / math.pi * 180).astype(int)
    deg = np.where(deg < 0, deg + 180, deg)
    deg = np.where(deg == 180, 0, deg)
    f_ind = np.around(frequency * 100).astype(int)
    active = (f_ind >= 5) & (f_ind < fre_num) & allowed
    bucket = (deg // angle_inc) * fre_num + np.clip(f_ind, 0, fre_num - 1)
    return bucket.astype(np.int32), active


def gabor_apply_host(img: np.ndarray, bucket: np.ndarray,
                     active: np.ndarray, angle_inc: int = 3,
                     fre_num: int = 30) -> np.ndarray:
    """NumPy twin of :func:`gabor_apply_planned` (the same bank, the same
    zero-padded correlation and min-max scaling) for few distinct buckets:
    one FFT correlation per bucket present, then a per-pixel select, f64."""
    from scipy.signal import fftconvolve
    bank2d = get_gabor_filters(angle_inc, fre_num).reshape(-1, KMAX, KMAX)
    img = np.asarray(img, np.float64)
    enh = np.zeros_like(img)
    for b in np.unique(bucket[active]):
        sel = (bucket == b) & active
        kern = bank2d[int(b)][::-1, ::-1]  # correlate == flipped convolve
        conv = fftconvolve(img, kern, mode="same")
        enh[sel] = conv[sel]
    lo, hi = enh.min(), enh.max()
    return ((enh - lo + 1e-4) / (hi - lo + 1e-4) * 255.0).astype(np.float32)


def gabor_filtering_pixel2(img, dir_map, fre_map, mask=None,
                           block_size: int = 16, angle_inc: int = 3,
                           device=None) -> torch.Tensor:
    """Pixelwise Gabor enhancement (filtering.py:136-216) of one image by
    block maps: the 15-px border unfiltered, the result in [0, 255]."""
    if device is None:
        device = img.device if torch.is_tensor(img) else "cpu"
    plan = gabor_plan(dir_map, fre_map, tuple(img.shape), mask=mask,
                      block_size=block_size, angle_inc=angle_inc,
                      device=device)
    return gabor_apply_planned(img, plan)
