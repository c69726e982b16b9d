"""Separable Gaussian blurs with cv2 / scipy.ndimage semantics.

Counterpart of the JAX package's ``ops/gaussian.py``. The reference mixes
cv2.GaussianBlur (reflect-101 borders, kernel size given) and
scipy / skimage Gaussian filtering (symmetric borders, radius
int(truncate * sigma + 0.5)). Each pass pads one axis explicitly and runs a
1-D convolution along it (``conv2d`` with a [K, 1] or [1, K] kernel) in f32.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.precision import f32_compute


def _cv2_kernel(ksize: int, sigma: float) -> np.ndarray:
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _ndimage_kernel(sigma: float, truncate: float = 4.0) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _pad_index(n: int, pad: int, mode: str) -> np.ndarray:
    """Source index of each padded position: numpy's ``mode`` ("reflect"
    is cv2's reflect-101, "symmetric" repeats the edge, "edge" clamps)."""
    return np.pad(np.arange(n), pad, mode=mode)


def pad_axis(img: torch.Tensor, pad: int, mode: str, dim: int) -> torch.Tensor:
    """``np.pad(img, pad, mode)`` along one dim (any pad width)."""
    if pad == 0:
        return img
    idx = torch.as_tensor(_pad_index(img.shape[dim], pad, mode),
                          device=img.device)
    return img.index_select(dim, idx)


def pad2d(img: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    """``np.pad`` of the last two dims by ``pad``."""
    return pad_axis(pad_axis(img, pad, mode, -2), pad, mode, -1)


def sep_filter(img: torch.Tensor, k: np.ndarray, pad_mode: str) -> torch.Tensor:
    """Separable 2-D convolution of [..., H, W] with the 1-D kernel ``k``
    (rows then columns, each padded by ``pad_mode``), as the JAX package's
    ``jnp.convolve(..., mode="valid")`` over each column and then row."""
    pad = (len(k) - 1) // 2
    kt = torch.as_tensor(np.ascontiguousarray(k[::-1]), dtype=torch.float32,
                         device=img.device)
    shape = img.shape
    x = img.reshape(-1, 1, *shape[-2:]).to(torch.float32)
    with f32_compute():
        x = F.conv2d(pad_axis(x, pad, pad_mode, -2), kt.view(1, 1, -1, 1))
        x = F.conv2d(pad_axis(x, pad, pad_mode, -1), kt.view(1, 1, 1, -1))
    return x.reshape(shape)


def gaussian_blur_cv2(img: torch.Tensor, ksize: int,
                      sigma: float = 0.0) -> torch.Tensor:
    """cv2.GaussianBlur(img, (ksize, ksize), sigma): reflect-101 borders."""
    return sep_filter(img, _cv2_kernel(ksize, sigma), "reflect")


def gaussian_blur_reflect(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """scipy.ndimage.gaussian_filter(img, sigma, mode='reflect') (skimage's
    ``gaussian(..., mode='reflect')``, smooth_dir_map's): symmetric
    borders."""
    return sep_filter(img, _ndimage_kernel(sigma), "symmetric")
