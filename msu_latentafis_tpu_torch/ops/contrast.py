"""Local contrast normalization (preprocessing.py:31-59).

Counterpart of the JAX package's ``ops/contrast.py``: box (15x15) and
Gaussian variants of mean / absolute-deviation normalization mapped to
[0, 255], with reflect-101 borders (cv2's default).
"""
from __future__ import annotations

import numpy as np
import torch

from .gaussian import sep_filter


def _box_kernel(n: int) -> np.ndarray:
    return np.full((n,), 1.0 / n, np.float32)


def _gauss_kernel(ksize: int) -> np.ndarray:
    """cv2.getGaussianKernel: sigma = 0.3 ((ksize - 1) 0.5 - 1) + 0.8."""
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _normalize(img: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    img = img.to(torch.float32)
    centered = img - sep_filter(img, k, "reflect")
    dev = sep_filter(centered.abs(), k, "reflect")
    out = torch.clamp(centered / (dev + 10.0) * 0.75, -1.0, 1.0)
    return (out + 1.0) * 127.5


def local_contrast_enhancement(img: torch.Tensor,
                               ksize: int = 15) -> torch.Tensor:
    """Box mean / abs-dev normalization (preprocessing.py:31-44)."""
    return _normalize(img, _box_kernel(ksize))


def local_contrast_enhancement_gaussian(img: torch.Tensor,
                                        ksize: int = 15) -> torch.Tensor:
    """Gaussian-window variant (preprocessing.py:47-59); the reference
    passes 15 as the cv2 kernel size, with the automatic sigma."""
    return _normalize(img, _gauss_kernel(ksize))
