"""FFT-domain preprocessing: the cartoon-texture decomposition.

Counterpart of the JAX package's ``ops/fft.py``, its rolled half:
``FastCartoonTexture`` (preprocessing.py:129-172) -- a Butterworth
low-pass in radius^4, gradient-norm weighting, the texture residual
clipped to [0, 255] around +/-20 -- and the block extraction the maps
share. The filter runs through ``torch.fft`` with the same fftshift
semantics (the JAX package's DFT-as-matmul form exists because the TPU's
FFT was slow), the blocks through ``unfold``. ``stft_enhance`` and
``overlap_add`` belong to the latent path.
"""
from __future__ import annotations

import math

import numpy as np
import torch

BLOCK = 16
PATCH = 64


def _nextpow2(x: int) -> int:
    return int(math.ceil(math.log2(x)))


def lowpass_filter(img: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """Zero-pad to L's shape, multiply the spectrum by the (fftshifted,
    real) filter L, transform back and crop (preprocessing.py:62-76)."""
    h, w = img.shape
    h2, w2 = L.shape
    padded = torch.nn.functional.pad(img, [0, w2 - w, 0, h2 - h])
    spec = torch.fft.fft2(padded) * torch.fft.ifftshift(L)
    return torch.fft.ifft2(spec).real[:h, :w]


def gradient_norm(img: torch.Tensor) -> torch.Tensor:
    gy, gx = torch.gradient(img)
    return torch.sqrt(gx * gx + gy * gy) + 1e-6


def fast_cartoon_texture(img: torch.Tensor, sigma: float = 2.5) -> torch.Tensor:
    """Texture component of the cartoon + texture decomposition."""
    img = img.to(torch.float32)
    h, w = img.shape
    n = max(2 ** _nextpow2(h), 2 ** _nextpow2(w))
    half = n // 2
    x, y = np.meshgrid(np.arange(-half, half), np.arange(-half, half))
    r = (np.sqrt(x * x + y * y) + 1e-4) / n
    L = torch.as_tensor((1.0 / (1.0 + (2 * np.pi * r * sigma) ** 4))
                        .astype(np.float32), device=img.device)

    img_low = lowpass_filter(img, L)
    g1 = lowpass_filter(gradient_norm(img), L)
    g2 = lowpass_filter(gradient_norm(img_low), L)

    diff = g1 - g2
    ar1 = g1.abs()
    big = ar1 > 1
    diff = torch.where(big, diff / torch.where(big, ar1, 1.0), 0.0)

    cmin, cmax = 0.3, 0.7
    weight = (diff - cmin) / (cmax - cmin)
    weight = torch.where(diff < cmin, 0.0, weight)
    weight = torch.where(diff > cmax, 1.0, weight)

    u = weight * img_low + (1.0 - weight) * img
    temp = img - u
    lim = 20.0
    return torch.clamp((temp + lim) * 255.0 / (2 * lim), 0.0, 255.0)


def extract_blocks(img: torch.Tensor, patch: int = PATCH,
                   stride: int = BLOCK, inclusive: bool = True):
    """[H, W] -> (patches [bh * bw, patch, patch], bh, bw) at the stride.

    ``inclusive=False`` gives preprocessing.STFT's block count
    (h - patch) // stride, which drops the last fitting block;
    ``inclusive=True`` the (h - patch) // stride + 1 of get_maps."""
    h, w = img.shape
    bh = (h - patch) // stride + (1 if inclusive else 0)
    bw = (w - patch) // stride + (1 if inclusive else 0)
    blocks = img.unfold(0, patch, stride).unfold(1, patch, stride)
    return blocks[:bh, :bw].reshape(bh * bw, patch, patch), bh, bw
