"""FFT-domain preprocessing: cartoon-texture decomposition and STFT
block enhancement.

Counterpart of the JAX package's ``ops/fft.py``:
- ``FastCartoonTexture`` (preprocessing.py:129-172): a Butterworth
  low-pass in radius^4, gradient-norm weighting, the texture residual
  clipped to [0, 255] around +/-20;
- ``STFT`` enhancement (preprocessing.py:175-226): 64 x 64 patches at
  stride 16, median subtraction, a ring band-pass for ridge spacings of
  3 to 18 px, energy normalization, Gaussian-window overlap-add, the
  output renormalized to about N(127, 14).
The transforms run through ``torch.fft`` (the JAX package's DFT-as-matmul
form exists because the TPU's FFT was slow), the blocks through
``unfold`` and the overlap-add through ``fold``. ``median`` is
``jnp.median``: the mean of the two middle values of an even count.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

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


def median(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """``jnp.median`` along ``dim``: for an even count the mean of the two
    middle values, as 0.5 lo + 0.5 hi (``torch.median`` returns lo)."""
    s = torch.sort(x, dim=dim).values
    n = x.shape[dim]
    m = s.narrow(dim, (n - 1) // 2, 1) * 0.5 + s.narrow(dim, n // 2, 1) * 0.5
    return m if keepdim else m.squeeze(dim)


def overlap_add(patches: torch.Tensor, h: int, w: int, bh: int, bw: int,
                stride: int = BLOCK) -> torch.Tensor:
    """Overlap-add [..., bh * bw, P, P] patches (row-major block order) onto
    [..., h, w] canvases; the blocks must fit."""
    lead = patches.shape[:-3]
    p = patches.shape[-1]
    cols = patches.reshape(-1, bh * bw, p * p).transpose(1, 2)
    oh, ow = (bh - 1) * stride + p, (bw - 1) * stride + p
    out = F.fold(cols, (oh, ow), p, stride=stride)[:, 0]
    out = F.pad(out, [0, w - ow, 0, h - oh])
    return out.reshape(*lead, h, w)


def _bandpass(patch_size: int) -> np.ndarray:
    half = patch_size // 2
    x, y = np.meshgrid(np.arange(-half, half), np.arange(-half, half))
    r = np.sqrt(x * x + y * y) + 1e-4
    f_low = patch_size / 18.0   # RMAX
    f_high = patch_size / 3.0   # RMIN
    return (1.0 / (1 + (r / f_high) ** 4)) * (1.0 / (1 + (f_low / r) ** 4))


def _stft_tables(device) -> tuple:
    """(the band-pass, unshifted; the Gaussian window), f32 [64, 64]."""
    half = PATCH // 2
    x, y = np.meshgrid(np.arange(-half, half), np.arange(-half, half))
    sigma = PATCH / 3.0
    weight = np.exp(-(x * x + y * y) / (sigma * sigma)).astype(np.float32)
    band = np.fft.ifftshift(_bandpass(PATCH).astype(np.float32))
    return (torch.as_tensor(band, device=device),
            torch.as_tensor(weight, device=device))


def stft_patches(imgs: torch.Tensor):
    """The windowed reconstructions of the block STFT filtering of padded
    images [N, H, W]: every 64 x 64 patch (preprocessing.STFT's count,
    the last fitting block dropped) less its median, band-passed, its
    spectrum scaled to unit energy (over the full spectrum), transformed
    back and windowed. -> ([N, bh * bw, 64, 64], bh, bw)."""
    n_img, h, w = imgs.shape
    band, weight = _stft_tables(imgs.device)
    bh, bw = (h - PATCH) // BLOCK, (w - PATCH) // BLOCK
    p = imgs.unfold(1, PATCH, BLOCK).unfold(2, PATCH, BLOCK)[:, :bh, :bw]
    p = p.reshape(n_img, bh * bw, PATCH, PATCH)
    p = p - median(p.reshape(n_img, bh * bw, -1), dim=-1)[..., None, None]
    spec = torch.fft.fft2(p) * band
    norm = torch.sqrt((spec.real.square() + spec.imag.square())
                      .sum(dim=(-2, -1)))
    spec = spec * (1.0 / (norm + 1e-4))[..., None, None]
    return torch.fft.ifft2(spec).real * weight, bh, bw


def _stft_core(imgs: torch.Tensor) -> torch.Tensor:
    """The block STFT filtering of padded images [N, H, W], overlap-added
    onto [N, H, W]."""
    rec, bh, bw = stft_patches(imgs)
    return overlap_add(rec, imgs.shape[-2], imgs.shape[-1], bh, bw)


def stft_normalize(rec: torch.Tensor) -> torch.Tensor:
    """Each [..., H, W] image less its median, over its population std
    (``jnp.std``), to N(127, 14), clipped to [0, 255]."""
    flat = rec.reshape(*rec.shape[:-2], -1)
    med = median(flat, dim=-1)[..., None, None]
    std = flat.std(dim=-1, correction=0)[..., None, None]
    return torch.clamp((rec - med) / (std + 1e-6) * 14.0 + 127.0, 0.0, 255.0)


def stft_enhance_batch(imgs: torch.Tensor) -> torch.Tensor:
    """STFT block enhancement of a batch [N, H, W] (H, W multiples of 16;
    the latent path's three variants of one image) in one pass."""
    imgs = torch.as_tensor(imgs, dtype=torch.float32)
    h0, w0 = imgs.shape[-2:]
    ovp = (PATCH - BLOCK) // 2
    rec = _stft_core(F.pad(imgs, [ovp, ovp, ovp, ovp]))
    return stft_normalize(rec[:, ovp:ovp + h0, ovp:ovp + w0])


def stft_enhance(img: torch.Tensor) -> torch.Tensor:
    """STFT block enhancement of a [H, W] image (H, W multiples of 16)."""
    return stft_enhance_batch(torch.as_tensor(img)[None])[0]
