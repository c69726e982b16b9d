"""Training-time degradation augmentations.

Counterpart of the JAX package's ``training/augment.py`` (after the
reference implementation's dataflow augments, enhancement_AEC.py:154-180
and minutiae_AEC.py:186-211): an aligned random crop, random brightness
(+/-25), random contrast (x0.5..1.5) and a Gaussian blur with a random odd
kernel of 1..7, applied to the input in raw units while the target stays
clean, then the input normalized to [-1, 1].

Each augment is split into its draws (from a ``torch.Generator``) and an
apply that takes them: ``jax.random``'s keys have no counterpart in torch,
so the same draws can only be handed in. Draw order: crop y0, x0, then
brightness, contrast, kernel index.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

MAX_K = 7


@functools.lru_cache(maxsize=None)
def _gauss_bank(max_k: int = MAX_K) -> np.ndarray:
    """cv2-style kernels for odd sizes 1..max_k, zero-padded to max_k:
    [max_k // 2 + 1, max_k] f32."""
    ks = []
    for size in range(1, max_k + 1, 2):
        sigma = 0.3 * ((size - 1) * 0.5 - 1) + 0.8
        x = np.arange(size) - (size - 1) / 2.0
        k = np.exp(-(x * x) / (2 * sigma * sigma))
        k = k / k.sum()
        pad = (max_k - size) // 2
        ks.append(np.pad(k, (pad, pad)))
    return np.stack(ks).astype(np.float32)


class Draws(NamedTuple):
    y0: int
    x0: int
    brightness: float      # U(0, 1)
    contrast: float        # U(0, 1)
    kernel: int            # index into the kernel bank


def draw(gen: torch.Generator, h: int, w: int, size: int) -> Draws:
    """One pair's draws, in the documented order."""
    y0 = int(torch.randint(0, h - size + 1, (), generator=gen))
    x0 = int(torch.randint(0, w - size + 1, (), generator=gen))
    b, c = torch.rand(2, generator=gen, dtype=torch.float64).tolist()
    k = int(torch.randint(0, len(_gauss_bank()), (), generator=gen))
    return Draws(y0, x0, b, c, k)


def random_crop(img: torch.Tensor, target: torch.Tensor, y0: int, x0: int,
                size: int):
    """Aligned crop of an [H, W, Ci] input and [H, W, Ct] target."""
    return (img[y0:y0 + size, x0:x0 + size],
            target[y0:y0 + size, x0:x0 + size])


def degrade(img: torch.Tensor, brightness: float, contrast: float,
            kernel: int) -> torch.Tensor:
    """Brightness, contrast and the separable blur (edge-replicated
    borders) on an [H, W, 1] image in raw units."""
    img = img + (brightness - 0.5) * 50.0
    img = img * (contrast + 0.5)
    k = torch.as_tensor(_gauss_bank()[kernel], device=img.device)
    pad = (MAX_K - 1) // 2
    x = img[None, None, :, :, 0].to(torch.float32)
    x = F.conv2d(F.pad(x, [0, 0, pad, pad], mode="replicate"),
                 k.view(1, 1, -1, 1))
    x = F.conv2d(F.pad(x, [pad, pad, 0, 0], mode="replicate"),
                 k.view(1, 1, 1, -1))
    return x[0, 0, :, :, None]


def apply_training_pair(img: torch.Tensor, target: torch.Tensor, d: Draws,
                        crop: int = 128):
    """The full augment given its draws: crop, degrade the input,
    normalize it to [-1, 1]."""
    ci, ct = random_crop(img, target, d.y0, d.x0, crop)
    ci = degrade(ci, d.brightness, d.contrast, d.kernel)
    return ci / 128.0 - 1.0, ct


def make_training_pair(gen: torch.Generator, img: torch.Tensor,
                       target: torch.Tensor, crop: int = 128):
    """``apply_training_pair`` with fresh draws from ``gen``."""
    return apply_training_pair(img, target,
                               draw(gen, img.shape[0], img.shape[1], crop),
                               crop)
