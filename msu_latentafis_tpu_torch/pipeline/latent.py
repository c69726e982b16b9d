"""Latent feature extraction: for now the image-size helper the rolled path
shares (the JAX package's ``pipeline/latent.py:38-40``); the latent
orchestrator comes with the latent slice."""
from __future__ import annotations

import numpy as np

BLOCK = 16


def adjust_image_size(img: np.ndarray, block_size: int = BLOCK) -> np.ndarray:
    """Crop to whole blocks."""
    h, w = img.shape[:2]
    return img[: (h // block_size) * block_size,
               : (w // block_size) * block_size]
