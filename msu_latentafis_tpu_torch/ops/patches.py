"""Minutiae-aligned patch extraction for the descriptor nets.

Counterpart of the JAX package's ``ops/patches.py`` (reference:
descriptor.py:37-160): 64 precomputed rotation grids over a 160x160
window; per minutia the grid nearest to -ori rotates the neighborhood, one
of 14 crop types selects a sub-window, and a crop smaller than 96x96 is
resized (cv2 INTER_LINEAR). ``extract_patches`` is the host path; for the
96x96 crop types a packed index table (grid offsets into an edge-padded
image) gathers every patch type of a batch of minutiae in one indexing of
the image on its device.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch

PATCH_WINDOW = 160
ORI_NUM = 64
PATCH_PAD = 128     # > max |rotated grid offset| (114 at 160-px windows)

# crop ranges per patch type (descriptor.py:37-82): (x_range, y_range)
_PATCH_LOCATIONS: Dict[int, Tuple[Tuple[int, int], Tuple[int, int]]] = {
    1: ((40, 120), (40, 120)),
    2: ((32, 128), (32, 128)),
    3: ((24, 136), (24, 136)),
    4: ((16, 144), (16, 144)),
    5: ((8, 152), (8, 152)),
    6: ((0, 160), (0, 160)),
    7: ((0, 96), (0, 96)),
    8: ((32, 128), (0, 96)),
    9: ((64, 160), (0, 96)),
    10: ((64, 160), (32, 128)),
    11: ((64, 160), (64, 160)),
    12: ((32, 128), (64, 160)),
    13: ((1, 96), (64, 160)),
    14: ((1, 96), (32, 128)),
}


@functools.lru_cache(maxsize=2)
def get_patch_index(patch_size: int = PATCH_WINDOW, ori_num: int = ORI_NUM,
                    is_minu: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Rotation grids [ori_num, P, P] (x and y offsets), rounded to ints
    (descriptor.py:85-107)."""
    pi2 = 2 * math.pi if is_minu else math.pi
    coords = np.arange(-patch_size // 2 + 1, patch_size // 2 + 1)
    xv, yv = np.meshgrid(coords, coords)
    xs, ys = [], []
    for i in range(ori_num):
        th = i * pi2 / ori_num
        xs.append(np.around(xv * np.cos(th) - yv * np.sin(th)))
        ys.append(np.around(xv * np.sin(th) + yv * np.cos(th)))
    return np.asarray(xs, np.int32), np.asarray(ys, np.int32)


def _bilinear_resize(patches: np.ndarray, out: int) -> np.ndarray:
    """cv2.INTER_LINEAR-compatible resize of [N, H, W] -> [N, out, out]."""
    n, h, w = patches.shape
    sy, sx = h / out, w / out
    fy = (np.arange(out) + 0.5) * sy - 0.5
    fx = (np.arange(out) + 0.5) * sx - 0.5
    y0 = np.clip(np.floor(fy).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(fx).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(fy - y0, 0, 1).astype(np.float32)
    wx = np.clip(fx - x0, 0, 1).astype(np.float32)
    a = patches[:, y0][:, :, x0]
    b = patches[:, y0][:, :, x1]
    c = patches[:, y1][:, :, x0]
    d = patches[:, y1][:, :, x1]
    top = a * (1 - wx)[None, None, :] + b * wx[None, None, :]
    bot = c * (1 - wx)[None, None, :] + d * wx[None, None, :]
    return top * (1 - wy)[None, :, None] + bot * wy[None, :, None]


def orientation_index(minutiae: np.ndarray) -> np.ndarray:
    """The rotation grid nearest to -ori of each minutia."""
    ori = (-np.asarray(minutiae)[:, 2]) % (2 * math.pi)
    return np.round(ori / (2 * math.pi) * ORI_NUM).astype(np.int64) % ORI_NUM


def needs_resize(patch_type: int) -> bool:
    (xa, xb), (ya, yb) = _PATCH_LOCATIONS[patch_type]
    return xb - xa != 96 or yb - ya != 96


@functools.lru_cache(maxsize=8)
def device_patch_index_table(patch_types: Tuple[int, ...], wp: int,
                             device: str = "cpu") -> torch.Tensor:
    """Packed rotation-grid table [T, ORI_NUM, 96, 96] (int64 on
    ``device``) of ``gy * wp + gx`` into an image edge-padded by PATCH_PAD
    to width ``wp``: sampling that image at unclipped offsets is the host
    path's clipping of x, then y, exactly. 96x96 crop types only."""
    gx, gy = get_patch_index()
    tabs = []
    for pt in patch_types:
        if needs_resize(pt):
            raise ValueError(f"patch type {pt} needs a resize; use the host "
                             f"path")
        (xa, xb), (ya, yb) = _PATCH_LOCATIONS[pt]
        tabs.append(gy[:, ya:yb, xa:xb].astype(np.int64) * wp
                    + gx[:, ya:yb, xa:xb])
    return torch.as_tensor(np.stack(tabs), device=device)


def gather_patches_device_packed(flat: torch.Tensor, wp: int, pad: int,
                                 xb: torch.Tensor, yb: torch.Tensor,
                                 ori_ind: torch.Tensor,
                                 table: torch.Tensor) -> torch.Tensor:
    """Patches [I, T, B, 96, 96] of an edge-padded image stack ``flat``
    [I, hp * wp] at minutiae (xb, yb, ori_ind) [B]: one indexing."""
    base = (yb + pad) * wp + (xb + pad)                     # [B]
    return flat[:, table[:, ori_ind] + base[None, :, None, None]]


def extract_patches(minutiae: np.ndarray, img, patch_type: int = 1,
                    patch_size: int = 96) -> np.ndarray:
    """Aligned patches [N, patch_size, patch_size] for all minutiae, on the
    host (descriptor.extract_patches, :118-160): per minutia the nearest of
    64 rotation grids by -ori, a clamped gather, the crop of the patch
    type, and a bilinear resize when it is smaller than patch_size."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    gx, gy = get_patch_index()
    m = np.asarray(minutiae)
    ori_ind = orientation_index(m)
    (xa, xb), (ya, yb) = _PATCH_LOCATIONS[patch_type]
    gx_c = gx[:, ya:yb, xa:xb]
    gy_c = gy[:, ya:yb, xa:xb]
    xv = np.clip(gx_c[ori_ind] + m[:, 0].astype(np.int64)[:, None, None],
                 0, w - 1)
    yv = np.clip(gy_c[ori_ind] + m[:, 1].astype(np.int64)[:, None, None],
                 0, h - 1)
    patches = img[yv, xv]
    if patches.shape[1] != patch_size:
        patches = _bilinear_resize(patches, patch_size)
    return patches
