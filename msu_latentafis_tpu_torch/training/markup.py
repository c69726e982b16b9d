"""Minutiae markup -> training tensors.

Counterpart of the JAX package's ``training/markup.py``. The reference
implementation's per-dataset converters (prepare_data.py:475-718) all read
an image and its minutiae markup, rasterize the 12-channel minutiae
cylinder and write ``[img, ROI, cylinder]`` as the ``.npy`` the AEC
trainers read (minutiae_AEC.py:495-502); here one format-agnostic function,
plus the 90-degree rotation augmentation (prepare_data.py:581-601, :669;
coordinates rotated about the image, orientation shifted by the angle,
:146-153). Images are read by ``training.datasets.imread``; ``.mat``
markup by scipy's ``loadmat``.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .datasets import imread
from .synthetic_data import cylinder_target_np


def parse_markup(path: str) -> np.ndarray:
    """A minutiae markup file -> [N, 3] f32 (x, y, ori in radians).

    - text / CSV: one ``x y ori`` (or ``x,y,ori``) row per minutia, extra
      columns ignored, ``#`` comments and unparsable lines skipped;
    - MATLAB ``.mat``: the first variable that is an [N, >=3] numeric
      array (the Kai markup layout, prepare_data.py:475-529).
    """
    if path.endswith(".mat"):
        from scipy.io import loadmat
        data = loadmat(path)
        for key, val in data.items():
            if key.startswith("__"):
                continue
            arr = np.asarray(val, np.float64)
            if arr.ndim == 2 and arr.shape[1] >= 3:
                return np.ascontiguousarray(arr[:, :3], np.float32)
        raise ValueError(f"no [N,>=3] minutiae array found in {path}")
    rows: List[List[float]] = []
    with open(path) as f:
        for line in f:
            line = line.strip().replace(",", " ")
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 3:
                continue
            try:
                rows.append([float(parts[0]), float(parts[1]),
                             float(parts[2])])
            except ValueError:
                continue  # header line
    return np.asarray(rows, np.float32).reshape(-1, 3)


def rotate_sample(img: np.ndarray, minutiae: np.ndarray,
                  roi: Optional[np.ndarray], k: int
                  ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """An (image, minutiae, ROI) sample rotated by ``k * 90`` degrees
    counter-clockwise: pixels by ``np.rot90`` (exact), coordinates about
    the image, orientations less k pi / 2 (mod 2 pi)."""
    k = k % 4
    if k == 0:
        return img, minutiae.copy(), roi
    h, w = img.shape[:2]
    out_img = np.rot90(img, k)
    out_roi = np.rot90(roi, k) if roi is not None else None
    m = minutiae.copy()
    x, y = m[:, 0].copy(), m[:, 1].copy()
    # one CCW step: (x, y) -> (y, w - 1 - x) in the new [w, h] frame
    for _ in range(k):
        x, y = y, (w - 1) - x
        h, w = w, h
    m[:, 0], m[:, 1] = x, y
    # y-down image coordinates: a CCW step maps (dx, dy) -> (dy, -dx)
    m[:, 2] = np.mod(m[:, 2] - k * np.pi / 2.0, 2.0 * np.pi)
    return out_img, m, out_roi


def build_training_tensor(img: np.ndarray, minutiae: np.ndarray,
                          roi: Optional[np.ndarray] = None,
                          num_ori: int = 12) -> np.ndarray:
    """[H, W] image + [N, 3] minutiae -> [H, W, 2 + num_ori] f32
    ``concat(img, ROI, cylinder)`` (minutiae_AEC.py:130-141); the ROI is
    255 everywhere when none is given."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    if roi is None:
        roi = np.full((h, w), 255.0, np.float32)
    cyl = cylinder_target_np(np.asarray(minutiae, np.float32), h, w,
                             num_ori=num_ori)
    return np.concatenate([img[..., None], np.asarray(roi, np.float32)
                           [..., None], np.asarray(cyl, np.float32)],
                          axis=-1)


def convert_markup_dataset(pairs: Sequence[Tuple[str, str]], out_dir: str,
                           rotate_augment: bool = False,
                           roi_from_markup_hull: bool = False,
                           num_ori: int = 12) -> List[str]:
    """(image path, markup path) pairs -> training ``.npy`` tensors (four
    rotations each with ``rotate_augment``). Returns the files, existing
    ones skipped (resume by skip)."""
    os.makedirs(out_dir, exist_ok=True)
    written: List[str] = []
    for img_path, markup_path in pairs:
        base = os.path.splitext(os.path.basename(img_path))[0]
        img = np.asarray(imread(img_path), np.float64)
        if img.ndim == 3:
            img = img @ np.array([0.299, 0.587, 0.114])
        minutiae = parse_markup(markup_path)
        roi = None
        if roi_from_markup_hull and len(minutiae) >= 3:
            roi = _hull_roi(img.shape[0], img.shape[1], minutiae)
        ks = range(4) if rotate_augment else range(1)
        for k in ks:
            out = os.path.join(out_dir, f"{base}_rot{k * 90}.npy"
                               if rotate_augment else f"{base}.npy")
            if os.path.exists(out):
                written.append(out)
                continue
            im_k, mn_k, roi_k = rotate_sample(img, minutiae, roi, k)
            np.save(out, build_training_tensor(im_k, mn_k, roi_k,
                                               num_ori=num_ori))
            written.append(out)
    return written


def _hull_roi(h: int, w: int, minutiae: np.ndarray,
              margin: int = 24) -> np.ndarray:
    """The markup's bounding box (+ margin px) as the ROI."""
    x0 = max(0, int(minutiae[:, 0].min()) - margin)
    x1 = min(w, int(minutiae[:, 0].max()) + margin + 1)
    y0 = max(0, int(minutiae[:, 1].min()) - margin)
    y1 = min(h, int(minutiae[:, 1].max()) + margin + 1)
    roi = np.zeros((h, w), np.float32)
    roi[y0:y1, x0:x1] = 255.0
    return roi
