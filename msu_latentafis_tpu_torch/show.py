"""Visualization / debug overlays.

Counterpart of the JAX package's ``show.py`` (after the reference
implementation's show.py:11-197): mask, minutiae-set and orientation-field
overlays saved as images (matplotlib's Agg backend, no display).
matplotlib is imported when a figure is drawn, not with this module: the
card's machine has none, and nothing else of the port needs it.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def show_mask(mask: np.ndarray, img: Optional[np.ndarray] = None,
              fname: Optional[str] = None) -> None:
    plt = _plt()
    fig, ax = plt.subplots(1)
    if img is not None:
        ax.imshow(img, cmap="gray")
        ax.imshow(np.ma.masked_where(mask > 0, np.ones_like(mask)),
                  alpha=0.4, cmap="autumn")
    else:
        ax.imshow(mask, cmap="gray")
    ax.axis("off")
    if fname:
        fig.savefig(fname, dpi=150, bbox_inches="tight")
    plt.close(fig)


def show_image(img: np.ndarray, mask: Optional[np.ndarray] = None,
               fname: Optional[str] = None) -> None:
    """Plain grayscale dump with an optional mask contour
    (show.py:43-63)."""
    plt = _plt()
    fig, ax = plt.subplots(1)
    ax.imshow(img, cmap="gray")
    if mask is not None:
        ax.contour(mask, [0.5], colors="orange", linewidths=0.8)
    ax.axis("off")
    if fname:
        fig.savefig(fname, dpi=150, bbox_inches="tight")
    plt.close(fig)


def show_minutiae(img: np.ndarray, minutiae: np.ndarray,
                  mask: Optional[np.ndarray] = None,
                  fname: Optional[str] = None) -> None:
    """Single-set overlay (show.py:66-98)."""
    show_minutiae_sets(img, [np.asarray(minutiae)], mask=mask, fname=fname)


def show_minutiae_sets(img: np.ndarray, minutiae_sets: Sequence[np.ndarray],
                       mask: Optional[np.ndarray] = None,
                       fname: Optional[str] = None,
                       arrow_len: float = 15.0, r: float = 10.0) -> None:
    """Overlay one or more minutiae sets (circle + orientation arrow per
    point, one color per set)."""
    plt = _plt()
    colors = ["r", "b", "g", "y", "m", "c"]
    fig, ax = plt.subplots(1)
    ax.set_aspect("equal")
    ax.imshow(img, cmap="gray")
    if mask is not None:
        ax.contour(mask, [0.5], colors="orange", linewidths=0.8)
    for si, mnt in enumerate(minutiae_sets):
        color = colors[si % len(colors)]
        for m in np.asarray(mnt).reshape(-1, np.asarray(mnt).shape[-1]) if len(mnt) else []:
            x, y = m[0], m[1]
            ax.add_patch(plt.Circle((x, y), r, color=color, fill=False,
                                    linewidth=0.8))
            ori = -m[2]
            ax.arrow(x, y, math.cos(ori) * arrow_len, math.sin(ori) * arrow_len,
                     head_width=2, head_length=3, fc=color, ec=color,
                     linewidth=0.8)
    ax.axis("off")
    if fname:
        fig.savefig(fname, dpi=150, bbox_inches="tight")
    plt.close(fig)


def show_orientation_field(img: np.ndarray, dir_map: np.ndarray,
                           mask: Optional[np.ndarray] = None,
                           block_size: int = 16,
                           fname: Optional[str] = None) -> None:
    """Line-segment orientation field overlay at block resolution."""
    plt = _plt()
    fig, ax = plt.subplots(1)
    ax.imshow(img, cmap="gray")
    blkH, blkW = dir_map.shape
    half = block_size * 0.45
    for i in range(blkH):
        for j in range(blkW):
            if mask is not None:
                y, x = i * block_size + block_size // 2, j * block_size + block_size // 2
                if y >= mask.shape[0] or x >= mask.shape[1] or mask[y, x] == 0:
                    continue
            theta = dir_map[i, j]
            if theta < -5:       # -10 marks background blocks
                continue
            cx = j * block_size + block_size / 2
            cy = i * block_size + block_size / 2
            dx, dy = half * math.cos(theta), half * math.sin(theta)
            ax.plot([cx - dx, cx + dx], [cy - dy, cy + dy], "r-", linewidth=0.8)
    ax.axis("off")
    if fname:
        fig.savefig(fname, dpi=150, bbox_inches="tight")
    plt.close(fig)
