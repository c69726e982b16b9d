"""Minutiae-cylinder ground truth (training targets).

Counterpart of the JAX package's ``ops/cylinder.py`` (after the reference
implementation's prepare_data.py:91-241): every minutia splats a spatial
Gaussian (sigma^2 = 25) into 12 orientation channels with angular falloff
exp(-6 dtheta / pi); channel j lies at 2 pi j / 12. One broadcast over
[N, H, W] x [N, C], summed over the minutiae.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def minutiae_cylinder(minutiae: torch.Tensor, valid: torch.Tensor, h: int,
                      w: int, num_ori: int = 12) -> torch.Tensor:
    """[N, 3+] minutiae (x, y, ori) and a [N] validity mask -> the
    [h, w, num_ori] cylinder on their device. An orientation below 0 or
    above 2 pi is wrapped once; a minutia with x or y below 0 adds
    nothing."""
    sigma2 = 25.0
    two_pi = 2 * math.pi
    minutiae = minutiae.to(torch.float32)
    xs, ys, ori = minutiae[:, 0], minutiae[:, 1], minutiae[:, 2]
    ori = torch.where(ori < 0, ori + two_pi, ori)
    ori = torch.where(ori > two_pi, ori - two_pi, ori)

    dev = minutiae.device
    Y = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    X = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    d2 = (X[None] - xs[:, None, None]) ** 2 \
        + (Y[None] - ys[:, None, None]) ** 2
    spatial = torch.exp(-d2 / sigma2)                      # [N, h, w]
    in_img = valid & (xs >= 0) & (ys >= 0)
    spatial = torch.where(in_img[:, None, None], spatial, 0.0)

    ch = torch.arange(num_ori, device=dev, dtype=torch.float32) \
        * two_pi / num_ori
    od = (ori[:, None] - ch[None, :]).abs()
    od = torch.where(od > two_pi, od - two_pi, od)
    od = torch.minimum(od, two_pi - od)
    ang = torch.exp(-od / math.pi * 6.0)                   # [N, C]
    return torch.einsum("nhw,nc->hwc", spatial, ang)


def make_cylinder_target(minutiae: np.ndarray, h: int, w: int,
                         num_ori: int = 12, max_minutiae: int = 256,
                         device="cpu") -> np.ndarray:
    """The cylinder of the first ``max_minutiae`` rows of a [N, 3+]
    minutiae array, computed on ``device``; -> numpy [h, w, num_ori]."""
    m = np.zeros((max_minutiae, 3), np.float32)
    n = min(len(minutiae), max_minutiae)
    if n:
        m[:n] = np.asarray(minutiae)[:n, :3]
    valid = torch.arange(max_minutiae, device=device) < n
    return minutiae_cylinder(torch.as_tensor(m, device=device), valid, h, w,
                             num_ori).cpu().numpy()
