"""Minutiae decoding and refinement.

Counterpart of the JAX package's ``ops/minutiae.py`` (reference:
prepare_data.py:244-350 and :446-472, minutiae_AEC.py:90-118,
extraction_latent.py:219-278):
- cylinder -> points: per-pixel channel argmax, strict 8-neighbor spatial
  NMS, quadratic sub-bin orientation interpolation, on the heatmap's
  device; candidates ranked by confidence, the lower pixel index first on
  equal confidence (as ``jax.lax.top_k``: a stable descending sort);
- pairwise refinement, the crowding filter, mask-border removal and
  cross-set consensus voting on the host, on the short decoded list.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from scipy.spatial.distance import cdist


def decode_cylinder(cylinder: torch.Tensor, thr: float,
                    max_minutiae: int = 1000):
    """12-channel minutiae cylinder [H, W, C] -> (minutiae [k, 4] =
    (x, y, ori, conf) by confidence, descending, and the count n of valid
    rows), get_minutiae_from_cylinder2 (prepare_data.py:302-350): strict
    local maxima of the channel max above ``thr`` and 7 px inside the
    border, orientation ``pred = 0.5 (y3 - 4 y2) / (y3 - 2 y2)`` around the
    argmax channel, refined confidence. Rows past n are not meaningful."""
    cylinder = torch.as_tensor(cylinder, dtype=torch.float32)
    h, w, c = cylinder.shape
    max_val = cylinder.amax(dim=2)
    max_arg = torch.argmax(cylinder, dim=2)      # the first maximum

    p = torch.nn.functional.pad(max_val, [1, 1, 1, 1], value=math.inf)
    is_peak = torch.ones_like(max_val, dtype=torch.bool)
    for dy in range(3):
        for dx in range(3):
            if dy != 1 or dx != 1:
                is_peak &= max_val > p[dy:dy + h, dx:dx + w]

    r2 = 7  # r = 15, r2 = r // 2 border exclusion (prepare_data.py:318-321)
    interior = torch.zeros_like(is_peak)
    interior[r2:h - r2, r2:w - r2] = True
    cand = is_peak & (max_val > thr) & interior

    ind1 = (max_arg - 1) % c
    ind2 = (max_arg + 1) % c
    gather = lambda i: cylinder.gather(2, i[..., None])[..., 0]  # noqa: E731
    y1 = gather(ind1)
    y2 = gather(max_arg) - y1
    y3 = gather(ind2) - y1
    denom = y3 - 2 * y2
    pred = 0.5 * (y3 - 4 * y2) / torch.where(denom.abs() > 1e-12, denom,
                                             1e-12)
    conf = -(2 * y2 - 0.5 * y3) ** 2 / torch.where(
        (2 * denom).abs() > 1e-12, 2 * denom, 1e-12) + max_val
    ori = (ind1 + pred) / c * 2 * math.pi

    idx = torch.nonzero(cand.reshape(-1))[:, 0]        # ascending
    score = conf.reshape(-1)[idx]
    order = torch.sort(score, descending=True, stable=True).indices
    top = idx[order[:max_minutiae]]
    n = int((score[order[:max_minutiae]] > -math.inf).sum())
    minutiae = torch.stack([(top % w).to(torch.float32),
                            (top // w).to(torch.float32),
                            ori.reshape(-1)[top].to(torch.float32),
                            conf.reshape(-1)[top]], dim=1)
    return minutiae, n


def refine_minutiae(minutiae: np.ndarray, dist_thr: float = 10,
                    ori_dist: float = np.pi / 4) -> np.ndarray:
    """Pairwise suppression (prepare_data.py:446-472): for i < j, drop j if
    closer than dist_thr, or within 20 px with a similar orientation. The
    reference never checks flag[i] (a dropped minutia still suppresses
    later ones), so j survives iff no earlier i triggers either rule."""
    n = len(minutiae)
    if n == 0:
        return minutiae
    d = cdist(minutiae[:, :2], minutiae[:, :2])
    od = np.abs(minutiae[:, 2][None, :] - minutiae[:, 2][:, None])
    od = np.minimum(od, 2 * np.pi - od)
    sup = (d < dist_thr) | ((d < 20) & (od < ori_dist))
    sup = np.triu(sup, 1)                  # only i < j suppresses j
    return minutiae[~sup.any(axis=0)]


def remove_crowded_minutiae(minutiae: np.ndarray) -> np.ndarray:
    """Crowding filter (minutiae_AEC.py:90-118): drop points whose 3
    nearest neighbors average < 12 px away or 5 nearest < 25 px; both of a
    pair closer than 5 px go."""
    if minutiae is None or len(minutiae) == 0:
        return np.zeros((0, 4))
    minutiae = np.asarray(minutiae)
    n = len(minutiae)
    if n < 3:
        return minutiae
    d = cdist(minutiae[:, :2], minutiae[:, :2])
    ds = np.sort(d, axis=1)                       # ds[:, 0] == 0 (self)
    nn = np.argsort(d, axis=1)[:, 1]
    flag = np.ones(n, bool)
    pair = ds[:, 1] < 5
    flag[pair] = False
    flag[nn[pair]] = False
    mean3 = ds[:, 1:4].mean(axis=1)
    flag &= ~(~pair & (mean3 < 12))
    if n > 5:
        mean5 = ds[:, 1:6].mean(axis=1)
        flag &= ~(~pair & (mean5 < 25))
    return minutiae[flag]


def remove_spurious_minutiae(minutiae: np.ndarray, mask: np.ndarray,
                             r: int = 10) -> np.ndarray:
    """Mask-border filter (extraction_latent.py:259-278, rolled r 5): drop
    minutiae whose r-offset corners leave the mask."""
    n = len(minutiae)
    if n == 0:
        return minutiae
    h, w = mask.shape[:2]
    x = minutiae[:, 0].astype(int)
    y = minutiae[:, 1].astype(int)
    keep = (x >= r) & (y >= r) & (x <= w - r - 1) & (y <= h - r - 1)
    i = np.nonzero(keep)[0]
    xi, yi = x[i], y[i]
    corners = ((mask[yi - r, xi - r] != 0) & (mask[yi - r, xi + r] != 0)
               & (mask[yi + r, xi - r] != 0) & (mask[yi + r, xi + r] != 0))
    keep[i] = corners
    return minutiae[keep]


def get_common_minutiae(minutiae_sets, thr: int = 3,
                        init_ind: int = 3) -> np.ndarray:
    """Cross-set consensus voting (extraction_latent.py:219-257): seed from
    set ``init_ind``, match by dist <= 10 and orientation difference < pi/6
    (mod pi), first match wins; keep points seen in >= thr sets. The
    points grow in place in one array (the JAX package rebuilds an array
    from a list for every candidate; the arithmetic is the same)."""
    if len(minutiae_sets[init_ind]) == 0:
        return np.zeros((0, 4))
    seed = np.asarray(minutiae_sets[init_ind], np.float64)[:, :4]
    cap = sum(len(m) for m in minutiae_sets)
    a = np.zeros((cap, 4))
    a[:len(seed)] = seed
    count = np.zeros(cap)
    count[:len(seed)] = 1.0
    n = len(seed)
    for i, mset in enumerate(minutiae_sets):
        if i == init_ind:
            continue
        for m in np.asarray(mset):
            x2, y2, ori2 = m[0], m[1], m[2]
            dx = a[:n, 0] - x2
            dy = a[:n, 1] - y2
            od = np.abs(a[:n, 2] - ori2)
            od = np.where(od > math.pi / 2, math.pi - od, od)
            hit = (dx * dx + dy * dy <= 100.0) & (od < math.pi / 6)
            if hit.any():
                count[int(np.argmax(hit))] += 1
            else:
                a[n] = (x2, y2, ori2, 1)
                count[n] = 1.0
                n += 1
    keep = a[:n][count[:n] >= thr]
    if len(keep):
        keep[:, 3] = 1
    return keep


def _finish(m: np.ndarray, refine: bool, crowd_filter: bool,
            refine_dist_thr: float) -> np.ndarray:
    if refine and len(m):
        m = refine_minutiae(m, dist_thr=refine_dist_thr, ori_dist=np.pi / 4)
    if crowd_filter and len(m):
        m = remove_crowded_minutiae(m)
    return np.asarray(m)


def decode_minutiae_batch(cylinders, thrs, refine: bool = True,
                          crowd_filter: bool = True,
                          refine_dist_thr: float = 20.0):
    """Decode same-shape cylinders [N, H, W, C], each with its threshold,
    then refine each on the host."""
    out = []
    for cyl, thr in zip(cylinders, thrs):
        m, n = decode_cylinder(cyl, float(thr))
        out.append(_finish(m[:n].cpu().numpy(), refine, crowd_filter,
                           refine_dist_thr))
    return out


def decode_minutiae(cylinder, thr: float = 0.2, max_minutiae: int = 1000,
                    refine: bool = True, crowd_filter: bool = True,
                    refine_dist_thr: float = 20.0) -> np.ndarray:
    """The whole-image decode after minutiae-net inference
    (minutiae_AEC.py:76-88): decode -> refine (dist 20; the 64-patch rolled
    variant passes 10, minutiae_AEC_modified.py:89) -> crowding filter."""
    m, n = decode_cylinder(cylinder, thr, max_minutiae=max_minutiae)
    return _finish(m[:n].cpu().numpy(), refine, crowd_filter,
                   refine_dist_thr)
