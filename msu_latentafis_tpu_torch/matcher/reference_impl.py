"""Executable NumPy specification of the matching algorithm.

The port's own copy of the JAX package's ``matcher/reference_impl.py``
(the port imports nothing of that package): the exact per-pair matching
semantics of the reference's native matcher (matching/matcher.cpp) in
plain NumPy, loop by loop, faithful rather than fast.

- minutiae matching: cosine-similarity GEMM -> clamp -> mutual
  normalization -> top-120 candidate correspondences -> distance-consistency
  spectral filtering (5 power iterations) -> angle-consistency spectral
  filtering (matcher.cpp:420-516, :1350-1469, :1471-1636);
- texture matching: PQ asymmetric-distance similarity, per-latent-minutia
  argmax, top-200, lookup-distance spectral filtering (3 power iterations) +
  angle filtering (matcher.cpp:531-783, :1225-1348);
- fused score: s0 + s1 + s2 + 0.3 * s_texture over the selected latent
  minutiae templates {26, 2, 11} (matcher.cpp:376-417, :188).

``one2one_selected_scores(..., return_corr=True)`` gives the surviving
correspondences that ``engine.write_corr_files`` writes for the top-24
candidates; the tests hold the engine against these functions.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..templates.data_model import MatcherConstants as MC

Corr = Tuple[float, int, int]  # (similarity, latent index, rolled index)


def compute_dist_to_codewords(des: np.ndarray, codebook: np.ndarray) -> np.ndarray:
    """Latent descriptor -> per-(sub, cluster) squared distances
    [n, n_subs, n_clusters] (include.h:327-359)."""
    n_subs, n_clusters, sub_dim = codebook.shape
    x = np.asarray(des, np.float32).reshape(len(des), n_subs, 1, sub_dim)
    d = x - np.asarray(codebook, np.float32)[None]
    return np.sum(d * d, axis=3, dtype=np.float32)


def _adjust_angle(a: float) -> float:
    if a > np.pi:
        return a - 2 * np.pi
    if a < -np.pi:
        return a + 2 * np.pi
    return a


def _greedy_select(S: np.ndarray, corr: List[Corr], compat_ok, thr: float) -> List[Corr]:
    """Greedy one-to-one selection shared by all LSS variants
    (matcher.cpp:1184-1220 and analogues)."""
    order = np.argsort(-S, kind="stable")
    selected_idx: List[int] = []
    out: List[Corr] = []
    used_lat, used_rol = set(), set()
    for pos, ind in enumerate(order):
        if S[ind] < thr:
            break
        _, li, ri = corr[ind]
        if li in used_lat or ri in used_rol:
            continue
        if selected_idx and not all(compat_ok(ind, j) for j in selected_idx):
            continue
        selected_idx.append(int(ind))
        out.append(corr[ind])
        used_lat.add(li)
        used_rol.add(ri)
    return out


def lss_r_fast2_dist(corr: List[Corr], lat_xy: np.ndarray, rol_xy: np.ndarray,
                     d_thr: float = MC.DIST_THRESHOLD, iters: int = 5,
                     lookup: bool = False) -> List[Corr]:
    """Distance-consistency spectral filtering.

    ``lookup=False`` == LSS_R_Fast2_Dist_eigen (matcher.cpp:1350-1469):
    float coordinates, 5 power iterations. ``lookup=True`` ==
    LSS_R_Fast2_Dist_lookup (matcher.cpp:1225-1348): quantized integer
    coordinates with the 50x50 sqrt((16i)^2+(16j)^2) distance table and 3
    power iterations.
    """
    num = len(corr)
    H = np.zeros((num, num), np.float32)
    for i in range(num - 1):
        _, li1, ri1 = corr[i]
        for j in range(i + 1, num):
            _, li2, ri2 = corr[j]
            if lookup:
                dx1 = abs(int(lat_xy[li1, 0]) - int(lat_xy[li2, 0]))
                dy1 = abs(int(lat_xy[li1, 1]) - int(lat_xy[li2, 1]))
                dx2 = abs(int(rol_xy[ri1, 0]) - int(rol_xy[ri2, 0]))
                dy2 = abs(int(rol_xy[ri1, 1]) - int(rol_xy[ri2, 1]))
                if dx1 >= MC.DIST_LUT_N or dx2 >= MC.DIST_LUT_N \
                        or dy1 >= MC.DIST_LUT_N or dy2 >= MC.DIST_LUT_N:
                    continue
                d1 = np.sqrt((16.0 * dx1) ** 2 + (16.0 * dy1) ** 2)
                d2 = np.sqrt((16.0 * dx2) ** 2 + (16.0 * dy2) ** 2)
            else:
                d1 = np.hypot(lat_xy[li1, 0] - lat_xy[li2, 0],
                              lat_xy[li1, 1] - lat_xy[li2, 1])
                d2 = np.hypot(rol_xy[ri1, 0] - rol_xy[ri2, 0],
                              rol_xy[ri1, 1] - rol_xy[ri2, 1])
            dist = abs(d1 - d2)
            if dist > d_thr:
                continue
            h = np.clip((30.0 - dist) / 25.0, 0.0, 1.0)
            H[i, j] = h
            H[j, i] = h

    b = np.array([c[0] for c in corr], np.float32)
    for _ in range(iters):
        c = H @ b
        b = c / (c.sum() + 1e-5)

    def compat(i, j):
        return H[i, j] >= 1e-5

    return _greedy_select(b, corr, compat, thr=1e-4)


def lss_r_fast2_angle(corr: List[Corr], lat_xy, lat_ori, rol_xy, rol_ori) -> List[Corr]:
    """Angle-consistency spectral filtering (LSS_R_Fast2,
    matcher.cpp:1471-1636): boolean compatibility from three angle tests,
    5 power iterations from a uniform start, greedy selection at thr 1e-3."""
    num = len(corr)
    H = np.zeros((num, num), bool)
    for i in range(num - 1):
        _, li1, ri1 = corr[i]
        for j in range(i + 1, num):
            _, li2, ri2 = corr[j]
            a1 = _adjust_angle(lat_ori[li1] - lat_ori[li2])
            a2 = _adjust_angle(rol_ori[ri1] - rol_ori[ri2])
            d = abs(a1 - a2)
            if d > np.pi:
                d = 2 * np.pi - d
            if d > np.pi / 4:
                continue
            dx1 = lat_xy[li1, 0] - lat_xy[li2, 0]
            dy1 = lat_xy[li1, 1] - lat_xy[li2, 1]
            line1 = -np.arctan2(dy1, dx1)
            a1 = _adjust_angle(lat_ori[li1] - line1)
            dx2 = rol_xy[ri1, 0] - rol_xy[ri2, 0]
            dy2 = rol_xy[ri1, 1] - rol_xy[ri2, 1]
            line2 = -np.arctan2(dy2, dx2)
            a2 = _adjust_angle(rol_ori[ri1] - line2)
            d = abs(a1 - a2)
            if d > np.pi:
                d = 2 * np.pi - d
            if d > np.pi / 6:
                continue
            a1 = _adjust_angle(lat_ori[li2] - line1)
            a2 = _adjust_angle(rol_ori[ri2] - line2)
            d = abs(a1 - a2)
            if d > np.pi:
                d = 2 * np.pi - d
            if d > np.pi / 6:
                continue
            H[i, j] = True
            H[j, i] = True

    S = np.full((num,), 1.0 / num if num else 0.0, np.float32)
    for _ in range(5):
        S1 = (H * S[None, :]).sum(axis=1).astype(np.float32)
        S = S1 / (S1.sum() + 1e-5)

    def compat(i, j):
        return bool(H[i, j])

    return _greedy_select(S, corr, compat, thr=1e-3)


def one2one_minutiae_matching(lat_des, lat_xy, lat_ori, rol_des, rol_xy, rol_ori,
                              return_corr: bool = False):
    """Uncompressed-descriptor minutiae matching (matcher.cpp:420-516).

    With ``return_corr`` also returns the surviving correspondences as the
    reference's save_corr path does (matcher.cpp:497-506)."""
    nl, nr = len(lat_des), len(rol_des)
    if nl == 0 or nr == 0:
        return (0.0, []) if return_corr else 0.0
    simi = (np.asarray(lat_des, np.float32) @ np.asarray(rol_des, np.float32).T)
    simi = np.maximum(simi, 0.0)
    row = simi.sum(axis=1)
    col = simi.sum(axis=0)
    norm = simi / (row[:, None] + col[None, :] - simi + 1e-6)

    top_n = min(MC.TOPN_MINU_CORR, nl * nr)
    flat_order = np.argsort(-norm.reshape(-1), kind="stable")[:top_n]
    corr = [(float(simi.reshape(-1)[k]), int(k // nr), int(k % nr)) for k in flat_order]

    corr2 = lss_r_fast2_dist(corr, lat_xy, rol_xy, lookup=False, iters=5)
    corr3 = lss_r_fast2_angle(corr2, lat_xy, lat_ori, rol_xy, rol_ori)
    score = float(sum(c[0] for c in corr3))
    return (score, corr3) if return_corr else score


def one2one_texture_matching(lat_dist_codewords, lat_xy, lat_ori,
                             rol_codes, rol_xy, rol_ori) -> float:
    """PQ asymmetric-distance texture matching (matcher.cpp:531-783)."""
    nl = min(len(lat_dist_codewords), MC.MAX_MINU_PER_TEMPLATE)
    nr = min(len(rol_codes), MC.MAX_MINU_PER_TEMPLATE)
    if nl == 0 or nr == 0:
        return 0.0
    n_subs = rol_codes.shape[1]
    sub_idx = np.arange(n_subs)
    # simi[i, j] = 6 - sum_k dist_codewords[i, k, codes[j, k]]
    gathered = lat_dist_codewords[:nl][:, sub_idx[None, :], rol_codes[:nr].astype(np.int64)]
    simi = (6.0 - gathered.sum(axis=2, dtype=np.float32)).astype(np.float32)

    best_j = np.argmax(simi, axis=1)
    best_v = simi[np.arange(nl), best_j]
    corr = [(float(best_v[i]), int(i), int(best_j[i])) for i in range(nl)]
    if len(corr) > MC.TOPN_TEX_CORR:
        keep = np.argsort(-best_v, kind="stable")[:MC.TOPN_TEX_CORR]
        corr = [corr[int(k)] for k in keep]

    corr2 = lss_r_fast2_dist(corr, lat_xy, rol_xy, lookup=True, iters=3)
    corr3 = lss_r_fast2_angle(corr2, lat_xy, lat_ori, rol_xy, rol_ori)
    return float(sum(c[0] for c in corr3))


def one2one_selected_scores(latent, rolled, codebook,
                            selected=MC.SELECTED_MINU_TEMPLATES,
                            return_corr: bool = False):
    """Per-template score vector for the selected latent minutiae templates
    plus the texture template (One2One_matching_selected_templates,
    matcher.cpp:376-417).

    Returns ``(scores, corrs)`` where ``scores[i]`` is the score of selected
    minutiae template i and ``scores[-1]`` the texture score; ``corrs[i]``
    (when ``return_corr``) is the surviving correspondence list
    ``[(lx, ly, rx, ry), ...]`` for selected template i — exactly what the
    reference writes to ``corr*_<i>.csv`` (matcher.cpp:405-406, :497-506).
    Returns ``None`` when either side is empty (reference return codes 1/2).
    """
    if len(latent.minu_template) <= selected[0] and not latent.texture_template:
        return None
    if not rolled.minu_template and not rolled.texture_template:
        return None
    scores = [0.0] * (len(selected) + 1)
    corrs: List[List[Tuple[float, float, float, float]]] = [[] for _ in selected]
    for i, idx in enumerate(selected):
        if idx >= len(latent.minu_template) or not rolled.minu_template:
            continue
        lt = latent.minu_template[idx]
        rt = rolled.minu_template[0]
        if lt.n_minutiae == 0 or rt.n_minutiae == 0:
            continue
        lxy = np.asarray(lt.minutiae)[:, :2]
        rxy = np.asarray(rt.minutiae)[:, :2]
        s, corr3 = one2one_minutiae_matching(
            lt.des, lxy, np.asarray(lt.minutiae)[:, 2],
            rt.des, rxy, np.asarray(rt.minutiae)[:, 2], return_corr=True)
        scores[i] = s
        corrs[i] = [(float(lxy[li, 0]), float(lxy[li, 1]),
                     float(rxy[ri, 0]), float(rxy[ri, 1]))
                    for _, li, ri in corr3]
    if latent.texture_template and rolled.texture_template:
        lt = latent.texture_template[0]
        rt = rolled.texture_template[0]
        if lt.n_minutiae and rt.n_minutiae:
            dists = compute_dist_to_codewords(lt.des, codebook)
            scores[-1] = one2one_texture_matching(
                dists, np.asarray(lt.minutiae)[:, :2], np.asarray(lt.minutiae)[:, 2],
                rt.des, np.asarray(rt.minutiae)[:, :2], np.asarray(rt.minutiae)[:, 2])
    return (scores, corrs) if return_corr else (scores, None)


def one2one_all_templates_scores(latent, rolled, codebook) -> Optional[List[float]]:
    """Score vector over ALL latent minutiae templates (each vs rolled
    template 0) followed by all latent texture templates
    (One2One_matching_all_templates, matcher.cpp:339-374)."""
    n_minu = len(latent.minu_template)
    n_tex = len(latent.texture_template)
    if n_minu <= 0 and n_tex <= 0:
        return None
    if not rolled.minu_template and not rolled.texture_template:
        return None
    scores = [0.0] * (n_minu + n_tex)
    for i, lt in enumerate(latent.minu_template):
        if not rolled.minu_template:
            break
        rt = rolled.minu_template[0]
        if lt.n_minutiae == 0 or rt.n_minutiae == 0:
            continue
        scores[i] = one2one_minutiae_matching(
            lt.des, np.asarray(lt.minutiae)[:, :2], np.asarray(lt.minutiae)[:, 2],
            rt.des, np.asarray(rt.minutiae)[:, :2], np.asarray(rt.minutiae)[:, 2])
    for i, lt in enumerate(latent.texture_template):
        if not rolled.texture_template:
            break
        rt = rolled.texture_template[0]
        if lt.n_minutiae == 0 or rt.n_minutiae == 0:
            continue
        dists = compute_dist_to_codewords(lt.des, codebook)
        scores[n_minu + i] = one2one_texture_matching(
            dists, np.asarray(lt.minutiae)[:, :2], np.asarray(lt.minutiae)[:, 2],
            rt.des, np.asarray(rt.minutiae)[:, :2], np.asarray(rt.minutiae)[:, 2])
    return scores


def one2one_fused_score(latent, rolled, codebook,
                        selected=MC.SELECTED_MINU_TEMPLATES) -> Optional[float]:
    """Fused selected-template score for one latent/rolled Template pair
    (matcher.cpp:376-417 + :188). Returns None when either side is empty."""
    out = one2one_selected_scores(latent, rolled, codebook, selected)
    if out is None:
        return None
    scores, _ = out
    return float(sum(scores[:-1]) + MC.TEXTURE_SCORE_WEIGHT * scores[-1])
