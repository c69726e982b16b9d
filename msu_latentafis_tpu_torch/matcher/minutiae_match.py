"""Minutiae-template matching (uncompressed descriptors), plain PyTorch.

Reference semantics (matcher.cpp:420-516): descriptor similarity, clamp
at zero, mutual normalization s / (rowsum + colsum - s), top-120 candidate
correspondences by normalized similarity carrying the raw similarity as
weight, then the two-stage graph filter. Candidate selection follows the
``fused_minutiae_match`` kernel: ``row_cap`` best candidates per latent
row, then one threshold bisect over the [row_cap, P] candidate table. It
is the exact top-K whenever no latent row holds more than ``row_cap`` of
it (``row_cap = R`` is always exact).

Sums run in index order (see ``graph_filter.seq_sum``) so that the CUDA
kernel reproduces these functions bit for bit. ``minutiae_correspondences``
and ``minutiae_correspondence_indices`` are the exact top-N selection of
the JAX package's XLA path, which feeds ``graph_filter_infuse``.
"""
from __future__ import annotations

import torch

from .graph_filter import seq_dots, seq_sum

SENT = -3.0          # below any normalized similarity; marks invalid pairs


def minutiae_similarity(lat_des: torch.Tensor, lat_validf: torch.Tensor,
                        rol_des: torch.Tensor,
                        rol_validf: torch.Tensor) -> torch.Tensor:
    """relu(ldes . rdes) * valid -> [NT, B, P, R].

    ``lat_des`` [NT, P, D], ``rol_des`` [B, R, D]; validity as f32 0/1.
    The D-long dot products run in index order, one rounding per product
    and per sum.
    """
    acc = seq_dots(lat_des, rol_des)
    pairv = lat_validf[:, None, :, None] * rol_validf[None, :, None, :]
    return torch.clamp(acc, min=0.0) * pairv


def mutual_normalize(simi: torch.Tensor) -> torch.Tensor:
    """simi / (rowsum + colsum - simi + 1e-6) over the last two axes."""
    row = seq_sum(simi, dim=-1)
    col = seq_sum(simi, dim=-2)
    return simi / (row[..., :, None] + col[..., None, :] - simi + 1e-6)


def _top_corr(simi, lat_valid, rol_valid, top_n):
    """Exact top-N of the mutually normalized similarity over the flat
    [.., P * R] axis, invalid pairs -inf: a stable descending sort, so a
    lower flat index comes first on ties (``jax.lax.top_k`` off the TPU).
    Returns (value, flat index), each [.., k]."""
    P, R = simi.shape[-2:]
    pair = lat_valid[..., :, None] & rol_valid[..., None, :]
    norm = torch.where(pair, mutual_normalize(simi),
                       torch.full_like(simi, -float("inf")))
    k = min(top_n, P * R)
    v, i = torch.sort(norm.reshape(norm.shape[:-2] + (P * R,)), dim=-1,
                      descending=True, stable=True)
    return v[..., :k], i[..., :k]


def minutiae_correspondences(simi: torch.Tensor, lat_valid: torch.Tensor,
                             rol_valid: torch.Tensor, top_n: int = 120):
    """Top-N correspondences of one [P, R] similarity matrix by mutually
    normalized similarity (lat_valid [P], rol_valid [R] bool). Returns
    (val, li, ri, valid) [k]: the raw similarities at the selected pairs,
    their latent / rolled minutia indices (int32) and whether the pair is
    valid. The JAX package's ``approx_max_k`` option is a TPU approximation
    and is not ported."""
    R = simi.shape[-1]
    topv, topi = _top_corr(simi, lat_valid, rol_valid, top_n)
    return (simi.reshape(-1)[topi], (topi // R).int(), (topi % R).int(),
            topv > -float("inf"))


def minutiae_correspondence_indices(simi: torch.Tensor,
                                    lat_valid: torch.Tensor,
                                    rol_valid: torch.Tensor,
                                    top_n: int = 120):
    """``minutiae_correspondences`` over the batched similarity
    simi [NT, B, P, R] (lat_valid [NT, P], rol_valid [B, R] bool), indices
    only: (li, ri, valid) [NT, B, k]. The weights are recovered by
    ``kernels.ops.graph_filter_infuse(simi=...)``."""
    R = simi.shape[-1]
    topv, topi = _top_corr(simi, lat_valid[:, None], rol_valid[None],
                           top_n)
    return (topi // R).int(), (topi % R).int(), topv > -float("inf")


def row_candidates(normm: torch.Tensor, simi: torch.Tensor, row_cap: int):
    """``row_cap`` rounds of per-row max extraction (first index on ties).

    Returns (value, column, similarity), each [..., row_cap, P]: the
    candidate table in extraction-round-major order.
    """
    R = normm.shape[-1]
    iota = torch.arange(R, device=normm.device)
    normm = normm.clone()
    cv, cr, cs = [], [], []
    for _ in range(row_cap):
        m = normm.max(dim=-1).values
        am = torch.where(normm == m[..., None], iota, R).min(dim=-1).values
        cv.append(m)
        cr.append(am)
        cs.append(torch.gather(simi, -1, am[..., None])[..., 0])
        normm.scatter_(-1, am[..., None], SENT)
    return (torch.stack(cv, dim=-2), torch.stack(cr, dim=-2),
            torch.stack(cs, dim=-2))


def minutiae_match_single(lat_des, lat_xy, lat_ori, lat_valid, rol_des,
                          rol_xy, rol_ori, rol_valid, top_n: int = 120,
                          row_cap: int = 8) -> torch.Tensor:
    """Score one latent minutiae template [P, ...] against one rolled
    template [R, ...] (``*_valid`` bool); returns a 0-d f32 tensor."""
    from .kernels.ops import minutiae_match_plain

    def pack(xy, ori):
        return torch.stack([xy[:, 0], xy[:, 1], torch.cos(ori),
                            torch.sin(ori)], dim=1)[None]
    return minutiae_match_plain(
        lat_des[None], lat_valid.float()[None], rol_des[None],
        rol_valid.float()[None], pack(lat_xy, lat_ori),
        pack(rol_xy, rol_ori), top_n=top_n, row_cap=row_cap)[0, 0]
