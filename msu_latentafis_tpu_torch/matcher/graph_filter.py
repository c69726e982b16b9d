"""Second-order graph-consistency filtering, plain PyTorch.

Counterpart of the JAX package's ``matcher/graph_filter.py`` and of the
Pallas ``_filter_body``: the reference's LSS_R_Fast2* family
(matcher.cpp:1099-1647) over a batch of correspondence sets. Every
function takes a leading set axis N and K correspondence slots; slot
coordinates arrive as packs [N, K, 4] = (x, y, cos ori, sin ori).

The arithmetic is the kernel's, written so that the CUDA routine in
``kernels/csrc/filter_body.cuh`` reproduces it bit for bit: every sum runs
in index order (``seq_sum``), products and sums are separate roundings,
and ``1/sqrt`` replaces ``rsqrt``. Stage 1 is the distance-consistency
matrix, power iterations and greedy one-to-one selection; stage 2 the
trig-free angle-consistency matrix over the stage-1 survivors, 5 power
iterations and greedy selection again. The score is the sum of the
surviving correspondences' similarities.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

DIST_LUT_N = 50.0    # quantized-coordinate distance LUT size (matcher.cpp:45)
EPS_COMPAT = 1e-5    # H >= eps counts as compatible (matcher.cpp:1205)
THR_DIST = 1e-4      # greedy stop threshold, distance stage (:1187)
THR_ANGLE = 1e-3     # greedy stop threshold, angle stage (:1599)
COS_PI_4 = float(np.float32(np.cos(np.pi / 4)))
COS_PI_6 = float(np.float32(np.cos(np.pi / 6)))


def coord_pack(xy: torch.Tensor, ori: torch.Tensor) -> torch.Tensor:
    """[..., 2] coordinates + [...] orientations -> [..., 4] packs."""
    return torch.stack([xy[..., 0], xy[..., 1], torch.cos(ori),
                        torch.sin(ori)], dim=-1).contiguous()


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The square root rounded to nearest in x's type (f32), as the
    kernels and XLA take it. PyTorch's f32 sqrt on the CPU is not: on an
    AVX-512 host ~0.7% of roots land one ulp off, and which ones depends on
    the call (so the plain versions differed from run to run). The f64
    root rounded once to f32 is the correctly rounded f32 root (53 >=
    2 * 24 + 2 bits); on CUDA it equals torch.sqrt's."""
    return torch.sqrt(x.double()).to(x.dtype)


def seq_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum along ``dim`` in index order, one rounding per term."""
    x = x.movedim(dim, 0)
    acc = torch.zeros_like(x[0])
    for v in x:
        acc = acc + v
    return acc


def seq_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """acc[m, n, i, j] = sum_d a[m, i, d] * b[n, j, d], the D-long dots in
    index order with one rounding per product and per sum (the kernels'
    order). bf16 and int8 operands are widened to f32 first, as the kernels
    widen them on load."""
    a, b = a.float(), b.float()
    acc = torch.zeros((a.shape[0], b.shape[0], a.shape[1], b.shape[1]),
                      dtype=torch.float32, device=a.device)
    for d in range(a.shape[-1]):
        acc = acc + a[:, None, :, None, d] * b[None, :, None, :, d]
    return acc


def _pairdiff(a: torch.Tensor) -> torch.Tensor:
    return a[:, :, None] - a[:, None, :]


def _off_diag(N: int, K: int, device) -> torch.Tensor:
    return ~torch.eye(K, dtype=torch.bool, device=device).expand(N, K, K)


def build_dist_H(lpack: torch.Tensor, rpack: torch.Tensor,
                 valid: torch.Tensor, lookup: bool) -> torch.Tensor:
    """Distance-consistency matrix H1 [N, K, K] = clip((30 - |d1-d2|)/25).

    ``lookup=True`` is LSS_R_Fast2_Dist_lookup on quantized coordinates
    (|dx|, |dy| < 50 on both sides, distances 16*hypot); ``lookup=False``
    the float semantics of LSS_R_Fast2_Dist_eigen. The reference's
    dist <= 30 gate is the clip's zero. Invalid slots and the diagonal
    are zero.
    """
    N, K, _ = lpack.shape
    dxl, dyl = _pairdiff(lpack[..., 0]), _pairdiff(lpack[..., 1])
    dxr, dyr = _pairdiff(rpack[..., 0]), _pairdiff(rpack[..., 1])
    gate = valid[:, :, None] & valid[:, None, :] & _off_diag(N, K, lpack.device)
    if lookup:
        dxl, dyl, dxr, dyr = dxl.abs(), dyl.abs(), dxr.abs(), dyr.abs()
        gate = gate & (dxl < DIST_LUT_N) & (dyl < DIST_LUT_N) \
            & (dxr < DIST_LUT_N) & (dyr < DIST_LUT_N)
        d1 = 16.0 * sqrt_rn(dxl * dxl + dyl * dyl)
        d2 = 16.0 * sqrt_rn(dxr * dxr + dyr * dyr)
    else:
        d1 = sqrt_rn(dxl * dxl + dyl * dyl)
        d2 = sqrt_rn(dxr * dxr + dyr * dyr)
    # a tensor divisor: on CUDA, PyTorch divides by a Python scalar as a
    # product with its reciprocal, one rounding away from the kernel's x / 25
    H = torch.clamp((30.0 - (d1 - d2).abs()) / torch.full_like(d1, 25.0),
                    0.0, 1.0)
    return torch.where(gate, H, torch.zeros_like(H))


def _line_vec(x: torch.Tensor, y: torch.Tensor):
    """Unit vector of the connecting line, angle -atan2(dy, dx); coincident
    points follow atan2(0, 0) = 0, i.e. (1, 0)."""
    dx, dy = _pairdiff(x), _pairdiff(y)
    r2 = dx * dx + dy * dy
    zero = r2 == 0.0
    inv = 1.0 / sqrt_rn(torch.where(zero, torch.ones_like(r2), r2))
    return (torch.where(zero, torch.ones_like(r2), dx * inv),
            torch.where(zero, torch.zeros_like(r2), -dy * inv))


def build_angle_H(lpack: torch.Tensor, rpack: torch.Tensor,
                  sel: torch.Tensor) -> torch.Tensor:
    """Boolean angle-consistency matrix [N, K, K] over the slots in ``sel``.

    The reference's three adjust_angle tests (matcher.cpp:1471-1647) as
    rotations of v_i = lori_i - rori_i and u = line_l - line_r:
    cos(v_i - v_j) >= cos(pi/4), cos(v_i - u) >= cos(pi/6) and
    cos(v_j - u) >= cos(pi/6), from unit vectors only (no trig).
    """
    N, K, _ = lpack.shape
    lc, ls, rc, rs = (lpack[..., 2], lpack[..., 3], rpack[..., 2],
                      rpack[..., 3])
    cos_v = lc * rc + ls * rs                              # [N, K]
    sin_v = ls * rc - lc * rs
    t1 = (cos_v[:, :, None] * cos_v[:, None, :]
          + sin_v[:, :, None] * sin_v[:, None, :]) >= COS_PI_4
    cLl, sLl = _line_vec(lpack[..., 0], lpack[..., 1])
    cLr, sLr = _line_vec(rpack[..., 0], rpack[..., 1])
    cos_u = cLl * cLr + sLl * sLr
    sin_u = sLl * cLr - cLl * sLr
    t2 = (cos_v[:, :, None] * cos_u + sin_v[:, :, None] * sin_u) >= COS_PI_6
    t3 = (cos_v[:, None, :] * cos_u + sin_v[:, None, :] * sin_u) >= COS_PI_6
    mask = sel[:, :, None] & sel[:, None, :] & _off_diag(N, K, lpack.device)
    return t1 & t2 & t3 & mask


def power_iteration(H: torch.Tensor, b: torch.Tensor, iters: int,
                    eps: float = 1e-5) -> torch.Tensor:
    """S <- H S / (sum(H S) + eps), ``iters`` times, sums in index order."""
    for _ in range(iters):
        c = seq_sum(H * b[:, None, :], dim=2)
        b = c / (seq_sum(c, dim=1)[:, None] + eps)
    return b


def lex_outranks(S: torch.Tensor,
                 tie_keys: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """outranks[n, i, j]: candidate j precedes i in the greedy order.

    The reference walks candidates by support descending with ties broken
    by candidate-list position (matcher.cpp:1184-1220); ``tie_keys``
    (larger wins, in order) reconstruct that position when the slot order
    differs from the list order, with ascending slot index last.
    """
    K = S.shape[-1]
    gt = S[:, None, :] > S[:, :, None]
    eq = S[:, None, :] == S[:, :, None]
    for k in tie_keys:
        gt = gt | (eq & (k[:, None, :] > k[:, :, None]))
        eq = eq & (k[:, None, :] == k[:, :, None])
    idx = torch.arange(K, device=S.device)
    return gt | (eq & (idx[None, None, :] < idx[None, :, None]))


def greedy_one_to_one(S: torch.Tensor, bad: torch.Tensor,
                      eligible: torch.Tensor,
                      tie_keys: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """Greedy selection as parallel rounds; returns the selected mask [N, K].

    Candidate j blocks i when j outranks i and selecting j excludes i
    (``bad``: shared minutia or incompatible). The sequential pass selects
    i exactly when no blocker of i is selected; each round decides every
    candidate whose blockers are all decided. The highest-ranked undecided
    candidate has only decided blockers, so every round decides at least
    one candidate and K rounds always reach the fixpoint.
    """
    blockers = bad & lex_outranks(S, tie_keys) \
        & eligible[:, None, :] & eligible[:, :, None]
    sel = torch.zeros_like(eligible)
    rej = torch.zeros_like(eligible)
    for _ in range(S.shape[-1]):
        undecided = eligible & ~sel & ~rej
        if not bool(undecided.any()):
            break
        by_sel = (blockers & sel[:, None, :]).any(dim=2)
        live = (blockers & ~rej[:, None, :]).any(dim=2)
        sel = sel | (undecided & ~live)
        rej = rej | (undecided & by_sel)
    return sel


def filter_correspondences(val: torch.Tensor, li: torch.Tensor,
                           ri: torch.Tensor, lpack: torch.Tensor,
                           rpack: torch.Tensor, valid: torch.Tensor,
                           lookup: bool, dist_iters: int,
                           tie_keys: Sequence[torch.Tensor] = (),
                           stats: Optional[dict] = None, stages: int = 6,
                           stage2_cap: int = 0) -> torch.Tensor:
    """Both filter stages over N correspondence sets -> scores [N].

    ``val`` [N, K] similarities, ``li``/``ri`` [N, K] minutia indices,
    ``lpack``/``rpack`` [N, K, 4] gathered coordinate packs, ``valid``
    [N, K] bool. Stage 2 chains (S1,) + tie_keys because the reference's
    corr2 list is ordered by stage-1 selection rank. ``stats``, when
    given, receives the per-set counts the op-count bound reads
    (``k_valid``, ``n_stage1``).

    ``stages`` < 6 is the JAX package's bench hook (``_filter_body``): the
    result is a partial sum instead of the score, 0 the I/O floor
    sum(val * valid) + sum(lx + ly + lc + ls) + sum(rx + ry + rc + rs) +
    sum(li + ri), 1 sum(H1), 2 sum(S1), 3 the stage-1 survivors'
    similarities, 4 the number of compatible stage-2 pairs, 5 sum(S2).
    With 0 < ``stage2_cap`` < K stage 2 keeps only the first stage2_cap
    stage-1 survivors in rank order; its seed 1 / n2 still counts all.
    """
    N, K = val.shape
    if stages <= 0:
        lq = ((lpack[..., 0] + lpack[..., 1]) + lpack[..., 2]) + lpack[..., 3]
        rq = ((rpack[..., 0] + rpack[..., 1]) + rpack[..., 2]) + rpack[..., 3]
        return ((seq_sum(val * valid.float(), dim=1) + seq_sum(lq, dim=1))
                + seq_sum(rq, dim=1)) + seq_sum(li.float() + ri.float(),
                                                dim=1)
    off = _off_diag(N, K, val.device)
    H1 = build_dist_H(lpack, rpack, valid, lookup)
    if stages == 1:
        return seq_sum(seq_sum(H1, dim=2), dim=1)
    S1 = power_iteration(H1, torch.where(valid, val, torch.zeros_like(val)),
                         dist_iters)
    if stages == 2:
        return seq_sum(S1, dim=1)
    conflict = (li[:, :, None] == li[:, None, :]) \
        | (ri[:, :, None] == ri[:, None, :])
    sel1 = greedy_one_to_one(S1, (conflict | (H1 < EPS_COMPAT)) & off,
                             valid & (S1 >= THR_DIST), tie_keys)
    if stages == 3:
        return seq_sum(torch.where(sel1, val, torch.zeros_like(val)), dim=1)

    n2 = sel1.sum(dim=1, dtype=torch.float32)
    if 0 < stage2_cap < K:
        sel2_in = sel1 & (torch.cumsum(sel1, dim=1) <= stage2_cap)
    else:
        sel2_in = sel1
    H2 = build_angle_H(lpack, rpack, sel2_in)
    if stages == 4:
        return seq_sum(seq_sum(H2.float(), dim=2), dim=1)
    b2 = torch.where(sel2_in, (1.0 / torch.clamp(n2, min=1.0))[:, None],
                     torch.zeros_like(val))
    S2 = power_iteration(H2.float(), b2, 5)
    if stages == 5:
        return seq_sum(S2, dim=1)
    sel2 = greedy_one_to_one(S2, (conflict | ~H2) & off,
                             sel2_in & (S2 >= THR_ANGLE),
                             (S1,) + tuple(tie_keys))
    if stats is not None:
        stats["k_valid"] = valid.sum(dim=1)
        stats["n_stage1"] = sel1.sum(dim=1)
    return seq_sum(torch.where(sel2, val, torch.zeros_like(val)), dim=1)
