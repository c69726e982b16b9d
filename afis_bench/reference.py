"""The plain reference of the search, in plain PyTorch and float64.

It imports nothing of the program and takes nothing the program made: it
starts from the benchmark's raw draws (``gen.Draws``) and derives the
operands the configuration states itself (``Precision``): descriptors
rounded to the compute type, the int8 texture gallery at one global scale,
int8 minutiae at the fixed synthetic scale, and the latent side with those
scales folded in, as the configuration's modes define them. Every sum is
then taken in float64.

The semantics are those of the NumPy specification of the upstream matcher
(``matcher.cpp``), as the port's ``matcher/reference_impl.py`` states them,
vectorised over pairs:

- minutiae templates: relu(ldes . rdes), mutual normalisation
  s / (rowsum + colsum - s + 1e-6), each latent row's best ``row_cap``
  candidates (the configuration's row cap; first column on ties), their
  top 120 by normalised value (flat index on ties), the distance filter (5
  power iterations, greedy one-to-one at 1e-4) and the angle filter (5
  iterations from a uniform start, greedy at 1e-3); the score sums the
  surviving similarities;
- the texture template: 6 - sum_k ||x_k - C_k,code||^2, written as
  2 x . dec + (6 - |x|^2 - |dec|^2); each latent row's best rolled column
  (first on ties), the best 200 rows by value, the lookup distance filter
  on quantized coordinates (3 iterations) and the angle filter;
- fused: s0 + s1 + s2 + 0.3 s_tex, -1 for an entry with no minutiae and
  no texture;
- the screen the serving path ranks by (the TPU bench's screen, which the
  configuration's serving engine defines): per template
  min(sum_p relu(max_r s), sum_r relu(max_p s)) on validity-zeroed
  descriptors, plus 0.3 sum_i relu(2 raw_i + 6 - |x_i|^2), raw_i the row
  maximum of x_i . dec_j + a1_j + a2_j rounded to the latent operand's
  type, a1 / a2 the -|dec|^2 / 2 and validity rows in the gallery's type
  (for an int8 gallery: one scale max(|dec|^2 / 2) / 126 + 1e-9 per
  engine block, -127 for an invalid column); the kept set is the best
  m_pad by a stable descending sort.

``Precision(modes, lower=True)`` is the control: every operand one step
below what the configuration states (bf16 -> fp8 e4m3, int8 -> int4).
Every configuration computes in bf16; another compute type is refused.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from .gen import CHUNK, DES_NORM, Draws

F64 = torch.float64
TOPN_MINU = 120
TOPN_TEX = 200
DIST_THR = 30.0
LUT_N = 50
TEX_WEIGHT = 0.3
SCREEN_SENT = -1e4
COS_PI_4 = math.cos(math.pi / 4)
COS_PI_6 = math.cos(math.pi / 6)
PAIR_ELEMS = 1 << 25     # f64 elements a similarity block may hold
FILTER_LISTS = 4096      # candidate lists the filter takes at once


def round_to(x: torch.Tensor, kind: str) -> torch.Tensor:
    """x rounded (to nearest even) to ``kind``, returned as float64."""
    x = x.float()
    if kind == "bfloat16":
        return x.to(torch.bfloat16).double()
    if kind == "float8":       # saturating: e4m3's largest finite is 448
        return torch.clamp(x, -448.0, 448.0).to(torch.float8_e4m3fn).double()
    raise ValueError(kind)


class Precision:
    """The operand types of a configuration's ``modes`` (or, with
    ``lower``, the control's: each one step below)."""

    LOWER = {"bfloat16": "float8"}

    def __init__(self, modes: dict, lower: bool = False):
        self.compute = modes["compute_dtype"]
        if self.compute not in self.LOWER:
            raise ValueError(f"compute_dtype {self.compute}")
        self.kind = self.LOWER[self.compute] if lower else self.compute
        self.levels = 7 if lower else 127
        self.tex_int8 = bool(modes["tex_int8"])
        self.minu_int8 = bool(modes["minu_int8"])
        self.codes_resident = bool(modes["codes_resident"])
        self.block = int(modes["block"])
        self.row_cap = int(modes["row_cap"])
        if CHUNK % self.block:
            raise ValueError("the block must divide the draws' chunk")
        self.minu_scale = float(np.float32(DES_NORM / self.levels + 1e-12))

    def op(self, x: torch.Tensor) -> torch.Tensor:
        return round_to(x, self.kind)

    def quant(self, x: torch.Tensor, scale: float) -> torch.Tensor:
        """clip(round(x / scale), -levels, levels), the division in f32."""
        q = torch.round(x.float() / torch.full_like(x.float(), scale))
        return torch.clamp(q, -self.levels, self.levels).double()


class Codebook:
    """The texture side's codebook as the configuration stores it: ``dec``
    [S, C, d] the values the gallery's texture operand takes, ``scale``
    the scale folded into the latent side (1 unless int8), ``sq`` [S, C]
    the f32 codebook's squared sub-norms."""

    def __init__(self, codebook: np.ndarray, prec: Precision, device):
        cb = torch.as_tensor(codebook, device=device)
        self.S, self.C, self.sd = cb.shape
        k = prec.op(cb)
        self.scale = 1.0
        if prec.tex_int8 and not prec.codes_resident:
            self.scale = float(np.float32(
                float(np.abs(codebook).max()) / prec.levels + 1e-12))
            k = prec.quant(k, self.scale)
        self.dec = k
        self.sq = (cb.double() ** 2).sum(dim=2)
        self.int8 = prec.tex_int8 and not prec.codes_resident

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        sub = torch.arange(self.S, device=codes.device)
        return self.dec[sub, codes.long()].reshape(
            codes.shape[:-1] + (self.S * self.sd,))

    def sqnorm(self, codes: torch.Tensor) -> torch.Tensor:
        sub = torch.arange(self.S, device=codes.device)
        return self.sq[sub, codes.long()].sum(dim=-1)


def gallery_operands(rows: Dict[str, torch.Tensor], prec: Precision,
                     cb: Codebook) -> Dict[str, torch.Tensor]:
    """Raw gallery rows -> the operands the configuration stores."""
    rdes = prec.quant(rows["minu_des"], prec.minu_scale) if prec.minu_int8 \
        else prec.op(rows["minu_des"])
    Rm, Rt = rows["minu_des"].shape[1], rows["tex_codes"].shape[1]
    dev = rdes.device
    return dict(
        rdes=rdes,
        rvalid=torch.arange(Rm, device=dev)[None] < rows["minu_n"][:, None],
        rxy=rows["minu_xy"].double(), rori=rows["minu_ori"].double(),
        dec=cb.decode(rows["tex_codes"]), rsq=cb.sqnorm(rows["tex_codes"]),
        tvalid=torch.arange(Rt, device=dev)[None] < rows["tex_n"][:, None],
        txy=rows["tex_xy"].double(), tori=rows["tex_ori"].double(),
        empty=(rows["minu_n"] == 0) & (rows["tex_n"] == 0))


def latent_operands(lat: Dict[str, torch.Tensor], i: int, prec: Precision,
                    cb: Codebook, screen: bool = False, lt_cap: int = 0,
                    t_cap: int = 0) -> Dict[str, torch.Tensor]:
    """Latent ``i`` of the raw pool -> its operands: the minutiae side
    with an int8 gallery's scale folded in, the texture side rounded
    before (exact path) or after (screen) an int8 gallery's scale is
    folded in; the squared norms from the unrounded descriptors. The
    screen's prescreen keeps the first ``t_cap`` templates and ``lt_cap``
    texture rows (0 keeps all)."""
    des = lat["minu_des"][i]
    if prec.minu_int8:
        des = des.float() * torch.full_like(des.float(), prec.minu_scale)
    T, Lm, _ = des.shape
    t = t_cap or T
    x = lat["tex_des"][i]
    Lt = x.shape[0]
    dev = x.device
    if cb.int8:
        s = torch.full_like(x.float(), cb.scale)
        x = prec.op(x.float() * s) if screen \
            else prec.op(prec.op(x).float() * s)
    else:
        x = prec.op(x)
    tn = int(lat["tex_n"][i])
    if lt_cap:
        x, tn = x[:lt_cap], min(tn, lt_cap)
    n = x.shape[0]
    return dict(
        ldes=prec.op(des)[:t], lvalid=(torch.arange(Lm, device=dev)[None]
                                       < lat["minu_n"][i][:t, None]),
        lxy=lat["minu_xy"][i][:t].double(), lori=lat["minu_ori"][i][:t].double(),
        x=x, lsq=(lat["tex_des"][i][:n].double() ** 2).sum(dim=1),
        xvalid=torch.arange(n, device=dev) < tn,
        txy=lat["tex_xy"][i][:n].double(), tori=lat["tex_ori"][i][:n].double(),
        Lt=Lt)


# ---------------------------------------------------------------------------
# the screen
# ---------------------------------------------------------------------------

def screen_aug(rsq: torch.Tensor, valid: torch.Tensor, prec: Precision,
               cb: Codebook):
    """The screen's a1, a2 rows [B, Rt] (see the module docstring)."""
    half = rsq * 0.5
    if not cb.int8:
        a1 = prec.op(-half)
        a2 = prec.op(torch.where(valid, 0.0, SCREEN_SENT).to(F64))
        return a1, a2
    B, Rt = rsq.shape
    blk = prec.block
    half32 = half.float()
    c1 = half32.reshape(B // blk, blk * Rt).max(dim=1).values / 126.0 + 1e-9
    c1 = c1.repeat_interleave(blk)[:, None]
    q1 = torch.clamp(torch.round(-half32 / c1.expand(B, Rt)), -127, 127)
    a1 = prec.op(c1).expand(B, Rt) * q1.double()
    a2 = torch.where(valid, 0.0, -127.0).to(F64)
    return a1, a2


def screen_scores(L: dict, g: dict, prec: Precision, cb: Codebook,
                  tau: float = 0.0) -> torch.Tensor:
    """Screen [B] of one latent (``latent_operands(screen=True)``) against
    gallery operands of B entries (B a block multiple, block-aligned)."""
    B, Rt, D = g["dec"].shape
    lv = L["lvalid"].double()
    rv = g["rvalid"].double()
    ld = L["ldes"] * lv[..., None]                       # [t, P, D]
    rd = g["rdes"] * rv[..., None]                       # [B, R, D]
    s = torch.einsum("tpd,brd->tbpr", ld, rd)
    minu = torch.minimum(
        torch.clamp(s.max(dim=3).values, min=0).sum(dim=2),
        torch.clamp(s.max(dim=2).values, min=0).sum(dim=2)).sum(dim=0)
    a1, a2 = screen_aug(g["rsq"], g["tvalid"], prec, cb)
    v = torch.einsum("id,brd->bir", L["x"], g["dec"]) + a1[:, None] \
        + a2[:, None]
    raw = prec.op(v.max(dim=2).values)                   # [B, n]
    t6 = (6.0 - L["lsq"]) - tau
    tex = (torch.clamp(2.0 * raw + t6[None], min=0)
           * L["xvalid"].double()[None]).sum(dim=1)
    out = minu + TEX_WEIGHT * tex
    return torch.where(g["empty"], torch.full_like(out, -1.0), out)


def screen_gallery(draws: Draws, lat_ops: list, prec: Precision,
                   cb: Codebook) -> torch.Tensor:
    """Screens [n_latents, Gp] of every padded gallery entry, the gallery
    drawn again chunk by chunk."""
    out = []
    for c in range(draws.n_chunks):
        g = gallery_operands(draws.chunk(c), prec, cb)
        B = g["dec"].shape[0]
        per = max(prec.block, (PAIR_ELEMS // max(
            1, max(L["x"].shape[0] for L in lat_ops) * draws.Rt))
            // prec.block * prec.block)
        cols = []
        for a in range(0, B, per):
            sub = {k: v[a:a + per] for k, v in g.items()}
            cols.append(torch.stack([screen_scores(L, sub, prec, cb)
                                     for L in lat_ops]))
        out.append(torch.cat(cols, dim=1))
        del g
    return torch.cat(out, dim=1)


# ---------------------------------------------------------------------------
# exact scores
# ---------------------------------------------------------------------------

def _greedy(S: torch.Tensor, eligible: torch.Tensor, li: torch.Tensor,
            ri: torch.Tensor, compat: torch.Tensor):
    """The spec's greedy one-to-one selection over N candidate lists:
    candidates by S descending (list position on ties); a candidate is
    taken when eligible, its two minutiae unused and compatible with every
    candidate taken before it. Returns (selected [N, K], rank [N, K]: the
    order of selection, -1 if not selected)."""
    N, K = S.shape
    dev = S.device
    order = torch.sort(S, dim=1, descending=True, stable=True).indices
    sel = torch.zeros((N, K), dtype=torch.bool, device=dev)
    rank = torch.full((N, K), -1, dtype=torch.long, device=dev)
    nl = int(li.max()) + 1 if li.numel() else 1
    nr = int(ri.max()) + 1 if ri.numel() else 1
    used_l = torch.zeros((N, nl), dtype=torch.bool, device=dev)
    used_r = torch.zeros((N, nr), dtype=torch.bool, device=dev)
    count = torch.zeros((N,), dtype=torch.long, device=dev)
    ar = torch.arange(N, device=dev)
    for k in range(K):
        c = order[:, k]
        ok = eligible[ar, c]
        if not bool(ok.any()):
            break
        lc, rc = li[ar, c], ri[ar, c]
        ok = ok & ~used_l[ar, lc] & ~used_r[ar, rc]
        ok = ok & (compat[ar, c] | ~sel).all(dim=1)
        n = ar[ok]
        sel[n, c[ok]] = True
        rank[n, c[ok]] = count[ok]
        count = count + ok.long()
        used_l[n, lc[ok]] = True
        used_r[n, rc[ok]] = True
    return sel, rank


def _unit_line(x: torch.Tensor, y: torch.Tensor):
    """(cos, sin) of -atan2(y_i - y_j, x_i - x_j) [N, K, K]; (1, 0) for
    coincident points."""
    dx = x[:, :, None] - x[:, None, :]
    dy = y[:, :, None] - y[:, None, :]
    r = torch.sqrt(dx * dx + dy * dy)
    zero = r == 0
    r = torch.where(zero, torch.ones_like(r), r)
    return (torch.where(zero, torch.ones_like(r), dx / r),
            torch.where(zero, torch.zeros_like(r), -dy / r))


def graph_filter(val, li, ri, valid, lxy, lori, rxy, rori, lookup: bool,
                 iters: int) -> torch.Tensor:
    """Both filter stages over N lists of K candidates (list order = slot
    order); ``lxy`` / ``lori`` [N, K, ...] are the slots' coordinates.
    Returns the scores [N]."""
    N, K = val.shape
    dev = val.device
    off = ~torch.eye(K, dtype=torch.bool, device=dev)[None]
    pair = valid[:, :, None] & valid[:, None, :] & off
    if lookup:
        def d(xy):
            dx = (xy[:, :, None, 0] - xy[:, None, :, 0]).abs()
            dy = (xy[:, :, None, 1] - xy[:, None, :, 1]).abs()
            return dx, dy, torch.sqrt((16.0 * dx) ** 2 + (16.0 * dy) ** 2)
        dxl, dyl, d1 = d(torch.trunc(lxy))
        dxr, dyr, d2 = d(torch.trunc(rxy))
        pair = pair & (dxl < LUT_N) & (dyl < LUT_N) & (dxr < LUT_N) \
            & (dyr < LUT_N)
    else:
        def d(xy):
            dx = xy[:, :, None, 0] - xy[:, None, :, 0]
            dy = xy[:, :, None, 1] - xy[:, None, :, 1]
            return torch.sqrt(dx * dx + dy * dy)
        d1, d2 = d(lxy), d(rxy)
    dist = (d1 - d2).abs()
    H = torch.where(pair & (dist <= DIST_THR),
                    torch.clamp((30.0 - dist) / 25.0, 0.0, 1.0),
                    torch.zeros_like(dist))
    b = torch.where(valid, val, torch.zeros_like(val))
    for _ in range(iters):
        c = torch.bmm(H, b[:, :, None])[:, :, 0]
        b = c / (c.sum(dim=1, keepdim=True) + 1e-5)
    sel1, rank1 = _greedy(b, valid & (b >= 1e-4), li, ri, H >= 1e-5)

    # stage 2 over the survivors, listed in their order of selection
    n2 = sel1.sum(dim=1)
    slot = torch.full((N, K + 1), K, dtype=torch.long, device=dev)
    nn, kk = torch.nonzero(sel1, as_tuple=True)
    slot[nn, rank1[nn, kk]] = kk
    slot = slot[:, :K]
    valid2 = torch.arange(K, device=dev)[None] < n2[:, None]
    safe = torch.where(valid2, slot, torch.zeros_like(slot))

    def g(t):
        idx = safe.reshape(safe.shape + (1,) * (t.dim() - 2))
        return torch.gather(t, 1, idx.expand((N, K) + t.shape[2:]))
    val2, li2, ri2 = g(val), g(li), g(ri)
    lxy2, lori2, rxy2, rori2 = g(lxy), g(lori), g(rxy), g(rori)
    v = lori2 - rori2
    cv, sv = torch.cos(v), torch.sin(v)
    t1 = (cv[:, :, None] * cv[:, None, :] + sv[:, :, None] * sv[:, None, :]) \
        >= COS_PI_4
    cl, sl = _unit_line(lxy2[..., 0], lxy2[..., 1])
    cr, sr = _unit_line(rxy2[..., 0], rxy2[..., 1])
    cu, su = cl * cr + sl * sr, sl * cr - cl * sr
    t2 = (cv[:, :, None] * cu + sv[:, :, None] * su) >= COS_PI_6
    t3 = (cv[:, None, :] * cu + sv[:, None, :] * su) >= COS_PI_6
    H2 = t1 & t2 & t3 & valid2[:, :, None] & valid2[:, None, :] & off
    S = torch.where(valid2, 1.0 / torch.clamp(n2, min=1).double()[:, None],
                    torch.zeros_like(val2))
    H2f = H2.double()
    for _ in range(5):
        s1 = torch.bmm(H2f, S[:, :, None])[:, :, 0]
        S = s1 / (s1.sum(dim=1, keepdim=True) + 1e-5)
    sel2, _ = _greedy(S, valid2 & (S >= 1e-3), li2, ri2, H2)
    return torch.where(sel2, val2, torch.zeros_like(val2)).sum(dim=1)


def minutiae_candidates(L: dict, t: int, g: dict, row_cap: int) -> dict:
    """Latent template ``t`` against N entries' minutiae -> the N
    candidate lists the filter takes (``graph_filter``'s arguments)."""
    ldes, lv = L["ldes"][t], L["lvalid"][t]
    rdes, rv = g["rdes"], g["rvalid"]
    N, R, _ = rdes.shape
    P = ldes.shape[0]
    pair = lv[None, :, None] & rv[:, None, :]
    simi = torch.clamp(torch.einsum("pd,nrd->npr", ldes, rdes), min=0) \
        * pair.double()
    row = simi.sum(dim=2, keepdim=True)
    col = simi.sum(dim=1, keepdim=True)
    norm = torch.where(pair, simi / (row + col - simi + 1e-6),
                       torch.full_like(simi, -math.inf))
    if row_cap < R:
        top = torch.sort(norm, dim=2, descending=True,
                         stable=True).indices[:, :, :row_cap]
        keep = torch.zeros_like(pair).scatter_(2, top, True)
        norm = torch.where(keep, norm, torch.full_like(norm, -math.inf))
    K = min(TOPN_MINU, P * R)
    v, i = torch.sort(norm.reshape(N, P * R), dim=1, descending=True,
                      stable=True)
    v, i = v[:, :K], i[:, :K]
    li, ri = i // R, i % R
    return dict(
        val=torch.gather(simi.reshape(N, P * R), 1, i), li=li, ri=ri,
        valid=v > -math.inf, lxy=L["lxy"][t][li], lori=L["lori"][t][li],
        rxy=torch.gather(g["rxy"], 1, ri[..., None].expand(N, K, 2)),
        rori=torch.gather(g["rori"], 1, ri))


def texture_candidates(L: dict, g: dict) -> dict:
    """The latent's texture template against N entries -> the N candidate
    lists the filter takes."""
    N, Rt, _ = g["dec"].shape
    n = L["x"].shape[0]
    simi = 2.0 * torch.einsum("id,njd->nij", L["x"], g["dec"]) \
        + ((6.0 - L["lsq"])[None, :, None] - g["rsq"][:, None, :])
    simi = torch.where(g["tvalid"][:, None, :], simi,
                       torch.full_like(simi, -math.inf))
    best = simi.max(dim=2).values                            # [N, n]
    bestj = torch.where(simi == best[..., None],
                        torch.arange(Rt, device=simi.device),
                        Rt).min(dim=2).values
    del simi
    rowok = L["xvalid"][None, :] & g["tvalid"].any(dim=1)[:, None]
    best = torch.where(rowok, best, torch.full_like(best, -math.inf))
    K = min(TOPN_TEX, n)
    nvalid = rowok.sum(dim=1)
    by_value = torch.sort(best, dim=1, descending=True, stable=True).indices
    by_row = torch.sort((~rowok).long(), dim=1, stable=True).indices
    order = torch.where((nvalid > K)[:, None], by_value, by_row)[:, :K]
    val = torch.gather(best, 1, order)
    valid = val > -math.inf
    ri = torch.gather(bestj, 1, order)
    ri = torch.where(valid, ri, torch.zeros_like(ri))
    return dict(
        val=torch.where(valid, val, torch.zeros_like(val)), li=order, ri=ri,
        valid=valid, lxy=L["txy"][order], lori=L["tori"][order],
        rxy=torch.gather(g["txy"], 1, ri[..., None].expand(N, K, 2)),
        rori=torch.gather(g["tori"], 1, ri))


def _filtered(lists: list, lookup: bool, iters: int) -> torch.Tensor:
    """``graph_filter`` over candidate lists gathered piece by piece, run
    on FILTER_LISTS lists at a time."""
    cat = {k: torch.cat([c[k] for c in lists]) for k in lists[0]}
    N = cat["val"].shape[0]
    return torch.cat([graph_filter(
        **{k: v[a:a + FILTER_LISTS] for k, v in cat.items()},
        lookup=lookup, iters=iters) for a in range(0, N, FILTER_LISTS)])


def exact_scores(L: dict, g: dict, row_cap: int) -> torch.Tensor:
    """Fused scores [N] of one latent against N entries' operands."""
    N, Rt = g["dec"].shape[:2]
    T = L["ldes"].shape[0]
    per = max(1, PAIR_ELEMS // (max(L["x"].shape[0], L["ldes"].shape[1])
                                * max(Rt, g["rdes"].shape[1])))
    minu = [[] for _ in range(T)]
    tex = []
    for a in range(0, N, per):
        sub = {k: v[a:a + per] for k, v in g.items()}
        for t in range(T):
            minu[t].append(minutiae_candidates(L, t, sub, row_cap))
        tex.append(texture_candidates(L, sub))
    s = sum(_filtered(m, lookup=False, iters=5) for m in minu)
    s = s + TEX_WEIGHT * _filtered(tex, lookup=True, iters=3)
    return torch.where(g["empty"], torch.full_like(s, -1.0), s)


# ---------------------------------------------------------------------------
# the pipeline, for the control
# ---------------------------------------------------------------------------

def serve(draws: Draws, latents: list, mix: dict, prec: Precision,
          cb: Optional[Codebook] = None):
    """The serving path computed by the reference for pool latents
    ``latents``: (kept idx [n, m_pad], exact scores of the kept [n, m_pad]),
    as the program's ``match_scores_batch_reranked`` returns them."""
    cb = cb or Codebook(draws.codebook, prec, draws.device)
    pre = mix.get("prescreen") or {}
    lt_cap, t_cap = int(pre.get("lt", 0)), int(pre.get("t", 0))
    ops_s = [latent_operands(draws.latents, i, prec, cb, screen=True,
                             lt_cap=lt_cap, t_cap=t_cap) for i in latents]
    scr = screen_gallery(draws, ops_s, prec, cb)
    m_pad = kept_count(draws.Gp, int(mix["m"]), prec.block)
    idx = torch.sort(scr, dim=1, descending=True, stable=True) \
        .indices[:, :m_pad]
    exact = exact_for(draws, latents, idx, prec, cb)
    return idx, exact


def kept_count(Gp: int, m: int, block: int) -> int:
    """m_pad: m rounded up to a block multiple, at most the gallery."""
    return min(-(-min(m, Gp) // block) * block, Gp)


def exact_for(draws: Draws, latents: list, idx: torch.Tensor,
              prec: Precision, cb: Codebook) -> torch.Tensor:
    """Exact fused scores [n, k] of pool latents ``latents`` against the
    gallery positions ``idx`` [n, k], the rows drawn again."""
    flat = idx.reshape(-1).to(draws.device)
    g = gallery_operands(draws.rows(flat), prec, cb)
    k = idx.shape[1]
    out = []
    for j, i in enumerate(latents):
        L = latent_operands(draws.latents, i, prec, cb)
        sub = {key: v[j * k:(j + 1) * k] for key, v in g.items()}
        out.append(exact_scores(L, sub, prec.row_cap))
    return torch.stack(out)
