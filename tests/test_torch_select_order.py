"""The orders of the redesigned minutiae_match / texture_match kernels,
modelled on the CPU against the plain versions.

The card's kernels (csrc/minutiae_match.cu, csrc/texture_match.cu and the
filter body csrc/filter_body.cuh) must equal ops.minutiae_match_plain and
ops.texture_match_plain bit for bit, yet they reach each result another
way than the plain versions. Here each of those ways runs on the CPU in
PyTorch, step for step, and is held against the plain version on the same
inputs:

- the bisect on the (K + 1)-th largest candidate value: the kernels find
  that value by a radix select on the floats' order keys (four 8-bit
  passes) and run the 26 steps mid = 0.5 (lo + hi) in registers, keeping
  lo when the value is > mid; ops.select_slots counts the values > mid at
  every step. Same lo, hi and slot set on the minutiae candidate tables
  and the texture row maxima, random and tie-heavy (duplicated descriptor
  rows, quantized coordinates), with C <= K, all-equal values and SENT
  rows;
- the extraction: 8 lanes per latent row holding columns lg + 8u in
  registers (a tree argmax per lane, left wins on ties) or a warp per row
  scanning columns lane + 32u with a strict >, then a butterfly of
  shuffles keeping the larger value, the lower column on ties; the
  [row_cap, P] table equals row_candidates (minutiae_match.py), rows with
  fewer valid columns than row_cap included (they take column 0 again);
- H1 symmetric bit for bit, on the lookup grid and with float distances,
  duplicate coordinates included (one table serves both triangles), and
  the circulant half table's reads equal to the full matrix;
- the greedy selection: candidates sorted by the greedy order (a bitonic
  sort in the kernel), blockers in rank space, decided in rank order 32 at
  a time, equal to graph_filter.greedy_one_to_one's parallel rounds;
- the stage-2 angle matrix built on the pairs b > a and mirrored, except
  where exactly one side's points coincide, equal to build_angle_H.
"""
import numpy as np
import pytest
import torch

from msu_latentafis_tpu_torch.matcher import graph_filter as gf
from msu_latentafis_tpu_torch.matcher.kernels import ops
from msu_latentafis_tpu_torch.matcher.minutiae_match import (
    SENT, minutiae_similarity, mutual_normalize, row_candidates)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch on one intra-op thread: the suite's workers share the host's
    cores, and an intra-op pool in each spins waiting on the others (a
    test ran 7x slower with 8 threads than with 1 beside 8 busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

F32 = torch.float32


# ---------------------------------------------------------------------------
# the bisect on the (K + 1)-th largest value

def order_keys(x: torch.Tensor) -> torch.Tensor:
    """filter_body.cuh order_key: the floats' total order as int64 keys
    (-0 just below +0), NaN the bottom (0)."""
    u = x.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    key = torch.where(u >= 0x80000000, (~u) & 0xFFFFFFFF, u | 0x80000000)
    return torch.where(torch.isnan(x), torch.zeros_like(key), key)


def key_values(key: torch.Tensor) -> torch.Tensor:
    u = torch.where(key >= 0x80000000, key & 0x7FFFFFFF, (~key) & 0xFFFFFFFF)
    return u.to(torch.int64).to(torch.int32).view(F32)


def radix_kth(x: torch.Tensor, k: int) -> torch.Tensor:
    """kth_largest, pass for pass: per row the (k + 1)-th largest value by
    four 8-bit digit histograms from the top, NaN when a row has <= k."""
    N, n = x.shape
    keys = order_keys(x)
    out = torch.full((N,), float("nan"))
    if n <= k:
        return out
    res = torch.empty(N, dtype=torch.int64)
    for r in range(N):
        prefix, pmask, t = 0, 0, k
        for shift in (24, 16, 8, 0):
            live = keys[r][(keys[r] & pmask) == prefix]
            hist = torch.bincount((live >> shift) & 255, minlength=256)
            above = 0
            for d in range(255, -1, -1):      # warp 0's descending scan
                if above + int(hist[d]) > t:
                    break
                above += int(hist[d])
            t -= above
            prefix |= d << shift
            pmask |= 255 << shift
        res[r] = prefix
    return key_values(res)


def register_bisect(kth: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """bisect_window: the 26 steps on the (K + 1)-th largest value."""
    for _ in range(ops.BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        go = kth > mid
        lo, hi = torch.where(go, mid, lo), torch.where(go, hi, mid)
    return lo, hi


def counting_bisect(cand, K, lo, hi):
    """ops.select_slots' bisect: count(> mid) > K at every step."""
    for _ in range(ops.BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        big = (cand > mid[:, None]).sum(dim=1) > K
        lo, hi = torch.where(big, mid, lo), torch.where(big, hi, mid)
    return lo, hi


def check_bisect(cand, K, lo0, hi0, band_key=None):
    kth = radix_kth(cand, K)
    if cand.shape[1] > K:
        want = torch.sort(cand, dim=1, descending=True).values[:, K]
        assert torch.equal(kth, want)         # as floats: -0 == +0
    lo, hi = register_bisect(kth, lo0.clone(), hi0.clone())
    wlo, whi = counting_bisect(cand, K, lo0.clone(), hi0.clone())
    assert torch.equal(lo, wlo) and torch.equal(hi, whi)
    # the slots that follow from this window: those of select_slots
    got = ops.select_slots(cand, K, lo, hi, band_key)
    want = ops.select_slots(cand, K, lo0.clone(), hi0.clone(), band_key)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def minutiae_tables(seed, NT, B, P, R, row_cap, ties=False, D=32):
    """The [N, row_cap P] candidate tables (value, column, similarity) of
    minutiae_match_plain's selection, and the band keys p R + r."""
    rng = np.random.default_rng(seed)
    ld = rng.standard_normal((NT, P, D)).astype(np.float32)
    rd = rng.standard_normal((B, R, D)).astype(np.float32)
    rd[0, :min(P, R)] = ld[0, :min(P, R)] \
        + 0.3 * rng.standard_normal((min(P, R), D))
    if ties:
        ld[:, 1::2] = ld[:, 0:P - 1:2]
        rd[:, 1::2] = rd[:, 0:R - 1:2]
        ld, rd = np.round(ld * 2) / 2, np.round(rd * 2) / 2
    lv = (rng.random((NT, P)) > 0.2).astype(np.float32)
    rv = (rng.random((B, R)) > 0.2).astype(np.float32)
    ld, lv, rd, rv = (torch.as_tensor(a) for a in (ld, lv, rd, rv))
    simi = minutiae_similarity(ld, lv, rd, rv)
    pair = (lv[:, None, :, None] > 0.5) & (rv[None, :, None, :] > 0.5)
    normm = torch.where(pair, mutual_normalize(simi),
                        torch.full_like(simi, SENT))
    cv, cr, cs = row_candidates(normm, simi, row_cap)
    N, C = NT * B, row_cap * P
    prow = torch.arange(P).repeat(row_cap).expand(N, C)
    return (cv.reshape(N, C), cr.reshape(N, C), cs.reshape(N, C),
            prow * R + cr.reshape(N, C), normm, simi)


@pytest.mark.parametrize("P,R,row_cap,ties", [
    (64, 96, 8, False), (64, 96, 8, True), (16, 40, 40, False),
    (8, 96, 8, False), (8, 96, 8, True)])
def test_minutiae_bisect_on_kth_value(P, R, row_cap, ties):
    """The minutiae tables: random, tie-heavy, row_cap = R and C < K (no
    (K + 1)-th value: the window stays [-1, 1.0000001] halved down)."""
    cv, _, _, key, _, _ = minutiae_tables(P * R + row_cap, 2, 3, P, R,
                                          row_cap, ties)
    N, K = cv.shape[0], min(120, P * R)
    check_bisect(cv, K, torch.full((N,), -1.0), torch.full((N,), 1.0000001),
                 band_key=key)


@pytest.mark.parametrize("variant", ["random", "ties", "equal", "sent",
                                     "k_eq_lt"])
def test_texture_bisect_on_kth_value(variant):
    """The texture row maxima with texture_match_plain's window [min valid
    - 1, max + 1]: random, on a 0.5 grid, all equal, mostly SENT rows and
    K = Lt."""
    rng = np.random.default_rng(len(variant))
    NL, B, Lt = 2, 4, 150 if variant == "k_eq_lt" else 448
    best = rng.normal(0.0, 3.0, (NL, B, Lt)).astype(np.float32)
    if variant == "ties":
        best = np.round(best * 2) / 2
    if variant == "equal":
        best[:] = 1.5
    lvalid = rng.random((NL, Lt)) > (0.7 if variant == "sent" else 0.1)
    best, lvalid = torch.as_tensor(best), torch.as_tensor(lvalid).float()
    K = min(200, Lt)
    bm = torch.where(lvalid[:, None, :] > 0.5, best,
                     torch.full_like(best, ops.TEX_SENT)).reshape(-1, Lt)
    minv = torch.where(bm > ops.TEX_SENT + 1.0, bm,
                       torch.full_like(bm, 1e30)).min(dim=1).values
    check_bisect(bm, K, torch.clamp(minv - 1.0, min=ops.TEX_SENT),
                 bm.max(dim=1).values + 1.0)


def test_order_keys_round_trip():
    """Keys order the floats as < does, -0 below +0, and map back."""
    x = torch.tensor([-np.inf, -3.0, -1e-30, -0.0, 0.0, 1e-30, 2.5, np.inf],
                     dtype=F32)
    k = order_keys(x)
    assert bool((k[1:] > k[:-1]).all())
    assert torch.equal(key_values(k).view(torch.int32), x.view(torch.int32))
    assert int(order_keys(torch.tensor([float("nan")]))[0]) == 0


# ---------------------------------------------------------------------------
# the extraction

def group_extract(normm, simi, row_cap, G, registers):
    """The kernels' extraction on [P, R]: G lanes per row; each lane holds
    columns lg + G u (a tree argmax over its slots, left wins, in the
    register path; a strict > scan in column order in the memory path);
    then a butterfly over the G lanes keeping the larger value and the
    lower column on ties; the winner becomes SENT."""
    P, R = normm.shape
    U = 16 if registers else -(-R // G)         # kRegCols slots a lane
    pad = torch.full((P, U * G), -np.inf)
    pad[:, :R] = normm
    v = pad.reshape(P, U, G).transpose(1, 2).clone()     # [P, lane, slot]
    cols = (torch.arange(G)[:, None] + G * torch.arange(U)[None, :])
    cv = torch.empty(row_cap, P)
    cr = torch.empty(row_cap, P, dtype=torch.long)
    cs = torch.empty(row_cap, P)
    for c in range(row_cap):
        if registers:                      # tree over slots, left wins
            tv, tu = v.clone(), cols.expand(P, G, U).clone()
            while tv.shape[-1] > 1:
                right = tv[..., 1::2] > tv[..., 0::2]
                tv = torch.where(right, tv[..., 1::2], tv[..., 0::2])
                tu = torch.where(right, tu[..., 1::2], tu[..., 0::2])
            bv, bi = tv[..., 0], tu[..., 0]
        else:                              # strict > in column order
            bv = v[..., 0].clone()
            bi = cols[:, 0].expand(P, G).clone()
            for u in range(1, U):
                take = v[..., u] > bv
                bv = torch.where(take, v[..., u], bv)
                bi = torch.where(take, cols[:, u].expand(P, G), bi)
        off = G // 2
        while off:
            lanes = torch.arange(G) ^ off
            ov, oi = bv[:, lanes], bi[:, lanes]
            take = (ov > bv) | ((ov == bv) & (oi < bi))
            bv, bi = torch.where(take, ov, bv), torch.where(take, oi, bi)
            off //= 2
        assert bool((bv == bv[:, :1]).all()) and bool((bi == bi[:, :1]).all())
        p = torch.arange(P)
        cv[c], cr[c], cs[c] = bv[:, 0], bi[:, 0], simi[p, bi[:, 0]]
        v[p, bi[:, 0] % G, bi[:, 0] // G] = SENT
    return cv, cr, cs


@pytest.mark.parametrize("P,R,row_cap,ties", [
    (64, 96, 8, False), (64, 96, 8, True), (32, 128, 8, False),
    (16, 12, 12, False), (8, 1000, 8, False), (8, 40, 40, True)])
def test_group_extraction_equals_row_candidates(P, R, row_cap, ties):
    """Both extraction paths give row_candidates' [row_cap, P] table bit
    for bit; R = 12 < row_cap and mostly invalid rows run out of valid
    columns (SENT rounds take column 0 again)."""
    *_, normm, simi = minutiae_tables(P + R, 1, 2, P, R, row_cap, ties)
    normm, simi = normm[0, 1], simi[0, 1]
    normm[:3, 4:] = SENT                       # rows with 4 valid columns
    wv, wr, ws = row_candidates(normm, simi, row_cap)
    paths = [(8, True)] if R <= 128 else []
    paths.append((32, False))
    for G, registers in paths:
        gv, gr, gs = group_extract(normm, simi, row_cap, G, registers)
        assert torch.equal(gv, wv) and torch.equal(gr, wr) \
            and torch.equal(gs, ws), (G, registers)
    assert bool((wr[4:, :3] == 0).all())       # exhausted rows: column 0


# ---------------------------------------------------------------------------
# H1 symmetric bit for bit; the half table

def grid_sets(rng, N, K, lookup, dup):
    hi = 30 if lookup else 480
    lxy = rng.integers(0, hi, (N, K, 2)).astype(np.float32)
    rxy = rng.integers(0, hi, (N, K, 2)).astype(np.float32)
    if not lookup:
        lxy += rng.random((N, K, 2)).astype(np.float32)
        rxy += rng.random((N, K, 2)).astype(np.float32)
    if dup:                                    # duplicate coordinates
        lxy[:, 1::3], rxy[:, 2::3] = lxy[:, 0:K - 1:3], rxy[:, 0:K - 2:3]
    o = rng.uniform(-np.pi, np.pi, (2, N, K)).astype(np.float32)
    lp = gf.coord_pack(torch.as_tensor(lxy), torch.as_tensor(o[0]))
    rp = gf.coord_pack(torch.as_tensor(rxy), torch.as_tensor(o[1]))
    return lp, rp, torch.as_tensor(rng.random((N, K)) > 0.15)


@pytest.mark.parametrize("lookup", [True, False])
@pytest.mark.parametrize("K", [120, 200, 7])
def test_h1_symmetric_and_half_table(lookup, K):
    """H1 == H1^T bit for bit (duplicate coordinates included), and the
    circulant half table (row i, column d - 1: H1(i, i + d mod K), d <= K
    / 2) read back as the kernel reads it equals H1."""
    lp, rp, valid = grid_sets(np.random.default_rng(K), 6, K, lookup,
                              dup=True)
    H = gf.build_dist_H(lp, rp, valid, lookup)
    assert torch.equal(H, H.transpose(1, 2))
    half = K // 2
    i = torch.arange(K)[:, None]
    d = torch.arange(1, half + 1)[None, :]
    table = H[:, i, (i + d) % K]                         # [N, K, half]
    j = torch.arange(K)[None, :]
    dd = (j - i) % K
    row = torch.where(dd <= half, i.expand(K, K), j.expand(K, K))
    col = torch.where(dd <= half, dd - 1, K - dd - 1)
    got = table[:, row, col.clamp(min=0)]
    got = torch.where(dd == 0, torch.zeros_like(got), got)
    assert torch.equal(got, H)


# ---------------------------------------------------------------------------
# the greedy in rank order; the mirrored angle matrix

def rank_order_greedy(S, bad, eligible, tie_keys):
    """The kernel's greedy: eligible candidates sorted by the greedy order
    (support, tie keys descending, slot ascending), blockers in rank space,
    ranks decided 32 at a time (earlier chunks' selections tested first,
    the chunk's own ranks in order)."""
    N, K = S.shape
    sel = torch.zeros_like(eligible)
    for n in range(N):
        idx = [i for i in range(K) if eligible[n, i]]
        keys = lambda i: tuple(-float(k[n, i]) for k in (S,) + tuple(tie_keys))
        order = sorted(idx, key=lambda i: keys(i) + (i,))
        chosen = []
        for c in range(0, len(order), 32):
            chunk = order[c:c + 32]
            hit = [any(bad[n, i, j] for j in chosen) for i in chunk]
            S_chunk = []
            for k, i in enumerate(chunk):
                if not hit[k] and not any(bad[n, i, j] for j in S_chunk):
                    S_chunk.append(i)
            chosen += S_chunk
        sel[n, chosen] = True
    return sel


@pytest.mark.parametrize("ties", [False, True])
def test_rank_order_greedy_equals_rounds(ties):
    """Sequential in rank order (the kernel) == greedy_one_to_one's
    parallel rounds, with tied supports broken by the tie keys and slot."""
    rng = np.random.default_rng(7 + ties)
    N, K = 4, 70
    S = torch.as_tensor(rng.random((N, K)).astype(np.float32))
    t0 = torch.as_tensor(rng.random((N, K)).astype(np.float32))
    t1 = torch.as_tensor(-rng.permutation(K * N).reshape(N, K)
                         .astype(np.float32))
    if ties:
        S, t0 = torch.round(S * 3) / 3, torch.round(t0 * 2) / 2
    bad = torch.as_tensor(rng.random((N, K, K)) < 0.08)
    bad = (bad | bad.transpose(1, 2)) & ~torch.eye(K, dtype=torch.bool)
    elig = torch.as_tensor(rng.random((N, K)) > 0.1)
    want = gf.greedy_one_to_one(S, bad, elig, (t0, t1))
    assert torch.equal(rank_order_greedy(S, bad, elig, (t0, t1)), want)


def test_angle_matrix_mirrored_equals_plain():
    """build_angle_H is symmetric wherever both or neither side's points
    coincide, so the kernel's pairs b > a plus mirrored bits, with the
    asymmetric pairs tested directly, give it bit for bit."""
    lp, rp, _ = grid_sets(np.random.default_rng(3), 5, 90, True, dup=True)
    sel = torch.ones(5, 90, dtype=torch.bool)
    H = gf.build_angle_H(lp, rp, sel)
    zl = gf._pairdiff(lp[..., 0]) ** 2 + gf._pairdiff(lp[..., 1]) ** 2 == 0
    zr = gf._pairdiff(rp[..., 0]) ** 2 + gf._pairdiff(rp[..., 1]) ** 2 == 0
    asym = zl != zr
    assert bool(asym.any())
    upper = torch.triu(torch.ones(90, 90, dtype=torch.bool), 1)
    got = torch.where(upper, H, H.transpose(1, 2))
    got = torch.where(asym & ~upper, H, got)
    assert torch.equal(got, H)


@pytest.mark.parametrize("K", [64, 120, 127, 200, 256])
def test_zone_row_dot_reads_every_entry(K):
    """h1_row_dot over the half table: for each warp of 32 rows, runs with a
    running index (stride 1 on row i, S - 1 on row j) between three zones
    of per-read indices; every (i, j) read lands on H1(i, j), so the row
    sums in index order equal the plain power iteration's."""
    lp, rp, valid = grid_sets(np.random.default_rng(K + 1), 1, K, True,
                              dup=False)
    H = gf.build_dist_H(lp, rp, valid, True)[0]
    half = K // 2
    S = half + (half & 1)
    i_ = torch.arange(K)[:, None]
    d = torch.arange(1, half + 1)[None, :]
    table = torch.zeros(K * S)
    table.view(K, S)[:, :half] = H[i_, (i_ + d) % K]

    def index(i, j):
        dd = (j - i) % K
        return i * S + dd - 1 if dd <= half else j * S + (K - dd) - 1

    b = torch.as_tensor(np.random.default_rng(K).random(K).astype(np.float32))
    got = torch.empty(K)
    for i in range(K):
        i0, i1 = i & ~31, min((i & ~31) + 31, K - 1)
        acc, j = torch.zeros(()), 0
        for z in range(7):
            off = half - K + 1 if z < 2 else (z & 1) if z < 4 else half + 1
            end = K if z == 6 else min(max((i1 if z & 1 else i0) + off, 0), K)
            if j >= end:
                continue
            if z & 1:
                for jj in range(j, end):
                    h = 0.0 if jj == i else table[index(i, jj)]
                    acc = acc + h * b[jj]
            else:
                a, inc = index(i, j), (S - 1 if z & 2 else 1)
                for u, jj in enumerate(range(j, end)):
                    assert a + u * inc == index(i, jj)
                    acc = acc + table[a + u * inc] * b[jj]
            j = end
        got[i] = acc
    want = gf.seq_sum(H[None] * b[None, None, :], dim=2)[0]
    assert torch.equal(got, want)
