"""The H1 probe kernel's schedule (csrc/h1_probe.cu), modelled in plain
PyTorch on the CPU, against the probe's plain version.

The kernel forms each unordered pair of valid slots once, in 2 x 2 tiles,
skips the invalid slots, clamps 30 - dist to [0, 25] so that one division
serves every case, keeps the tiles of a strip of the upper triangle in a
folded layout and sums every row, then the rows, in index order. The
model below takes the same steps with the same arithmetic: the valid
slots compacted and padded to an even count, the strips the kernel's
budget gives (``ops.h1_plan`` for the H100, and the smallest budget, one
tile row a strip), the folded tile addresses and the reads of the row and
column sums. Unwritten storage and each diagonal tile's unused lower term
hold NaN, so a read of a wrong address shows in the result. (The kernel's
square root is the compiler's sequence, checked on the card by
``afis_h1_sqrt_check``; here the correctly rounded ``sqrt_rn``.) It must equal
``ops.h1_probe_plain`` bit for bit (``torch.equal``) for all three variants:
at the probe's inputs, with all-invalid sets, with duplicated points (dist
exactly 0, 5 and 30) and at ragged K up to the kernel's cap.
"""
import numpy as np
import pytest
import torch

from msu_latentafis_tpu_torch.matcher.graph_filter import sqrt_rn
from msu_latentafis_tpu_torch.matcher.kernels import ops
from msu_latentafis_tpu_torch.scripts import microbench_h1_probe


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch on one intra-op thread: the suite's workers share the host's
    cores, and an intra-op pool in each spins waiting on the others (a
    test ran 7x slower with 8 threads than with 1 beside 8 busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _side(xa, ya, sa, xb, yb, sb, gram):
    if gram:
        q = sa + sb
        q = q + (-2.0 * xa) * xb
        q = q + (-2.0 * ya) * yb
        return sqrt_rn(torch.clamp(q, min=0.0))
    dx, dy = xa - xb, ya - yb
    return sqrt_rn(dx * dx + dy * dy)


def _term(P, a, b, gram):
    """csrc/h1_probe.cu's term(a, b) over index tensors a, b."""
    x1, y1, x2, y2, v, s1, s2 = P
    d1 = _side(x1[a], y1[a], s1[a], x1[b], y1[b], s1[b], gram)
    d2 = _side(x2[a], y2[a], s2[a], x2[b], y2[b], s2[b], gram)
    dd = (d1 - d2).abs()
    num = torch.clamp(30.0 - dd, 0.0, 25.0)
    h1 = num / torch.full_like(num, 25.0)
    return h1 * (v[b] * v[a])


def schedule_model(lx, ly, rx, ry, vf, variant, budget):
    """The kernel's schedule, one set at a time -> [NP] f32."""
    NP, K = lx.shape
    assert budget % 4 == 0 and budget >= 4 * ((K + 2) // 2)
    gram = variant == "gram"
    out = torch.empty(NP)
    for s in range(NP):
        keep = torch.nonzero(vf[s] != 0).flatten()     # index order
        n = len(keep)
        # the compacted slots and, for odd n, the spare slot (vf 0)
        x1, y1, x2, y2, v = (torch.cat([t[s, keep], torch.zeros(n & 1)])
                             for t in (lx, ly, rx, ry, vf))
        P = (x1, y1, x2, y2, v, x1 * x1 + y1 * y1, x2 * x2 + y2 * y2)
        acc = torch.zeros(n)
        total = torch.zeros(())
        T = (n + 1) // 2
        R0 = 0
        while R0 < T:
            remT = T - R0
            H = remT if 2 * remT * (remT + 1) <= budget \
                else budget // (4 * remT)
            R1, half = R0 + H, H // 2
            Lt = remT + (T - R1) + 1
            size = half * Lt + (remT - half if H & 1 else 0)
            assert 1 <= H and 4 * size <= budget
            i = torch.arange(H)
            f = torch.minimum(i, H - 1 - i)
            tilebase = 4 * (f * Lt - (R0 + i)
                            + torch.where(i == f, 0, remT - f))
            # the block's walk over tiles: p = f Lt + col
            p = torch.arange(size)
            fp, col = p // Lt, p % Lt
            len1 = remT - fp
            first = col < len1
            R = torch.where(first, R0 + fp, R1 - 1 - fp)
            C = R + torch.where(first, col, col - len1)
            want = {(r, c) for r in range(R0, R1) for c in range(r, T)}
            got = list(zip(R.tolist(), C.tolist()))
            assert len(got) == len(want) and set(got) == want
            assert torch.equal(4 * p, tilebase[R - R0] + 4 * C)
            S = torch.full((budget,), float("nan"))
            for e in range(4):                  # element 2 i + j: (2R+i, 2C+j)
                S[4 * p + e] = _term(P, 2 * R + e // 2, 2 * C + e % 2, gram)
            # a diagonal tile's lower term (element 2) is never read
            S[4 * p[R == C] + 2] = float("nan")
            r0, r1 = 2 * R0, min(2 * R1, n)

            def at(r, c):                       # pair (r, c), r <= c
                return tilebase[(r >> 1) - R0] + 4 * (c >> 1) + 2 * (r & 1) \
                    + (c & 1)
            # the strip's rows: positions r0 .. n - 1 in order; a position
            # c < r reads the pair (c, r), the rest the row's own pairs
            rows = torch.arange(r0, r1)
            for c in range(r0, n):
                cc = torch.full_like(rows, c)
                low = cc < rows
                idx = torch.where(low, at(torch.where(low, cc, rows),
                                          torch.where(low, rows, cc)),
                                  at(rows, torch.maximum(cc, rows)))
                acc[rows] = acc[rows] + S[idx]
            # the later rows: positions r0 .. r1 - 1 in order
            cols = torch.arange(r1, n)
            for r in range(r0, r1):
                acc[cols] = acc[cols] + S[at(torch.full_like(cols, r), cols)]
            for r in range(r0, r1):             # thread 0's fold
                total = total + acc[r]
            R0 = R1
        out[s] = total
    return out


def _budgets(K):
    """The H100 plan's budget and the smallest (one tile row a strip)."""
    return sorted({ops.h1_plan(K)["budget"], 4 * ((K + 2) // 2)})


def _assert_model(a, variant):
    want = ops.h1_probe_plain(**a, variant=variant)
    K = a["lx"].shape[1]
    for budget in _budgets(K):
        got = schedule_model(**a, variant=variant, budget=budget)
        assert torch.equal(got, want), (variant, budget, got, want)
    assert torch.equal(ops.h1_probe(**a, variant=variant), want)


@pytest.mark.parametrize("variant", ops.H1_VARIANTS)
def test_schedule_equals_plain_at_probe_inputs(variant):
    a = microbench_h1_probe.make_inputs(np.random.default_rng(0), "cpu",
                                        NP=6)
    a["vf"][2] = 0.0                    # an all-invalid set
    a["vf"][4] = 1.0                    # an all-valid set
    _assert_model(a, variant)


def _dup_points():
    """Sets whose pairs sit exactly at dist 0, 5 and 30: duplicated points
    on the rolled side, latent pairs 0, 5 (3-4-5) and 30 (18-24-30)
    apart, and a slot past every band."""
    lat = [(0, 0), (3, 4), (18, 24), (0, 0), (3, 4), (40, 0), (6, 8)]
    rol = [(7, 7)] * len(lat)
    K = len(lat)
    lx = torch.tensor([[p[0] for p in lat]] * 3, dtype=torch.float32)
    ly = torch.tensor([[p[1] for p in lat]] * 3, dtype=torch.float32)
    rx = torch.tensor([[p[0] for p in rol]] * 3, dtype=torch.float32)
    ry = torch.tensor([[p[1] for p in rol]] * 3, dtype=torch.float32)
    vf = torch.ones((3, K))
    vf[1, 1] = 0.0
    vf[2] = torch.tensor([1.0, 0.5, 2.0, 0.0, 1.0, 3.0, 0.25])
    return dict(lx=lx, ly=ly, rx=rx, ry=ry, vf=vf)


@pytest.mark.parametrize("variant", ops.H1_VARIANTS)
def test_schedule_equals_plain_at_band_edges(variant):
    a = _dup_points()
    d = (ops._probe_dist(a["lx"], a["ly"], "bcast")
         - ops._probe_dist(a["rx"], a["ry"], "bcast")).abs()
    assert {0.0, 5.0, 30.0} <= set(d.flatten().tolist())
    _assert_model(a, variant)
    # and the rolled side's own duplicates against a spread latent side
    b = dict(a, lx=a["rx"], ly=a["ry"], rx=a["lx"], ry=a["ly"])
    _assert_model(b, variant)


@pytest.mark.parametrize("K", [1, 31, 257, 1024])
@pytest.mark.parametrize("variant", ops.H1_VARIANTS)
def test_schedule_equals_plain_at_ragged_K(K, variant):
    rng = np.random.default_rng(K)
    NP = 1 if K > 300 else 2 if K > 200 else 4
    a = {k: torch.as_tensor(rng.uniform(0, 30, (NP, K)).astype(np.float32))
         for k in ("lx", "ly", "rx", "ry")}
    a["vf"] = torch.as_tensor((rng.random((NP, K)) > 0.15)
                              .astype(np.float32))
    if K > 300:
        _assert_model_budget(a, variant, ops.h1_plan(K)["budget"])
    else:
        a["vf"][-1] = 0.0                   # an all-invalid set
        _assert_model(a, variant)


def _assert_model_budget(a, variant, budget):
    want = ops.h1_probe_plain(**a, variant=variant)
    assert torch.equal(schedule_model(**a, variant=variant, budget=budget),
                       want)


@pytest.mark.parametrize("variant", ops.H1_VARIANTS)
def test_terms_are_symmetric(variant):
    """term(i, j) == term(j, i) bit for bit, in the plain version's own
    arithmetic, and zero wherever a slot is invalid."""
    a = microbench_h1_probe.make_inputs(np.random.default_rng(1), "cpu",
                                        NP=3)
    d1 = ops._probe_dist(a["lx"], a["ly"], variant)
    d2 = ops._probe_dist(a["rx"], a["ry"], variant)
    dist = (d1 - d2).abs()
    h1 = torch.clamp((30.0 - dist) / torch.full_like(dist, 25.0), 0.0, 1.0)
    vf = a["vf"]
    t = h1 * ((dist <= 30.0).float() * (vf[:, None, :] * vf[:, :, None]))
    assert torch.equal(t, t.transpose(1, 2))
    dead = (vf[:, :, None] == 0) | (vf[:, None, :] == 0)
    assert bool((t[dead] == 0).all())


def test_plan_fits_the_card():
    """Three blocks an SM at K 200 with the whole triangle of a typical
    set (n <= 184: 92 tile rows) in one strip; at the cap at least one
    tile row a strip."""
    for K in (1, 2, 31, 200, 257, 1024):
        plan = ops.h1_plan(K)
        per_sm, reserved, optin = ops.H100_SMEM
        T = (K + 1) // 2
        assert plan["budget"] % 4 == 0
        assert 4 * ((K + 2) // 2) <= plan["budget"]
        assert plan["budget"] <= max(2 * T * (T + 1), 4 * ((K + 2) // 2))
        assert plan["smem_bytes"] <= optin
        assert ops.H1_TARGET_BLOCKS * (plan["smem_bytes"] + reserved) \
            <= per_sm
    assert ops.h1_plan(200)["budget"] >= 2 * 92 * 93


def test_sqrt_rn_is_correctly_rounded():
    """The plain versions' square root is the IEEE f32 root (NumPy's) on
    every input, the same on every call; PyTorch's own f32 root on the CPU
    is not, on some hosts."""
    rng = np.random.default_rng(5)
    q = np.concatenate([
        rng.uniform(0, 1800, 400_000), rng.uniform(0, 1e-30, 1000),
        10.0 ** rng.uniform(-38, 38, 100_000), [0.0, 1.0, 25.0, 900.0],
        np.frombuffer(rng.integers(0, 0x7F800000, 100_000, dtype=np.uint32)
                      .tobytes(), np.float32)]).astype(np.float32)
    want = np.sqrt(q)
    got = sqrt_rn(torch.as_tensor(q))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(sqrt_rn(torch.as_tensor(q)), got)
