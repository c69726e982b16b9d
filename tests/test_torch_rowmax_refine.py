"""The ADC row max's exact refine on the tensor cores, modelled on the CPU.

With a bf16 latent side (D <= 96) the card's row max sums each dot on the
tensor cores, in another order than the plain version's index order, and
must still return adc_rowmax_plain's best / bestj bit for bit (best is the
texture score's input, bestj the correspondence texture_match keeps). Its
rule (csrc/screen_body.cuh, ArgRows): per row the three largest tensor-core
values t1 >= t2 >= t3 (invalid columns -inf) and the columns j1, j2 of the
first two; thr = ops.rowmax_threshold(t1, ops.rowmax_margin(...)); no
valid column (t1 = -inf) gives (-1e30, 0); t3 >= thr (three or more
candidates) an exact pass over every column; else j1 and, if t2 >= thr,
j2 recomputed in index order with the plain epilogue, the larger taken
(the smaller column on equal values).

Here that rule runs on the CPU with the dots summed in two other f32
orders (reversed index order and an mma-like k-step, as in
test_torch_tc_tolerance.py) and the same ops margin functions the card's
wrappers hand the kernel, at the dense 448 shape, the reference cap shape,
a ragged Rt 100, with an entry that has no valid column and with columns
duplicated two and three times (the first index must win); and on a
crafted near-tie where the reordered maximum alone picks the wrong column,
so the margin is needed. Then the bf16 plain versions against the Pallas
row max kernels in interpret mode at the cap shape.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msu_latentafis_tpu.matcher import pallas_kernels as pk
from msu_latentafis_tpu.matcher.texture_match import block_diag_codebook
from msu_latentafis_tpu_torch.matcher.kernels import ops
from msu_latentafis_tpu_torch.utils.synthetic import random_codebook

from test_torch_tc_tolerance import ORDERS


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch on one intra-op thread: the suite's workers share the host's
    cores, and an intra-op pool in each spins waiting on the others (a
    test ran 7x slower with 8 threads than with 1 beside 8 busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

BF16 = torch.bfloat16
NEG = float(np.float32(-1e30))


def refine_model(order, x, lsq, dec, rsq, rvalid, norms, margin=True):
    """The card's refine with the dots summed in ``order``: best, bestj and
    the counts of rows decided between two candidates, sent to the exact
    pass and without a valid column."""
    t6 = (6.0 - lsq)[:, None, :, None]
    w = 2.0 * ORDERS[order](x, dec) + (t6 - rsq[None, :, None, :])
    w = torch.where(rvalid[None, :, None, :] == 1.0, w,
                    torch.full_like(w, -np.inf))
    if w.shape[-1] < 3:
        w = torch.cat([w, torch.full(w.shape[:-1] + (3 - w.shape[-1],),
                                     -np.inf)], dim=-1)
    top = torch.topk(w, 3, dim=-1)
    v1, v2, v3 = top.values.unbind(-1)
    j1, j2 = top.indices[..., 0], top.indices[..., 1]
    e = ops.rowmax_margin(*norms, x.shape[-1]) if margin \
        else torch.zeros_like(v1)
    thr = ops.rowmax_threshold(v1, e)
    exact = ops.adc_simi_plain(x, lsq, dec, rsq, rvalid)
    full_b, full_j = ops.adc_rowmax_plain(x, lsq, dec, rsq, rvalid)
    s1 = exact.gather(-1, j1.clamp(max=exact.shape[-1] - 1)[..., None])[..., 0]
    s2 = exact.gather(-1, j2.clamp(max=exact.shape[-1] - 1)[..., None])[..., 0]
    two = v2 >= thr
    pick2 = two & ((s2 > s1) | ((s2 == s1) & (j2 < j1)))
    best = torch.where(pick2, s2, s1)
    bestj = torch.where(pick2, j2, j1).to(torch.int32)
    empty, over = v1 == -np.inf, v3 >= thr
    best = torch.where(over, full_b, best)
    bestj = torch.where(over, full_j, bestj)
    best = torch.where(empty, torch.full_like(best, NEG), best)
    bestj = torch.where(empty, torch.zeros_like(bestj), bestj)
    counts = dict(two=int((two & ~over & ~empty).sum()),
                  over=int((over & ~empty).sum()), empty=int(empty.sum()))
    return best, bestj, counts


def _case(rng, NL, Lt, B, Rt, gallery, D=96):
    """bf16 latents (unit descriptors, a row valid 9 times in 10) against a
    bf16 or int8 predecoded gallery or a bf16 codes gallery (S 16, sub_dim
    6); entry B - 1 has no valid column; entries 0 and 1 repeat their
    columns (``_repeat``)."""
    x = rng.standard_normal((NL, Lt, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    codes = codebook = None
    if gallery == "codes":
        cb = random_codebook(rng, n_subs=16, n_clusters=256, sub_dim=6)
        codebook = torch.as_tensor(cb).to(BF16)
        codes = rng.integers(0, 256, (B, Rt, 16)).astype(np.uint8)
        _repeat(codes)
        codes = torch.as_tensor(codes)
        dec = ops.decode_pq(codes, codebook)
    elif gallery == "int8":
        scale = 0.004
        dec = rng.integers(-127, 128, (B, Rt, D)).astype(np.int8)
        _repeat(dec)
        dec = torch.as_tensor(dec)
        x = x * np.float32(scale)
    else:
        d = rng.standard_normal((B, Rt, D)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        _repeat(d)
        dec = torch.as_tensor(d).to(BF16)
    xb = torch.as_tensor(x).to(BF16)
    rval = (rng.random((B, Rt)) > 0.1).astype(np.float32)
    _repeat(rval)
    rval[-1] = 0.0
    deq = dec.float() * (0.004 if gallery == "int8" else 1.0)
    return dict(x=xb, lsq=xb.float().pow(2).sum(-1), dec=dec,
                rsq=deq.pow(2).sum(-1), rvalid=torch.as_tensor(rval)), \
        codes, codebook


def _repeat(a):
    """Entry 0: column j >= Rt/2 repeats column j - Rt/2 (Rt even); entry
    1: column j >= Rt/3 repeats column j mod Rt/3, so a row's maximum ties
    twice in entry 0 and three or four times in entry 1."""
    Rt = a.shape[1]
    h, t = Rt // 2, Rt // 3
    a[0, h:] = a[0, np.arange(h, Rt) % h]
    if a.shape[0] > 2:
        a[1, t:] = a[1, np.arange(t, Rt) % t]


# (NL, Lt, B, Rt, gallery): the dense 448 shape in the two predecoded
# modes, the reference cap shape over codes, a ragged Rt 100
CASES = [(4, 448, 3, 448, "bf16"), (4, 448, 3, 448, "int8"),
         (1, 1000, 3, 1000, "codes"), (2, 64, 3, 100, "bf16")]


@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("NL,Lt,B,Rt,gallery", CASES)
def test_refine_returns_plain_bits(NL, Lt, B, Rt, gallery, order):
    """The refine with the dots in another order returns adc_rowmax_plain's
    best and bestj bit for bit; every row of the empty entry is (-1e30, 0),
    and the tied columns resolve to the first."""
    rng = np.random.default_rng(NL * Lt + Rt + len(gallery))
    a, codes, codebook = _case(rng, NL, Lt, B, Rt, gallery)
    norms = ops.rowmax_operand_norms(a["x"], a["dec"]) if codes is None \
        else ops.rowmax_operand_norms(a["x"], codebook=codebook, B=B)
    want_b, want_j = ops.adc_rowmax_plain(**a)
    got_b, got_j, counts = refine_model(order, **a, norms=norms)
    assert torch.equal(got_b, want_b) and torch.equal(got_j, want_j)
    assert bool((want_b[:, -1] == NEG).all()) and \
        bool((want_j[:, -1] == 0).all())
    assert counts["empty"] == NL * Lt
    h, t = Rt // 2, Rt // 3
    assert bool((want_j[:, 0] < h).all())        # the first of two copies
    assert bool((want_j[:, 1] < t).all())        # the first of three
    assert counts["over"] >= NL * Lt             # three copies: exact pass
    assert counts["two"] + counts["over"] >= 2 * NL * Lt


def test_near_tie_needs_the_margin():
    """Two columns whose dots differ by 2^-22 in index order (column b
    ahead) and by 2^-23 to 2^-22 the other way in the reordered sums: in
    index order the 14 products 2^-25 of column a are each lost against
    1 + 2^-8, reversed or pairwise they survive. With 6 - lsq = 0 and
    rsq = 2 the values 2 dot - 2 keep the difference. The reordered argmax
    alone picks a; the refine recomputes both (they are within the
    margin) and returns the plain version's b, value and index; without
    the margin it would not."""
    xv = np.array([1.0, 2 ** -4] + [2 ** -12] * 14, np.float32)
    ca = np.array([1.0, 2 ** -4] + [2 ** -13] * 14, np.float32)
    cb = np.zeros(16, np.float32)
    cb[:3] = [1.0, 2 ** -4, 2 ** -10]
    x = torch.as_tensor(xv).reshape(1, 1, 16).to(BF16)
    dec = torch.as_tensor(np.stack([ca, cb])).reshape(1, 2, 16).to(BF16)
    a = dict(x=x, lsq=torch.full((1, 1), 6.0), dec=dec,
             rsq=torch.full((1, 2), 2.0), rvalid=torch.ones(1, 2))
    want_b, want_j = ops.adc_rowmax_plain(**a)
    assert int(want_j) == 1
    norms = ops.rowmax_operand_norms(x, dec)
    for order, dots in ORDERS.items():
        w = dots(x, dec)[0, 0, 0]
        assert float(w[0]) > float(w[1])         # the reordered argmax is a
        got_b, got_j, counts = refine_model(order, **a, norms=norms)
        assert torch.equal(got_b, want_b) and torch.equal(got_j, want_j)
        assert counts["two"] == 1
        blind = refine_model(order, **a, norms=norms, margin=False)
        assert int(blind[1]) == 0                # the wrong column


def _pallas_cap_args(rng, codes_side):
    """bf16 operands at the cap shape (1 latent x 2 entries, Lt = Rt =
    1000, D 96) for the Pallas row max (predecoded, or codes with the
    block-diagonal decode tensor) and the port's plain version."""
    cb = random_codebook(rng, n_subs=16, n_clusters=256, sub_dim=6)
    codes = rng.integers(0, 256, (2, 1000, 16)).astype(np.uint8)
    x = rng.standard_normal((1, 1000, 96)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    xb = torch.as_tensor(x).to(BF16)
    cbk = torch.as_tensor(cb).to(BF16)
    dec = ops.decode_pq(torch.as_tensor(codes), cbk)
    rval = (rng.random((2, 1000)) > 0.1).astype(np.float32)
    lsq = xb.float().pow(2).sum(-1)
    rsq = dec.float().pow(2).sum(-1)
    jx = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    if codes_side:
        tdec = np.ascontiguousarray(np.asarray(block_diag_codebook(cb),
                                               np.float32)
                                    .reshape(16 * 256, 96).T)
        want = pk.fused_adc_rowmax_codes(
            jx, jnp.asarray(lsq.numpy()),
            jnp.asarray(np.swapaxes(codes, 1, 2).copy()),
            jnp.asarray(tdec).astype(jnp.bfloat16), jnp.asarray(rsq.numpy()),
            jnp.asarray(rval), n_clusters=256, interpret=True)
    else:
        want = pk.fused_adc_rowmax(
            jx, jnp.asarray(lsq.numpy()),
            jnp.asarray(np.swapaxes(dec.float().numpy(), 1, 2))
            .astype(jnp.bfloat16), jnp.asarray(rsq.numpy()),
            jnp.asarray(rval), interpret=True)
    return dict(x=xb, lsq=lsq, dec=dec, rsq=rsq,
                rvalid=torch.as_tensor(rval)), want


@pytest.mark.parametrize("codes_side", [False, True])
def test_bf16_rowmax_at_cap_matches_pallas(codes_side):
    """adc_rowmax_plain in bf16 at the cap shape against the Pallas row max
    (codes or predecoded) in interpret mode: best within rtol 1e-5 /
    atol 1e-4, and every Pallas bestj the plain bestj or a column whose
    plain value reaches ops.rowmax_threshold of the plain maximum (each
    side sums its dots in its own order, within the margin)."""
    rng = np.random.default_rng(17 + codes_side)
    a, (wb, wj) = _pallas_cap_args(rng, codes_side)
    best, bestj = ops.adc_rowmax_plain(**a)
    np.testing.assert_allclose(best.numpy(), np.asarray(wb), **ops.KERNEL_TOL)
    pj = torch.as_tensor(np.array(wj)).long()
    simi = ops.adc_simi_plain(**a)
    thr = ops.rowmax_threshold(best, ops.rowmax_margin(
        *ops.rowmax_operand_norms(a["x"], a["dec"]), 96))
    reached = simi.gather(-1, pj[..., None])[..., 0] >= thr
    assert bool(((pj == bestj.long()) | reached).all())
    assert float((pj == bestj.long()).float().mean()) > 0.99
