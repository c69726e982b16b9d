"""The port's throughput modes (bf16 compute, int8 texture and minutiae
galleries) on the CPU against the JAX package in the same modes.

Kernels: each typed kernel's plain version against the Pallas kernel in
interpret mode on the same NumPy-made operands, rounded to bf16 or
quantized to int8 the same way on both sides. Tolerance rtol 1e-5 /
atol 1e-4 (argmax indices exact): a bf16 x bf16, bf16 x int8 or
f32 x int8 product is one f32 rounding or none, so the two sides differ
only in the order of their f32 sums. One stated exception: the bf16 screens
round each row maximum to bf16 (the TPU kernel's output type), and a sum
taken in another order can land on the other side of a rounding boundary;
that term is bounded by one bf16 ulp of each row maximum (twice, as the
screen doubles it), added to the tolerance of the screen's sum.

Engine: the port's MatchEngine in each mode against the JAX engine in the
same mode, dense, serving (prescreen, two-stage, normalize) and
codes-resident: the same top-24 order, scores within rtol 1e-4 /
atol 1e-3, and the int8 gallery arrays equal to the JAX engine's bit for
bit. Then each mode against the port's own f32 engine, judged as
tests/test_int8_mode.py judges the JAX package's modes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msu_latentafis_tpu.matcher import pallas_kernels as pk
from msu_latentafis_tpu.matcher.engine import MatchEngine as JaxEngine
from msu_latentafis_tpu.matcher.texture_match import block_diag_codebook
from msu_latentafis_tpu_torch.matcher.engine import MatchEngine
from msu_latentafis_tpu_torch.matcher.kernels import ops
from msu_latentafis_tpu_torch.templates import pack_gallery, pack_latent
from msu_latentafis_tpu_torch.utils.synthetic import (
    make_latent_template, make_rolled_template, random_codebook)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch on one intra-op thread: the suite's workers share the host's
    cores, and an intra-op pool in each spins waiting on the others (a
    test ran 7x slower with 8 threads than with 1 beside 8 busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TOL = dict(rtol=1e-5, atol=1e-4)
ENGINE_TOL = dict(rtol=1e-4, atol=1e-3)
CAPS = dict(minu_cap=32, tex_cap=48)
BF16 = torch.bfloat16

# kernel operand modes: (latent type, gallery type)
OPERANDS = {"bf16": ("bf16", "bf16"), "bf16_int8": ("bf16", "int8"),
            "f32_int8": ("f32", "int8")}


def T(a, dtype=torch.float32):
    return torch.as_tensor(np.ascontiguousarray(a)).to(dtype)


def jx(a, kind):
    """NumPy f32 (or int8) -> JAX array of the operand kind."""
    if kind == "bf16":
        return jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16)
    if kind == "int8":
        return jnp.asarray(np.asarray(a, np.int8))
    return jnp.asarray(np.asarray(a, np.float32))


def tt(a, kind):
    """NumPy f32 (or int8) -> torch tensor of the operand kind, rounded as
    ``jx`` rounds it."""
    if kind == "int8":
        return T(np.asarray(a, np.int8), torch.int8)
    return T(np.asarray(a, np.float32), BF16 if kind == "bf16" else
             torch.float32)


def gallery_side(rng, shape, kind):
    """Gallery descriptors f32 normal values, or int8 codes in [-127, 127]
    with their scale; returns (values as stored, scale or None)."""
    if kind == "int8":
        return rng.integers(-127, 128, shape).astype(np.int8), 0.0123
    return rng.standard_normal(shape).astype(np.float32), None


def latent_side(x, scale):
    """The latent operand with an int8 gallery's scale folded in (f32)."""
    return x if scale is None else (x * np.float32(scale)).astype(np.float32)


def _adc_inputs(rng, NL=2, Lt=16, D=8, B=4, Rt=24):
    x = rng.standard_normal((NL, Lt, D)).astype(np.float32)
    lsq = np.sum(x ** 2, -1)
    lval = (np.arange(Lt)[None, :] < np.array([[12], [16]])[:, 0:1]) \
        .astype(np.float32)
    rval = (np.arange(Rt)[None, :] < 20).astype(np.float32) \
        * np.ones((B, 1), np.float32)
    rval[2] = 0.0                       # an entry with no valid column
    return x, lsq, lval, rval


# ---------------------------------------------------------------------------
# typed kernels: plain versions vs Pallas interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(OPERANDS))
def test_adc_rowmax_modes_match_pallas(rng, mode):
    xk, gk = OPERANDS[mode]
    x, lsq, _, rval = _adc_inputs(rng, D=16)
    dec, scale = gallery_side(rng, (4, 24, 16), gk)
    x = latent_side(x, scale)
    rsq = rng.uniform(0, 6, (4, 24)).astype(np.float32)
    want_b, want_j = pk.fused_adc_rowmax(
        jx(x, xk), jnp.asarray(lsq), jx(np.swapaxes(dec, 1, 2), gk),
        jnp.asarray(rsq), jnp.asarray(rval), interpret=True)
    best, bestj = ops.adc_rowmax(tt(x, xk), T(lsq), tt(dec, gk), T(rsq),
                                 T(rval))
    np.testing.assert_allclose(best.numpy(), np.asarray(want_b), **TOL)
    np.testing.assert_array_equal(bestj.numpy(), np.asarray(want_j))


def _codes_inputs(rng, S=4, C=16, sd=2, B=4, Rt=24):
    cb = random_codebook(rng, n_subs=S, n_clusters=C, sub_dim=sd)
    codes = rng.integers(0, C, (B, Rt, S)).astype(np.uint8)
    dec = cb[np.arange(S)[None, None, :], codes].reshape(B, Rt, S * sd)
    rsq = np.sum(dec.astype(np.float64) ** 2, -1).astype(np.float32)
    tdec = np.ascontiguousarray(
        np.asarray(block_diag_codebook(cb), np.float32)
        .reshape(S * C, S * sd).T)
    return cb, codes, rsq, tdec


def test_adc_codes_kernels_bf16_match_pallas(rng):
    """The codes kernels on a bf16 codebook (the JAX engine's bf16 decode
    tensor) against the Pallas codes kernels, and bit for bit against the
    predecoded bf16 kernels on the bf16 decode."""
    cb, codes, rsq, tdec = _codes_inputs(rng)
    x, lsq, lval, rval = _adc_inputs(rng)
    codes_t = jnp.asarray(np.swapaxes(codes, 1, 2).copy())
    want_b, want_j = pk.fused_adc_rowmax_codes(
        jx(x, "bf16"), jnp.asarray(lsq), codes_t, jx(tdec, "bf16"),
        jnp.asarray(rsq), jnp.asarray(rval), n_clusters=16, interpret=True)
    cbk = T(cb).to(BF16)
    args = (tt(x, "bf16"), T(lsq))
    best, bestj = ops.adc_rowmax_codes(*args, T(codes, torch.uint8), cbk,
                                       T(rsq), T(rval))
    np.testing.assert_allclose(best.numpy(), np.asarray(want_b), **TOL)
    np.testing.assert_array_equal(bestj.numpy(), np.asarray(want_j))
    dec = ops.decode_pq(T(codes, torch.uint8), cbk)
    assert dec.dtype == BF16
    dbest, dbestj = ops.adc_rowmax(*args, dec, T(rsq), T(rval))
    assert torch.equal(best, dbest) and torch.equal(bestj, dbestj)

    want = pk.fused_adc_screen_codes(
        jx(x, "bf16"), jnp.asarray(lsq), jnp.asarray(lval), codes_t,
        jx(tdec, "bf16"), jnp.asarray(rsq), jnp.asarray(rval),
        n_clusters=16, tau=1.0, interpret=True)
    got = ops.adc_screen_codes(*args, T(lval), T(codes, torch.uint8), cbk,
                               T(rsq), T(rval), tau=1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL["rtol"],
                               atol=_screen_slack(tt(x, "bf16"), dec, T(rsq),
                                                  T(rval), T(lval), 0))
    assert torch.equal(got, ops.adc_screen(*args, T(lval), dec, T(rsq),
                                           T(rval), tau=1.0))
    with pytest.raises(TypeError):      # the codebook has x's type
        ops.adc_rowmax_codes(*args, T(codes, torch.uint8), T(cb), T(rsq),
                             T(rval))


def _screen_slack(x, dec, rsq, rval, lval, block):
    """atol of a screen comparison: the largest of ops.screen_slack, TOL's
    atol plus, when the row maxima are rounded to bf16, one bf16 ulp of
    each row maximum, doubled, summed over the valid latent rows [NL, B]
    (the helper the card's smoke and tests hold the tensor-core screen
    to)."""
    raw = ops.screen_rowmax_plain(x, dec, rsq, rval, block)
    return float(ops.screen_slack(x, lval, raw).max())


@pytest.mark.parametrize("mode,block", [("bf16", 0), ("bf16_int8", 2),
                                        ("bf16_int8", 4), ("f32_int8", 2)])
@pytest.mark.parametrize("tau", [0.0, 2.0])
def test_adc_screen_modes_match_pallas(rng, mode, block, tau):
    """The int8 screen takes one scale c1 of the -rsq / 2 row per group of
    ``block`` entries: the JAX engine calls the Pallas screen once per
    block, so the reference here is one call per group."""
    xk, gk = OPERANDS[mode]
    x, lsq, lval, rval = _adc_inputs(rng, D=16)
    dec, scale = gallery_side(rng, (4, 24, 16), gk)
    x = latent_side(x, scale)
    rsq = rng.uniform(0, 6, (4, 24)).astype(np.float32)
    rsq[1] *= 3.0                       # groups with different scales
    step = block or 4
    want = np.concatenate([np.asarray(pk.fused_adc_screen(
        jx(x, xk), jnp.asarray(lsq), jnp.asarray(lval),
        jx(np.swapaxes(dec[a:a + step], 1, 2), gk),
        jnp.asarray(rsq[a:a + step]), jnp.asarray(rval[a:a + step]),
        tau=tau, entries_per_step=step, interpret=True))
        for a in range(0, 4, step)], axis=1)
    got = ops.adc_screen(tt(x, xk), T(lsq), T(lval), tt(dec, gk), T(rsq),
                         T(rval), tau=tau, block=block)
    np.testing.assert_allclose(
        got.numpy(), want, rtol=TOL["rtol"],
        atol=_screen_slack(tt(x, xk), tt(dec, gk), T(rsq), T(rval),
                           T(lval), block))
    assert (got[:, 2] == 0.0).all()     # the all-invalid entry adds nothing
    if gk == "int8":
        with pytest.raises(ValueError):  # an int8 screen needs its block
            ops.adc_screen(tt(x, xk), T(lsq), T(lval), tt(dec, gk), T(rsq),
                           T(rval))


@pytest.mark.parametrize("mode", list(OPERANDS))
def test_minu_screens_modes_match_pallas(rng, mode):
    xk, gk = OPERANDS[mode]
    NT, P, D, B, R = 3, 12, 16, 4, 20
    lat = rng.standard_normal((NT, P, D)).astype(np.float32)
    rol, scale = gallery_side(rng, (B, R, D), gk)
    lat = latent_side(lat, scale)
    lval = (np.arange(P)[None, :] < np.array([8, 12, 5])[:, None]) \
        .astype(np.float32)
    rval = (np.arange(R)[None, :] < np.array([20, 15, 20, 9])[:, None]) \
        .astype(np.float32)
    for normalize in (False, True):
        want = pk.fused_minu_screen(
            jx(lat, xk), jnp.asarray(lval), jx(np.swapaxes(rol, 1, 2), gk),
            jnp.asarray(rval), normalize=normalize, interpret=True)
        got = ops.minu_screen(tt(lat, xk), T(lval), tt(rol, gk), T(rval),
                              normalize=normalize)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _packs(rng, n, m, hi):
    xy = rng.integers(0, hi, (n, m, 2)).astype(np.float32)
    o = rng.uniform(-np.pi, np.pi, (n, m)).astype(np.float32)
    return np.concatenate([xy, np.cos(o)[..., None], np.sin(o)[..., None]],
                          axis=-1)


@pytest.mark.parametrize("mode", list(OPERANDS))
def test_minutiae_match_modes_match_pallas(rng, mode):
    xk, gk = OPERANDS[mode]
    NT, B, P, R, D, K = 2, 4, 16, 24, 32, 20
    ld = rng.standard_normal((NT, P, D)).astype(np.float32)
    ld /= np.linalg.norm(ld, axis=-1, keepdims=True)
    rd = rng.standard_normal((B, R, D)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    rd[0, :P] = ld[0] + 0.2 * rng.standard_normal((P, D))
    scale = None
    if gk == "int8":
        scale = float(np.abs(rd).max()) / 127.0 + 1e-12
        rd = np.clip(np.round(rd / scale), -127, 127).astype(np.int8)
    ld = latent_side(ld, scale)
    lv = (rng.random((NT, P)) > 0.1).astype(np.float32)
    rv = (rng.random((B, R)) > 0.1).astype(np.float32)
    lp, rp = _packs(rng, NT, P, 480), _packs(rng, B, R, 480)
    rp[0, :P] = lp[0]
    want = pk.fused_minutiae_match(
        jx(ld, xk), jnp.asarray(lv), jx(np.swapaxes(rd, 1, 2), gk),
        jnp.asarray(rv), jnp.asarray(np.swapaxes(lp, 1, 2)),
        jnp.asarray(np.swapaxes(rp, 1, 2)), top_n=K, row_cap=8, tile_b=2,
        interpret=True)
    got = ops.minutiae_match(tt(ld, xk), T(lv), tt(rd, gk), T(rv), T(lp),
                             T(rp), top_n=K, row_cap=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(got[0, 0]) > 1.0


def test_wrappers_refuse_other_type_pairs():
    x = torch.zeros((1, 8, 4))
    args = (torch.zeros((1, 8)), torch.zeros((2, 8)), torch.zeros((2, 8)))
    for xd, dd in ((BF16, torch.float32), (torch.float32, BF16),
                   (torch.int8, torch.int8), (torch.float16, torch.float16),
                   (BF16, torch.uint8)):
        with pytest.raises(TypeError):
            ops.adc_rowmax(x.to(xd), args[0], torch.zeros((2, 8, 4)).to(dd),
                           *args[1:])
        with pytest.raises(TypeError):
            ops.minu_screen(x.to(xd), args[0], torch.zeros((2, 8, 4)).to(dd),
                            args[1])


# ---------------------------------------------------------------------------
# the engine in each mode vs the JAX engine in the same mode
# ---------------------------------------------------------------------------

MATES = (9, 2)                          # gallery position of latent i's mate
ENGINE_MODES = {
    "bf16": dict(),
    "bf16_tex_int8": dict(tex_int8=True),
    "bf16_minu_int8": dict(minu_int8=True),
    "f32_both_int8": dict(tex_int8=True, minu_int8=True),
}
PRESCREEN = dict(m=8, prescreen_k=8, prescreen_lt=16, prescreen_t=1)
TWO_STAGE = dict(m=4, prescreen_k=8, prescreen_lt=16, prescreen_t=1)
NORMALIZE = dict(m=8, normalize=True)
# Serving cases per mode, each one more JAX compile (the JAX CPU compiles
# dominate this file's time): the screens of every mode are held below on
# the whole gallery, and serving composes them with the f32-tested top-k;
# what serving adds in a mode is the two-stage screen over candidates,
# whose int8 scale groups follow the candidates' order (tex_int8), and the
# normalized screen.
RERANK_CASES = {"bf16": (NORMALIZE,),
                "bf16_tex_int8": (TWO_STAGE, NORMALIZE),
                "bf16_minu_int8": (TWO_STAGE,),
                "f32_both_int8": ()}


@pytest.fixture(scope="module")
def packed():
    """12 rolled templates (one mate for each of 2 latents) at caps 32/48:
    three engine blocks of 4, so the int8 screen has three scale groups."""
    rng = np.random.default_rng(20261017)
    cb = random_codebook(rng)
    lats = [make_latent_template(rng, n_minu=12, n_tex=30) for _ in MATES]
    gallery = [make_rolled_template(rng, n_minu=20, n_tex=40)
               for _ in range(12)]
    for lat, pos in zip(lats, MATES):
        gallery[pos] = make_rolled_template(rng, n_minu=20, n_tex=40,
                                            mated_latent=lat, codebook=cb)
    return dict(cb=cb, pg=pack_gallery(gallery, cb, **CAPS),
                pls=[pack_latent(l, quantize_tex_xy=False, **CAPS)
                     for l in lats])


def engines(cb, name, **kw):
    """(JAX engine, port engine) in mode ``name``, block 4."""
    bf16 = name.startswith("bf16")
    mode = ENGINE_MODES[name]
    je = JaxEngine(cb, block_size=4, compute_dtype=jnp.bfloat16 if bf16
                   else jnp.float32, **mode, **kw)
    te = MatchEngine(cb, block_size=4, row_cap=32, compute_dtype=BF16 if bf16
                     else torch.float32, device="cpu", **mode, **kw)
    return je, te


def assert_ranked_alike(got, want):
    """Scores within ENGINE_TOL and the same top-24 order per latent."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, **ENGINE_TOL)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.argsort(-g, kind="stable")[:24],
                                      np.argsort(-w, kind="stable")[:24])


@pytest.mark.parametrize("name", list(ENGINE_MODES))
def test_engine_modes_match_jax(packed, name):
    """Dense scores, screens and serving (the mode's rerank cases) against
    the JAX engine in the same mode; the stored gallery arrays equal its
    arrays bit for bit."""
    je, te = engines(packed["cb"], name)
    jgal, tgal = je.load_gallery(packed["pg"]), te.load_gallery(packed["pg"])
    arrays = {k: np.asarray(v) for k, v in je._gallery_dict(jgal).items()}
    for field in ("minu_des", "tex_dec"):
        want = np.swapaxes(arrays[field], 1, 2)
        got = getattr(tgal, field)
        assert str(want.dtype) == str(got.dtype).replace("torch.", ""), field
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.astype(np.float32), err_msg=field)
    if te.minu_int8:
        assert tgal.minu_scale.numpy().tobytes() \
            == arrays["minu_scale"].tobytes()
    pls = packed["pls"]
    dense = te.match_scores_batch(pls, tgal).numpy()
    assert_ranked_alike(dense, je.match_scores_batch(pls, jgal))
    for i, pos in enumerate(MATES):
        assert int(np.argmax(dense[i])) == pos
    assert_ranked_alike(te.screen_scores_batch(pls, tgal).numpy(),
                        je.screen_scores_batch(pls, jgal))
    for kw in RERANK_CASES[name]:
        got = te.match_scores_batch_reranked(pls, tgal, **kw)
        want = je.match_scores_batch_reranked(pls, jgal, **kw)
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        np.testing.assert_allclose(got[1], np.asarray(want[1]), **ENGINE_TOL)


@pytest.mark.parametrize("name", ["bf16_minu_int8"])
def test_codes_resident_modes_match_jax(packed, name):
    """A codes-resident gallery in bf16 (the codebook rounded to bf16, as
    the JAX engine's decode tensor) against the JAX engine's codes-resident
    gallery; and equal, bit for bit, to the port's predecoded bf16
    gallery."""
    je, te = engines(packed["cb"], name, codes_resident=True)
    jgal, tgal = je.load_gallery(packed["pg"]), te.load_gallery(packed["pg"])
    assert jgal.tex_codes_t is not None and tgal.codes_resident
    pls = packed["pls"]
    dense = te.match_scores_batch(pls, tgal)
    assert_ranked_alike(dense.numpy(), je.match_scores_batch(pls, jgal))
    _, tp = engines(packed["cb"], name, codes_resident=False)
    pgal = tp.load_gallery(packed["pg"])
    assert torch.equal(dense, tp.match_scores_batch(pls, pgal))
    for kw in (PRESCREEN,):
        got = te.match_scores_batch_reranked(pls, tgal, **kw)
        want = je.match_scores_batch_reranked(pls, jgal, **kw)
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        np.testing.assert_allclose(got[1], np.asarray(want[1]), **ENGINE_TOL)
        twin = tp.match_scores_batch_reranked(pls, pgal, **kw)
        for g, w in zip(got, twin):
            np.testing.assert_array_equal(g, w)


def test_int8_screen_scales_follow_engine_blocks(packed):
    """The int8 screen's scale groups are the engine's blocks: at block 4
    and block 8 the port's screens follow the JAX engine's (and differ from
    each other)."""
    out = {}
    for block in (4, 8):
        je = JaxEngine(packed["cb"], block_size=block,
                       compute_dtype=jnp.bfloat16, tex_int8=True)
        te = MatchEngine(packed["cb"], block_size=block, row_cap=32,
                         compute_dtype=BF16, tex_int8=True, device="cpu")
        got = te.screen_scores_batch(packed["pls"],
                                     te.load_gallery(packed["pg"])).numpy()
        want = je.screen_scores_batch(packed["pls"],
                                      je.load_gallery(packed["pg"]))
        np.testing.assert_allclose(got, np.asarray(want), **ENGINE_TOL)
        out[block] = got
    assert not np.array_equal(out[4], out[8])


# ---------------------------------------------------------------------------
# each mode vs the port's f32, as tests/test_int8_mode.py judges the JAX modes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_tex_int8_scores_close_to_f32(rng, dtype):
    """tex_int8 quantizes only the texture dot products: its scores track
    the engine without it in the same compute dtype (f32: the port's f32
    engine, as tests/test_int8_mode.py judges). bf16 compute by itself
    moves an impostor of this gallery by more than atol 0.3 from its f32
    score (a minutiae selection flips), in the JAX engine as in the port
    (both held to each other below), so the reference of the bf16 case is
    the bf16 engine; the rank-1 entry and the mate are held against f32 in
    both cases."""
    codebook = random_codebook(rng)
    latent = make_latent_template(rng, n_minu=16, n_tex=50)
    mate = make_rolled_template(rng, n_minu=24, n_tex=60, mated_latent=latent,
                                codebook=codebook)
    gallery = [make_rolled_template(rng, n_minu=24, n_tex=60)
               for _ in range(5)] + [mate]
    caps = dict(minu_cap=32, tex_cap=64)
    pl = pack_latent(latent, quantize_tex_xy=False, **caps)
    pg = pack_gallery(gallery, codebook, **caps)
    e32 = MatchEngine(codebook, block_size=2, row_cap=32, device="cpu")
    ref = MatchEngine(codebook, block_size=2, row_cap=32,
                      compute_dtype=dtype, device="cpu")
    e8 = MatchEngine(codebook, block_size=2, row_cap=32, compute_dtype=dtype,
                     tex_int8=True, device="cpu")
    s32 = e32.one_to_list(pl, e32.load_gallery(pg)).scores
    sref = ref.one_to_list(pl, ref.load_gallery(pg)).scores
    s8 = e8.one_to_list(pl, e8.load_gallery(pg)).scores
    assert np.argmax(s8) == np.argmax(sref) == np.argmax(s32) == 5
    np.testing.assert_allclose(s8, sref, rtol=0.05, atol=0.3)
    np.testing.assert_allclose(s8[5], s32[5], rtol=0.05)
    if dtype != BF16:                 # f32 + tex_int8 vs JAX: above
        return
    for e, flags in ((ref, {}), (e8, dict(tex_int8=True))):
        je = JaxEngine(codebook, block_size=2, compute_dtype=jnp.bfloat16,
                       predecode=True, **flags)
        np.testing.assert_allclose(
            e.one_to_list(pl, e.load_gallery(pg)).scores,
            je.one_to_list(pl, je.load_gallery(pg)).scores, **ENGINE_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_minu_int8_scores_track_f32(rng, dtype):
    codebook = random_codebook(rng)
    caps = dict(minu_cap=48, tex_cap=64)
    latent = make_latent_template(rng, n_minu=20, n_tex=40)
    gallery = [make_rolled_template(rng, n_minu=25, n_tex=50)
               for _ in range(3)]
    gallery.append(make_rolled_template(rng, n_minu=40, n_tex=60,
                                        mated_latent=latent,
                                        codebook=codebook))
    pg = pack_gallery(gallery, codebook, **caps)
    pl = pack_latent(latent, quantize_tex_xy=False, **caps)
    f32 = MatchEngine(codebook, block_size=2, row_cap=48, device="cpu")
    q = MatchEngine(codebook, block_size=2, row_cap=48, compute_dtype=dtype,
                    minu_int8=True, device="cpu")
    want = f32.one_to_list(pl, f32.load_gallery(pg)).scores
    got = q.one_to_list(pl, q.load_gallery(pg)).scores
    assert int(np.argmax(got)) == int(np.argmax(want)) == 3
    np.testing.assert_allclose(got[3], want[3], rtol=0.02)
    assert np.all(got[:3] < 0.1 * got[3])
