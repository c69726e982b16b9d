"""The port's serving slice on the CPU against the JAX package: the four
screen and codes kernels (plain versions) against the Pallas kernels in
interpret mode, and screen-then-rerank serving against the JAX engine.

Tolerances: screen scores and ADC maxima rtol 1e-5 / atol 1e-4 (the two
sides differ in the order of the dot products' and the row sums' additions,
and the JAX screen adds -|dec|^2 / 2 and the -1e4 sentinel inside the
contraction); argmax indices and serving candidate indices exact; a codes
layout against the predecoded layout of the same port exactly (decoded
values are exact codebook entries, the arithmetic is the same).
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msu_latentafis_tpu.matcher import pallas_kernels as pk
from msu_latentafis_tpu.matcher.engine import MatchEngine as JaxEngine
from msu_latentafis_tpu.matcher.texture_match import block_diag_codebook
from msu_latentafis_tpu_torch import cli
from msu_latentafis_tpu_torch.matcher.convert import gallery_from_jax
from msu_latentafis_tpu_torch.matcher.engine import MatchEngine
from msu_latentafis_tpu_torch.matcher.kernels import ops
from msu_latentafis_tpu_torch.templates import (
    pack_gallery, pack_latent, write_codebook, write_final_latent_template,
    write_final_rolled_pq_template)
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
CAPS = dict(minu_cap=32, tex_cap=48)


def T(a, dtype=torch.float32):
    return torch.as_tensor(np.ascontiguousarray(a)).to(dtype)


# ---------------------------------------------------------------------------
# kernels (plain versions) vs Pallas interpret mode
# ---------------------------------------------------------------------------

def test_minu_screen_matches_pallas(rng):
    NT, P, D, B, R = 3, 12, 8, 4, 20
    lat = rng.standard_normal((NT, P, D)).astype(np.float32)
    lval = (np.arange(P)[None, :] < np.array([8, 12, 5])[:, None]) \
        .astype(np.float32)
    rol = rng.standard_normal((B, R, D)).astype(np.float32)
    rval = (np.arange(R)[None, :] < np.array([20, 15, 20, 9])[:, None]) \
        .astype(np.float32)
    want = pk.fused_minu_screen(
        jnp.asarray(lat), jnp.asarray(lval),
        jnp.asarray(np.swapaxes(rol, 1, 2)), jnp.asarray(rval),
        interpret=True)
    got = ops.minu_screen(T(lat), T(lval), T(rol), T(rval))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_n = pk.fused_minu_screen(
        jnp.asarray(lat), jnp.asarray(lval),
        jnp.asarray(np.swapaxes(rol, 1, 2)), jnp.asarray(rval),
        normalize=True, interpret=True)
    got_n = ops.minu_screen(T(lat), T(lval), T(rol), T(rval), normalize=True)
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), **TOL)
    assert torch.equal(got_n, ops.minu_screen_norm_plain(T(lat), T(lval),
                                                         T(rol), T(rval)))
    assert ops.minu_screen.launches == 0          # CPU tensors: plain path
    assert ops.minu_screen_norm.launches == 0


def _adc_inputs(rng, NL=2, Lt=16, D=8, B=4, Rt=24):
    x = rng.standard_normal((NL, Lt, D)).astype(np.float32)
    lsq = np.sum(x ** 2, -1)
    lval = (np.arange(Lt)[None, :] < np.array([[12], [16]])[:, 0:1]) \
        .astype(np.float32)
    rval = (np.arange(Rt)[None, :] < 20).astype(np.float32) \
        * np.ones((B, 1), np.float32)
    rval[2] = 0.0                       # an entry with no valid column
    return x, lsq, lval, rval


@pytest.mark.parametrize("tau", [0.0, 2.0])
def test_adc_screen_matches_pallas(rng, tau):
    x, lsq, lval, rval = _adc_inputs(rng)
    dec = rng.standard_normal((4, 24, 8)).astype(np.float32)
    rsq = rng.uniform(0, 6, (4, 24)).astype(np.float32)
    want = pk.fused_adc_screen(
        jnp.asarray(x), jnp.asarray(lsq), jnp.asarray(lval),
        jnp.asarray(np.swapaxes(dec, 1, 2)), jnp.asarray(rsq),
        jnp.asarray(rval), tau=tau, interpret=True)
    got = ops.adc_screen(T(x), T(lsq), T(lval), T(dec), T(rsq), T(rval),
                         tau=tau)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got[:, 2] == 0.0).all()     # the all-invalid entry adds nothing


def _codes_inputs(rng, S=4, C=16, sd=2, B=4, Rt=24):
    cb = random_codebook(rng, n_subs=S, n_clusters=C, sub_dim=sd)
    codes = rng.integers(0, C, (B, Rt, S)).astype(np.uint8)
    codes[0, 7] = codes[0, 3]           # two equal columns: an exact tie
    dec = cb[np.arange(S)[None, None, :], codes].reshape(B, Rt, S * sd)
    rsq = np.sum(dec.astype(np.float64) ** 2, -1).astype(np.float32)
    tdec = np.ascontiguousarray(
        np.asarray(block_diag_codebook(cb), np.float32)
        .reshape(S * C, S * sd).T)
    return cb, codes, dec, rsq, tdec


def test_adc_screen_codes_matches_pallas(rng):
    cb, codes, dec, rsq, tdec = _codes_inputs(rng)
    x, lsq, lval, rval = _adc_inputs(rng)
    want = pk.fused_adc_screen_codes(
        jnp.asarray(x), jnp.asarray(lsq), jnp.asarray(lval),
        jnp.asarray(np.swapaxes(codes, 1, 2).copy()), jnp.asarray(tdec),
        jnp.asarray(rsq), jnp.asarray(rval), n_clusters=16, tau=1.0,
        interpret=True)
    args = (T(x), T(lsq), T(lval))
    got = ops.adc_screen_codes(*args, T(codes, torch.uint8), T(cb), T(rsq),
                               T(rval), tau=1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(got, ops.adc_screen(*args, T(dec), T(rsq), T(rval),
                                           tau=1.0))


def test_adc_rowmax_codes_matches_pallas(rng):
    cb, codes, dec, rsq, tdec = _codes_inputs(rng)
    x, lsq, _, rval = _adc_inputs(rng)
    want_b, want_j = pk.fused_adc_rowmax_codes(
        jnp.asarray(x), jnp.asarray(lsq),
        jnp.asarray(np.swapaxes(codes, 1, 2).copy()), jnp.asarray(tdec),
        jnp.asarray(rsq), jnp.asarray(rval), n_clusters=16, interpret=True)
    best, bestj = ops.adc_rowmax_codes(T(x), T(lsq), T(codes, torch.uint8),
                                       T(cb), T(rsq), T(rval))
    np.testing.assert_allclose(best.numpy(), np.asarray(want_b), **TOL)
    np.testing.assert_array_equal(bestj.numpy(), np.asarray(want_j))
    dbest, dbestj = ops.adc_rowmax(T(x), T(lsq), T(dec), T(rsq), T(rval))
    assert torch.equal(best, dbest) and torch.equal(bestj, dbestj)
    with pytest.raises(ValueError):     # the codebook must decode to D
        ops.adc_rowmax_codes(T(x), T(lsq), T(codes, torch.uint8),
                             T(cb[:, :, :1]), T(rsq), T(rval))


# ---------------------------------------------------------------------------
# serving: the port's engine vs the JAX engine
# ---------------------------------------------------------------------------

MATES = (13, 5, 20)                     # gallery position of latent i's mate


@pytest.fixture(scope="module")
def serving():
    """24 rolled templates (one mate for each of 3 latents), packed at caps
    32/48, with both engines at block 4."""
    rng = np.random.default_rng(20261017)
    cb = random_codebook(rng)
    lats = [make_latent_template(rng, n_minu=12, n_tex=30) for _ in MATES]
    gallery = [make_rolled_template(rng, n_minu=20, n_tex=40)
               for _ in range(24)]
    for lat, pos in zip(lats, MATES):
        gallery[pos] = make_rolled_template(rng, n_minu=20, n_tex=40,
                                            mated_latent=lat, codebook=cb)
    pg = pack_gallery(gallery, cb, **CAPS)
    pls = [pack_latent(l, quantize_tex_xy=False, **CAPS) for l in lats]
    je = JaxEngine(cb, block_size=4)
    te = MatchEngine(cb, block_size=4, row_cap=32, device="cpu")
    return dict(cb=cb, pg=pg, pls=pls, je=je, jgal=je.load_gallery(pg),
                te=te, tgal=te.load_gallery(pg))


def _assert_serving_equal(got, want):
    """idx exact; exact scores, margin and threshold within TOL (or both
    NaN / both the same infinity)."""
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), **TOL)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), **TOL)


def test_screen_scores_match_jax(serving):
    s = serving
    want = np.asarray(s["je"].screen_scores_batch(s["pls"], s["jgal"]))
    got = s["te"].screen_scores_batch(s["pls"], s["tgal"]).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert [int(np.argmax(r)) for r in got] == list(MATES)
    want_n = np.asarray(s["je"].screen_scores_batch(s["pls"], s["jgal"],
                                                    normalize=True))
    got_n = s["te"].screen_scores_batch(s["pls"], s["tgal"],
                                        normalize=True).numpy()
    np.testing.assert_allclose(got_n, want_n, **TOL)
    assert not np.array_equal(got_n, got)


def test_screen_upper_bounds_exact(serving):
    s = serving
    exact = s["te"].match_scores_batch(s["pls"], s["tgal"])
    screen = s["te"].screen_scores_batch(s["pls"], s["tgal"], tau=0.0)
    assert bool((screen + 1e-3 >= exact).all())


RERANK_CASES = {
    "no_prescreen": dict(m=8),
    "prescreen_k1_le_mpad": dict(m=8, prescreen_k=8, prescreen_lt=16,
                                 prescreen_t=1),
    "prescreen_k1_gt_mpad": dict(m=4, prescreen_k=12, prescreen_lt=16,
                                 prescreen_t=1),
}


@pytest.mark.parametrize("case", sorted(RERANK_CASES))
def test_reranked_matches_jax(serving, case):
    """Against the JAX engine's fused serving program (split_serving=False),
    the one that runs the two-stage screen when k1 > m_pad."""
    s, kw = serving, RERANK_CASES[case]
    want = s["je"].match_scores_batch_reranked(s["pls"], s["jgal"],
                                               split_serving=False, **kw)
    got = s["te"].match_scores_batch_reranked(s["pls"], s["tgal"], **kw)
    _assert_serving_equal(got, want)
    m_pad = -(-kw["m"] // 4) * 4
    assert got[0].shape == got[1].shape == (3, m_pad)
    assert np.isnan(got[2]).all() == ("prescreen_k" in kw)
    for i, pos in enumerate(MATES):
        assert got[0][i, np.argmax(got[1][i])] == pos


@pytest.mark.parametrize("case", sorted(RERANK_CASES))
def test_reranked_normalize_matches_jax(serving, case):
    """normalize=True serving against the JAX engine's fused serving
    program: the same kept indices, exact scores within TOL, margins and
    thresholds equal within TOL (numbers without prescreen, though the
    normalized screen certifies nothing) or both NaN (prescreen)."""
    s, kw = serving, RERANK_CASES[case]
    want = s["je"].match_scores_batch_reranked(
        s["pls"], s["jgal"], split_serving=False, normalize=True, **kw)
    got = s["te"].match_scores_batch_reranked(s["pls"], s["tgal"],
                                              normalize=True, **kw)
    _assert_serving_equal(got, want)
    assert np.isnan(got[2]).all() == ("prescreen_k" in kw)
    assert np.isfinite(got[2]).all() == ("prescreen_k" not in kw)


def test_rerank_ties_at_the_cut():
    """A gallery of one mate and five impostors, each entered twice: the
    sorted screen has equal values at positions m_pad - 1 and m_pad, and
    the kept indices must be JAX's (lower position first)."""
    rng = np.random.default_rng(7)
    cb = random_codebook(rng)
    lat_t = make_latent_template(rng, n_minu=12, n_tex=30)
    imps = [make_rolled_template(rng, n_minu=20, n_tex=40) for _ in range(5)]
    mate = make_rolled_template(rng, n_minu=20, n_tex=40, mated_latent=lat_t,
                                codebook=cb)
    pg = pack_gallery([mate] + imps + imps, cb, **CAPS)
    lat = pack_latent(lat_t, quantize_tex_xy=False, **CAPS)
    te = MatchEngine(cb, block_size=4, row_cap=32, device="cpu")
    tgal = te.load_gallery(pg)
    srt = torch.sort(te.screen_scores_batch([lat], tgal)[0],
                     descending=True).values
    assert srt[3] == srt[4] and srt[0] > srt[1]   # a tie across the cut
    je = JaxEngine(cb, block_size=4)
    want = je.match_scores_batch_reranked([lat], je.load_gallery(pg), m=4,
                                          split_serving=False)
    got = te.match_scores_batch_reranked([lat], tgal, m=4)
    _assert_serving_equal(got, want)


def test_one_to_list_reranked_matches_jax(serving):
    s = serving
    want = s["je"].one_to_list_reranked(s["pls"][1], s["jgal"], m=8)
    got = s["te"].one_to_list_reranked(s["pls"][1], s["tgal"], m=8)
    assert got.names == want.names and got.scores.shape == (24,)
    np.testing.assert_allclose(got.scores, want.scores, **TOL)
    assert got.ranked(1)[0][0] == want.ranked(1)[0][0] == s["pg"].names[
        MATES[1]]
    assert (got.scores == -1.0).sum() == 24 - 8


def test_codes_resident_equals_predecoded(serving):
    """The same gallery codes-resident and predecoded: equal dense scores
    and equal serving results, bit for bit."""
    s = serving
    tc = MatchEngine(s["cb"], block_size=4, row_cap=32, codes_resident=True,
                     device="cpu")
    cgal = tc.load_gallery(s["pg"])
    assert cgal.tex_dec is None and cgal.tex_codes.dtype == torch.uint8
    assert torch.equal(tc.match_scores_batch(s["pls"], cgal),
                       s["te"].match_scores_batch(s["pls"], s["tgal"]))
    for kw in RERANK_CASES.values():
        got = tc.match_scores_batch_reranked(s["pls"], cgal, **kw)
        want = s["te"].match_scores_batch_reranked(s["pls"], s["tgal"], **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_codes_resident_rule():
    """None predecodes a gallery in host memory by the JAX engine's rule
    (``_should_predecode``): its predecoded texture counted at 2 bytes per
    element, 1 with tex_int8, under the 9e9-byte budget. At Rt 448 / D 96,
    block 64, the last predecoded padded size is 104,576 entries (209,216
    with tex_int8), whatever the compute dtype; the modes construct."""
    cb = random_codebook(np.random.default_rng(0))
    je = JaxEngine(cb)
    for kw, last in ((dict(), 104576), (dict(tex_int8=True), 209216)):
        for dtype in (torch.float32, torch.bfloat16):
            e = MatchEngine(cb, device="cpu", compute_dtype=dtype, **kw)
            assert e.should_predecode(last, 448), (kw, dtype)
            assert not e.should_predecode(last + 64, 448), (kw, dtype)
        j = JaxEngine(cb, **kw)
        assert j._should_predecode(last, 448)
        assert not j._should_predecode(last + 64, 448)
    assert je._should_predecode(104576, 448)
    assert not MatchEngine(cb, codes_resident=True, device="cpu") \
        .should_predecode(64, 448)
    for kw in (dict(tex_int8=True), dict(minu_int8=True),
               dict(compute_dtype=torch.bfloat16)):
        e = MatchEngine(cb, device="cpu", **kw)
        assert (e.compute_dtype, e.tex_int8, e.minu_int8) == (
            kw.get("compute_dtype", torch.float32),
            kw.get("tex_int8", False), kw.get("minu_int8", False))
    with pytest.raises(ValueError):
        MatchEngine(cb, device="cpu", compute_dtype=torch.float16)


def test_codes_resident_rule_on_cuda(monkeypatch):
    """On a CUDA device None predecodes while the f32 texture fits in half
    the free device memory: a 100,000-entry gallery (17.2 GB) is
    predecoded beside 79 GB free and stays codes-resident beside 30 GB."""
    cb = random_codebook(np.random.default_rng(0))
    e = MatchEngine(cb, device="cpu")
    e.device = torch.device("cuda")
    G, nbytes = 100032, 100032 * 448 * 96 * 4
    for free, want in ((79 * 10 ** 9, True), (30 * 10 ** 9, False),
                       (2 * nbytes, False), (2 * nbytes + 2, True)):
        monkeypatch.setattr(torch.cuda, "mem_get_info",
                            lambda device, free=free: (free, 80 * 10 ** 9))
        assert e.should_predecode(G, 448) == want, free
    # counted on the bytes the predecoded tensor takes: 2 per element in
    # bf16, 1 with tex_int8
    for kw, per in ((dict(compute_dtype=torch.bfloat16), 2),
                    (dict(tex_int8=True), 1)):
        e = MatchEngine(cb, device="cpu", **kw)
        e.device = torch.device("cuda")
        nb = G * 448 * 96 * per
        for free, want in ((2 * nb, False), (2 * nb + 2, True)):
            monkeypatch.setattr(torch.cuda, "mem_get_info",
                                lambda device, free=free: (free,
                                                           80 * 10 ** 9))
            assert e.should_predecode(G, 448) == want, (kw, free)


def test_gallery_holds_one_texture_layout():
    """A DeviceGallery holds tex_dec or tex_codes, never both or neither;
    the synthetic pair shares every other tensor, its codes decode to the
    predecoded twin, and planting mates writes each layout."""
    from msu_latentafis_tpu_torch.matcher.texture_match import decode_pq
    from msu_latentafis_tpu_torch.utils.synthetic import (
        device_synthetic_gallery, plant_gallery_entries)
    rng = np.random.default_rng(3)
    cb = random_codebook(rng)
    e = MatchEngine(cb, block_size=4, device="cpu")
    pre, codes = device_synthetic_gallery(e, 6, n_minu=8, n_tex=12, seed=1,
                                          both_layouts=True)
    assert pre.size == codes.size == 8 and pre.n_real == 6
    assert pre.tex_codes is None and codes.tex_dec is None
    assert codes.codes_resident and not pre.codes_resident
    for f in ("minu_des", "minu_pack", "minu_n", "tex_sqnorm", "tex_pack",
              "tex_n"):
        assert getattr(pre, f) is getattr(codes, f)
    real = slice(0, pre.n_real)          # padding rows: zero dec, zero codes

    def decodes_to_twin():
        return torch.equal(decode_pq(codes.tex_codes[real], e.codebook_t),
                           pre.tex_dec[real])
    assert decodes_to_twin()
    with pytest.raises(ValueError):
        dataclasses.replace(pre, tex_codes=codes.tex_codes)
    with pytest.raises(ValueError):
        dataclasses.replace(pre, tex_dec=None)
    mate = make_rolled_template(rng, n_minu=8, n_tex=12)
    pm = pack_gallery([mate], cb, names=["mate"], minu_cap=8, tex_cap=12)
    for g in (pre, codes):
        plant_gallery_entries(g, e, pm, [2])
        assert g.names[2] == "mate"
    assert torch.equal(codes.tex_codes[2], T(pm.tex_codes[0], torch.uint8))
    assert decodes_to_twin()


@pytest.mark.parametrize("layout", ["tex_codes_t", "tex_codes"])
def test_gallery_from_jax_codes(serving, layout):
    """A JAX codes gallery (codes-resident planes, or flat codes), carried
    over, scores exactly like the port's own codes-resident load."""
    s = serving
    je = JaxEngine(s["cb"], block_size=4, codes_resident=True) \
        if layout == "tex_codes_t" else JaxEngine(s["cb"], block_size=4,
                                                  predecode=False)
    arrays = {k: np.asarray(v) for k, v in
              je._gallery_dict(je.load_gallery(s["pg"])).items()}
    assert layout in arrays and "tex_dec" not in arrays
    conv = gallery_from_jax(arrays, names=s["pg"].names, n_real=24,
                            device="cpu")
    tc = MatchEngine(s["cb"], block_size=4, row_cap=32, codes_resident=True,
                     device="cpu")
    own = tc.load_gallery(s["pg"])
    assert torch.equal(conv.tex_codes, own.tex_codes)
    assert torch.equal(tc.match_scores_batch(s["pls"], conv),
                       tc.match_scores_batch(s["pls"], own))
    kw = RERANK_CASES["prescreen_k1_gt_mpad"]
    for g, w in zip(tc.match_scores_batch_reranked(s["pls"], conv, **kw),
                    tc.match_scores_batch_reranked(s["pls"], own, **kw)):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _to_pixels(t):
    for tt in t.texture_template:
        m = np.asarray(tt.minutiae, np.float64)
        m[:, :2] = m[:, :2] * 16.0 + 24.0
        tt.minutiae = m
    return t


def test_cli_rerank_writes_rank_csv(tmp_path):
    rng = np.random.default_rng(3)
    cb = random_codebook(rng)
    cbf = tmp_path / "codebook.dat"
    write_codebook(cbf, cb)
    lat = make_latent_template(rng, n_minu=16, n_tex=40)
    gdir = tmp_path / "gallery"
    gdir.mkdir()
    for j in range(10):
        write_final_rolled_pq_template(
            os.path.join(gdir, f"r{j}.dat"), _to_pixels(make_rolled_template(
                rng, n_minu=20, n_tex=40, mated_latent=lat if j == 6 else None,
                codebook=cb if j == 6 else None)))
    latf = tmp_path / "q.dat"
    write_final_latent_template(latf, _to_pixels(lat))
    sdir = tmp_path / "scores"
    rc = cli.main(["match", "-l", str(latf), "-g", str(gdir), "-c", str(cbf),
                   "-s", str(sdir), "--device", "cpu", "--rerank", "4",
                   "--prescreen", "2", "--prescreen-lt", "16"])
    assert rc == 0
    lines = (sdir / "q.csv").read_text().splitlines()
    assert lines[0] == "filename,score" and lines[1].startswith("1r6,")
    assert len(lines) == 1 + 10


def test_cli_prescreen_needs_rerank(tmp_path):
    with pytest.raises(SystemExit) as e:
        cli.main(["match", "-l", "q.dat", "-g", str(tmp_path), "-c", "cb.dat",
                  "-s", str(tmp_path), "--prescreen", "8"])
    assert e.value.code != 0


def test_cli_config_reaches_the_bf16_engine(tmp_path, monkeypatch):
    """``--config`` with ComputeDtype "bfloat16": -c / -s fall back to
    CodebookPath / ScorePath, MatchBlockSize and the bf16 engine are used,
    and the mate is rank 1."""
    import json
    rng = np.random.default_rng(5)
    cb = random_codebook(rng)
    cbf = tmp_path / "codebook.dat"
    write_codebook(cbf, cb)
    lat = make_latent_template(rng, n_minu=16, n_tex=40)
    gdir = tmp_path / "gallery"
    gdir.mkdir()
    for j in range(6):
        write_final_rolled_pq_template(
            os.path.join(gdir, f"r{j}.dat"), _to_pixels(make_rolled_template(
                rng, n_minu=20, n_tex=40, mated_latent=lat if j == 4 else None,
                codebook=cb if j == 4 else None)))
    latf = tmp_path / "q.dat"
    write_final_latent_template(latf, _to_pixels(lat))
    sdir = tmp_path / "scores"
    cfg = tmp_path / "afis.config"
    cfg.write_text(json.dumps({"CodebookPath": str(cbf),
                               "ScorePath": str(sdir), "MatchBlockSize": 4,
                               "ComputeDtype": "bfloat16",
                               "EnhancementModel": "unused"}))
    seen = []
    real = cli.MatchEngine

    def spy(*a, **kw):
        e = real(*a, **kw)
        seen.append(e)
        return e
    monkeypatch.setattr(cli, "MatchEngine", spy)
    rc = cli.main(["match", "-l", str(latf), "-g", str(gdir), "--config",
                   str(cfg), "--device", "cpu"])
    assert rc == 0
    assert seen[0].compute_dtype == torch.bfloat16
    assert seen[0].block_size == 4
    lines = (sdir / "q.csv").read_text().splitlines()
    assert lines[0] == "filename,score" and lines[1].startswith("1r4,")
    monkeypatch.chdir(tmp_path)          # found from the working directory
    sdir.joinpath("q.csv").unlink()
    assert cli.main(["match", "-l", str(latf), "-g", str(gdir), "--device",
                     "cpu"]) == 0
    assert seen[1].compute_dtype == torch.bfloat16
    assert (sdir / "q.csv").exists()
