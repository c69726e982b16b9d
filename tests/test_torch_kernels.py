"""The port's kernels (their plain PyTorch versions on the CPU) against the
JAX package's Pallas kernels in interpret mode, on the same numpy inputs.

Tolerance rtol 1e-5 / atol 1e-4 on scores and maxima, argmax indices
exact: the two sides differ only in the summation order of the dot
products, the power iterations and the reductions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msu_latentafis_tpu.matcher import graph_filter as jgf
from msu_latentafis_tpu.matcher import pallas_kernels as pk
from msu_latentafis_tpu.matcher import texture_match as jtm
from msu_latentafis_tpu_torch.matcher import graph_filter as tgf
from msu_latentafis_tpu_torch.matcher import texture_match as ttm
from msu_latentafis_tpu_torch.matcher.kernels import ops


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


def T(a, dtype=torch.float32):
    return torch.as_tensor(np.ascontiguousarray(a)).to(dtype)


def _packs(rng, n, m, hi):
    xy = rng.integers(0, hi, (n, m, 2)).astype(np.float32)
    o = rng.uniform(-np.pi, np.pi, (n, m)).astype(np.float32)
    return np.concatenate([xy, np.cos(o)[..., None], np.sin(o)[..., None]],
                          axis=-1)


def test_adc_rowmax_matches_pallas(rng):
    NL, Lt, D, B, Rt = 2, 16, 96, 3, 24
    x = rng.standard_normal((NL, Lt, D)).astype(np.float32)
    lsq = np.sum(x ** 2, -1)
    dec = rng.standard_normal((B, Rt, D)).astype(np.float32)
    rsq = np.sum(dec ** 2, -1)
    valid = (rng.random((B, Rt)) > 0.2).astype(np.float32)
    valid[2] = 0.0                       # an entry with no valid column
    dec[0, 7] = dec[0, 3]                # an exact tie: first index wins
    rsq[0, 7] = rsq[0, 3]
    want_b, want_j = pk.fused_adc_rowmax(
        jnp.asarray(x), jnp.asarray(lsq), jnp.asarray(np.swapaxes(dec, 1, 2)),
        jnp.asarray(rsq), jnp.asarray(valid), interpret=True)
    best, bestj = ops.adc_rowmax(T(x), T(lsq), T(dec), T(rsq), T(valid))
    np.testing.assert_allclose(best.numpy(), np.asarray(want_b), **TOL)
    np.testing.assert_array_equal(bestj.numpy(), np.asarray(want_j))
    assert (best[:, 2] <= -1e30).all() and (bestj[:, 2] == 0).all()
    assert ops.adc_rowmax.launches == 0          # CPU tensors: plain path


@pytest.mark.parametrize("K", [24, 48])
def test_texture_match_matches_pallas(rng, K):
    NL, B, Lt, R = 2, 4, 48, 32
    best = rng.uniform(-3, 6, (NL, B, Lt)).astype(np.float32)
    bestj = rng.integers(0, R, (NL, B, Lt)).astype(np.int32)
    lat_valid = (rng.random((NL, Lt)) > 0.1).astype(np.float32)
    best[rng.random((NL, B, Lt)) < 0.05] = pk.NEG_BIG
    # entry 0 of latent 0 is a mate: correspondences agree geometrically
    lpack = _packs(rng, NL, Lt, 30)
    rpack = _packs(rng, B, R, 30)
    bestj[0, 0, :R] = np.arange(R)
    rpack[0] = lpack[0, :R]
    best[0, 0, :R] += 3.0
    want = pk.fused_texture_match(
        jnp.asarray(best), jnp.asarray(bestj), jnp.asarray(lat_valid),
        jnp.asarray(np.swapaxes(lpack, 1, 2)),
        jnp.asarray(np.swapaxes(rpack, 1, 2)), top_n=K, lookup=True,
        dist_iters=3, tile_b=2, interpret=True)
    got = ops.texture_match(T(best), T(bestj, torch.int32), T(lat_valid),
                            T(lpack), T(rpack), top_n=K, lookup=True,
                            dist_iters=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(got[0, 0]) > 1.0


def _minutiae_inputs(rng, NT, B, P, R, D):
    lat_des = rng.standard_normal((NT, P, D)).astype(np.float32)
    lat_des /= np.linalg.norm(lat_des, axis=-1, keepdims=True)
    rol_des = rng.standard_normal((B, R, D)).astype(np.float32)
    rol_des /= np.linalg.norm(rol_des, axis=-1, keepdims=True)
    rol_des[0, :P] = lat_des[0] + 0.2 * rng.standard_normal((P, D))
    lat_valid = (rng.random((NT, P)) > 0.1).astype(np.float32)
    rol_valid = (rng.random((B, R)) > 0.1).astype(np.float32)
    lpack = _packs(rng, NT, P, 480)
    rpack = _packs(rng, B, R, 480)
    rpack[0, :P] = lpack[0]
    return lat_des, lat_valid, rol_des, rol_valid, lpack, rpack


@pytest.mark.parametrize("row_cap", [8, 24])
def test_minutiae_match_matches_pallas(rng, row_cap):
    NT, B, P, R, D, K = 2, 4, 16, 24, 32, 20
    ld, lv, rd, rv, lp, rp = _minutiae_inputs(rng, NT, B, P, R, D)
    want = pk.fused_minutiae_match(
        jnp.asarray(ld), jnp.asarray(lv), jnp.asarray(np.swapaxes(rd, 1, 2)),
        jnp.asarray(rv), jnp.asarray(np.swapaxes(lp, 1, 2)),
        jnp.asarray(np.swapaxes(rp, 1, 2)), top_n=K, row_cap=row_cap,
        tile_b=2, interpret=True)
    got = ops.minutiae_match(T(ld), T(lv), T(rd), T(rv), T(lp), T(rp),
                             top_n=K, row_cap=row_cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(got[0, 0]) > 1.0


def test_minutiae_band_fills_in_spec_order():
    """With fewer positive similarities than top_n the bisect's (lo, hi]
    band is a run of zeros. The spec takes them in flat order p*R + r; the
    Pallas kernel takes them in candidate-table order (round, latent row)
    and so keeps other zero-similarity correspondences, which block
    differently. The port follows the spec. The seed is one where the two
    orders give different scores, so a return to table order fails here."""
    from msu_latentafis_tpu.matcher import reference_impl as spec
    rng = np.random.default_rng(2)
    P, R, D = 12, 16, 16
    a = rng.standard_normal(D)
    a /= np.linalg.norm(a)
    ld = (a + 0.6 * rng.standard_normal((P, D))).astype(np.float32)
    rd = (-a + 0.6 * rng.standard_normal((R, D))).astype(np.float32)
    rd[:4] = ld[:4] + 0.3 * rng.standard_normal((4, D))
    ld /= np.linalg.norm(ld, axis=-1, keepdims=True)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    lxy = rng.uniform(0, 200, (P, 2)).astype(np.float32)
    rxy = rng.uniform(0, 200, (R, 2)).astype(np.float32)
    rxy[:P] = lxy + rng.normal(0, 2, (P, 2))
    lori = rng.uniform(-np.pi, np.pi, P).astype(np.float32)
    rori = rng.uniform(-np.pi, np.pi, R).astype(np.float32)
    rori[:P] = lori
    top_n = 120
    assert int((ld @ rd.T > 0).sum()) < top_n < P * R

    def pack(xy, o):
        return np.concatenate([xy, np.cos(o)[:, None], np.sin(o)[:, None]],
                              axis=1).astype(np.float32)[None]
    lp, rp = pack(lxy, lori), pack(rxy, rori)
    ones_p, ones_r = np.ones((1, P), np.float32), np.ones((1, R), np.float32)
    want = spec.one2one_minutiae_matching(ld, lxy, lori, rd, rxy, rori)
    got = float(ops.minutiae_match(T(ld[None]), T(ones_p), T(rd[None]),
                                   T(ones_r), T(lp), T(rp), top_n=top_n,
                                   row_cap=R)[0, 0])
    pallas = float(np.asarray(pk.fused_minutiae_match(
        jnp.asarray(ld[None]), jnp.asarray(ones_p),
        jnp.asarray(np.swapaxes(rd[None], 1, 2)), jnp.asarray(ones_r),
        jnp.asarray(np.swapaxes(lp, 1, 2)), jnp.asarray(np.swapaxes(rp, 1, 2)),
        top_n=top_n, row_cap=R, tile_b=1, interpret=True))[0, 0])
    assert want > 0.5
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=2e-5)
    assert abs(pallas - want) > 1e-3


@pytest.mark.parametrize("lookup,iters", [(True, 3), (False, 5)])
def test_graph_filter_matches_pallas_and_xla(rng, lookup, iters):
    """filter_correspondences vs the packed Pallas filter body and the
    JAX reference filter (test_pallas_kernels.py:27 inputs)."""
    NP, K = 6, 48
    hi = 30 if lookup else 480
    val = rng.uniform(0.5, 3.0, (NP, K)).astype(np.float32)
    lxy = rng.integers(0, hi, (NP, K, 2)).astype(np.float32)
    rxy = rng.integers(0, hi, (NP, K, 2)).astype(np.float32)
    lori = rng.uniform(-np.pi, np.pi, (NP, K)).astype(np.float32)
    rori = rng.uniform(-np.pi, np.pi, (NP, K)).astype(np.float32)
    li = rng.integers(0, K, (NP, K)).astype(np.int32)
    ri = rng.integers(0, K // 2, (NP, K)).astype(np.int32)
    valid = rng.random((NP, K)) > 0.15
    gl = np.concatenate([lxy, np.cos(lori)[..., None],
                         np.sin(lori)[..., None]], -1)
    gr = np.concatenate([rxy, np.cos(rori)[..., None],
                         np.sin(rori)[..., None]], -1)
    got = tgf.filter_correspondences(T(val), T(li, torch.long),
                                     T(ri, torch.long), T(gl), T(gr),
                                     T(valid, torch.bool), lookup, iters)
    want = pk.fused_graph_filter_packed(
        jnp.asarray(val), jnp.asarray(gl), jnp.asarray(gr), jnp.asarray(li),
        jnp.asarray(ri), jnp.asarray(valid), lookup=lookup, dist_iters=iters,
        tile=2, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    import jax
    xla = jax.vmap(lambda v, a, b, lx, lo, rx, ro, vd: jgf.filter_correspondences(
        v, a, b, lx, lo, rx, ro, vd, lookup=lookup, dist_iters=iters))(
        jnp.asarray(val), jnp.asarray(li), jnp.asarray(ri), jnp.asarray(lxy),
        jnp.asarray(lori), jnp.asarray(rxy), jnp.asarray(rori),
        jnp.asarray(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), **TOL)


def test_filter_pieces_match_jax(rng):
    """build_dist_H, power_iteration and greedy selection on one set."""
    K = 32
    lxy = rng.integers(0, 30, (K, 2)).astype(np.float32)
    rxy = rng.integers(0, 30, (K, 2)).astype(np.float32)
    valid = rng.random(K) > 0.1
    pack = lambda xy: T(np.concatenate([xy, np.zeros((K, 2), np.float32)],
                                       -1)[None])
    for lookup in (True, False):
        H = tgf.build_dist_H(pack(lxy), pack(rxy), T(valid, torch.bool)[None],
                             lookup)[0]
        want = jgf.build_dist_H(jnp.asarray(lxy), jnp.asarray(rxy),
                                jnp.asarray(valid), lookup=lookup)
        np.testing.assert_allclose(H.numpy(), np.asarray(want), **TOL)
    b0 = rng.uniform(0.5, 3, K).astype(np.float32)
    S = tgf.power_iteration(H[None], T(b0)[None], 5)[0]
    np.testing.assert_allclose(
        S.numpy(), np.asarray(jgf.power_iteration(want, jnp.asarray(b0), 5)),
        rtol=1e-5, atol=1e-6)
    li = rng.integers(0, K // 2, K)
    ri = rng.integers(0, K // 2, K)
    compat = np.asarray(want) >= 1e-5
    conflict = (li[:, None] == li[None]) | (ri[:, None] == ri[None])
    bad = (conflict | ~compat) & ~np.eye(K, dtype=bool)
    sel = tgf.greedy_one_to_one(T(S.numpy())[None], T(bad, torch.bool)[None],
                                T(valid & (S.numpy() >= 1e-4), torch.bool)[None])
    want_sel = jgf.greedy_one_to_one(jnp.asarray(S.numpy()),
                                     jnp.asarray(compat), jnp.asarray(li),
                                     jnp.asarray(ri), jnp.asarray(valid), 1e-4)
    np.testing.assert_array_equal(sel[0].numpy(), np.asarray(want_sel))


def test_decode_and_texture_similarity_match_jax(rng):
    from msu_latentafis_tpu_torch.utils.synthetic import random_codebook
    cb = random_codebook(rng)
    S, C, d = cb.shape
    codes = rng.integers(0, C, (3, 20, S)).astype(np.uint8)
    got = ttm.decode_pq(T(codes, torch.uint8), T(cb))
    want = jtm.decode_pq(jnp.asarray(codes),
                         jnp.asarray(cb.reshape(S * C, d)), C)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = rng.standard_normal((10, S * d)).astype(np.float32)
    xv = rng.random(10) > 0.2
    rv = rng.random((3, 20)) > 0.2
    dec = got.numpy()
    sim = ttm.texture_similarity(T(x), T((x * x).sum(-1)), T(xv, torch.bool),
                                 T(dec), T((dec * dec).sum(-1)),
                                 T(rv, torch.bool))
    jsim = jtm.texture_similarity(
        jnp.asarray(x), jnp.asarray((x * x).sum(-1)), jnp.asarray(xv),
        jnp.asarray(np.swapaxes(dec, 1, 2)), jnp.asarray((dec * dec).sum(-1)),
        jnp.asarray(rv))
    np.testing.assert_allclose(sim.numpy(), np.asarray(jsim), **TOL)


def test_wrappers_validate_inputs():
    x = torch.zeros((1, 8, 4))
    with pytest.raises(ValueError):
        ops.adc_rowmax(x, torch.zeros((1, 7)), torch.zeros((2, 8, 4)),
                       torch.zeros((2, 8)), torch.zeros((2, 8)))
    with pytest.raises(TypeError):
        ops.adc_rowmax(x, torch.zeros((1, 8)), torch.zeros((2, 8, 4)),
                       torch.zeros((2, 8)), torch.zeros((2, 8),
                                                        dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.adc_rowmax(x.to("meta"), torch.zeros((1, 8), device="meta"),
                       torch.zeros((2, 8, 4), device="meta"),
                       torch.zeros((2, 8), device="meta"),
                       torch.zeros((2, 8), device="meta"))


def test_screen_bodies_count_card_launches_only(rng):
    """ops.SCREEN_BODIES names the ADC screens' bodies (the warpgroup tensor
    cores first); reset_launch_counts zeroes adc_screen.bodies and
    adc_screen_codes.bodies; on the CPU both wrappers return their plain
    versions' bits and count no launch and no body."""
    assert ops.SCREEN_BODIES == ("wgmma", "f32 body", "CUDA-core tiles")
    ops.adc_screen.bodies["wgmma"] += 1
    ops.adc_screen_codes.bodies["f32 body"] += 2
    ops.reset_launch_counts()
    for fn in (ops.adc_screen, ops.adc_screen_codes):
        assert fn.bodies == dict.fromkeys(ops.SCREEN_BODIES, 0)
    NL, Lt, B, Rt, S, C, sd = 2, 5, 3, 7, 2, 4, 6
    x = T(rng.standard_normal((NL, Lt, S * sd)), torch.bfloat16)
    cb = T(rng.standard_normal((S, C, sd)), torch.bfloat16)
    codes = T(rng.integers(0, C, (B, Rt, S)), torch.uint8)
    dec8 = T(rng.integers(-127, 128, (B, Rt, S * sd)), torch.int8)
    side = dict(lsq=x.float().pow(2).sum(-1), lvalid=torch.ones(NL, Lt),
                rsq=T(rng.uniform(0, 4, (B, Rt))),
                rvalid=T(rng.uniform(size=(B, Rt)) > 0.2))
    assert torch.equal(ops.adc_screen(x, dec=dec8, block=B, **side),
                       ops.adc_screen_plain(x, dec=dec8, block=B, **side))
    assert torch.equal(
        ops.adc_screen_codes(x, codes=codes, codebook=cb, **side),
        ops.adc_screen_codes_plain(x, codes=codes, codebook=cb, **side))
    for fn in (ops.adc_screen, ops.adc_screen_codes):
        assert fn.launches == 0
        assert fn.bodies == dict.fromkeys(ops.SCREEN_BODIES, 0)


def test_minutiae_match_single_matches_jax(rng):
    """One latent template vs one rolled template, exact top-K (row_cap =
    R) against the JAX XLA path (minutiae_similarity + top_k + filter)."""
    from msu_latentafis_tpu.matcher.minutiae_match import (
        minutiae_match_single as jax_single)
    from msu_latentafis_tpu_torch.matcher.minutiae_match import (
        minutiae_match_single)
    P, R, D = 20, 28, 32
    ld, lv, rd, rv, lp, rp = _minutiae_inputs(rng, 1, 1, P, R, D)
    lxy, rxy = lp[0, :, :2], rp[0, :, :2]
    lori = rng.uniform(-np.pi, np.pi, P).astype(np.float32)
    rori = rng.uniform(-np.pi, np.pi, R).astype(np.float32)
    rori[:P] = lori
    got = minutiae_match_single(T(ld[0]), T(lxy), T(lori), T(lv[0] > 0.5,
                                torch.bool), T(rd[0]), T(rxy), T(rori),
                                T(rv[0] > 0.5, torch.bool), row_cap=R)
    want = jax_single(jnp.asarray(ld[0]), jnp.asarray(lxy), jnp.asarray(lori),
                      jnp.asarray(lv[0] > 0.5), jnp.asarray(rd[0].T),
                      jnp.asarray(rxy), jnp.asarray(rori),
                      jnp.asarray(rv[0] > 0.5))
    np.testing.assert_allclose(float(got), float(want), **TOL)
    assert float(got) > 1.0


def test_large_print_plain_versions_match_pallas(rng):
    """A rolled print of 512 minutiae (past the old shared-memory envelope
    of the CUDA kernels): the plain minutiae match and both plain screens
    against the Pallas kernels in interpret mode."""
    NT, B, P, R, D = 1, 2, 16, 512, 16
    ld, lv, rd, rv, lp, rp = _minutiae_inputs(rng, NT, B, P, R, D)
    jl, jlv = jnp.asarray(ld), jnp.asarray(lv)
    jr, jrv = jnp.asarray(np.swapaxes(rd, 1, 2)), jnp.asarray(rv)
    want = pk.fused_minutiae_match(
        jl, jlv, jr, jrv, jnp.asarray(np.swapaxes(lp, 1, 2)),
        jnp.asarray(np.swapaxes(rp, 1, 2)), top_n=120, row_cap=8, tile_b=2,
        interpret=True)
    got = ops.minutiae_match(T(ld), T(lv), T(rd), T(rv), T(lp), T(rp),
                             top_n=120, row_cap=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(got[0, 0]) > 1.0
    for normalize in (False, True):
        want = pk.fused_minu_screen(jl, jlv, jr, jrv, normalize=normalize,
                                    interpret=True)
        got = ops.minu_screen(T(ld), T(lv), T(rd), T(rv),
                              normalize=normalize)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
