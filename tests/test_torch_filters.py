"""The port's standalone graph-filter entry points and the correspondence
selection on the CPU (plain versions) against the JAX package's Pallas
kernels in interpret mode and its XLA selection, on the same numpy inputs.

Tolerances: filter scores and partial sums rtol 1e-5 / atol 1e-4 (the two
sides differ in the order of the power iterations' and the reductions'
additions); the infuse kernel rtol 1e-5 / atol 1e-5, as the JAX package's
own infuse test; infuse after the port's selection against the whole
minutiae match rtol 1e-4 / atol 1e-4, as the JAX package's composed test
(the slots come in another order, so the power iterations sum in another
order); selected indices exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msu_latentafis_tpu.matcher import pallas_kernels as pk
from msu_latentafis_tpu.matcher.minutiae_match import (
    minutiae_correspondence_indices as jax_indices)
from msu_latentafis_tpu.matcher.minutiae_match import (
    minutiae_correspondences as jax_corr)
from msu_latentafis_tpu_torch.matcher.kernels import ops
from msu_latentafis_tpu_torch.matcher.minutiae_match import (
    minutiae_correspondence_indices, minutiae_correspondences,
    minutiae_similarity)


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
MODES = [(True, 3), (False, 5)]          # (lookup, dist_iters)


def T(a, dtype=torch.float32):
    return torch.as_tensor(np.ascontiguousarray(a)).to(dtype)


def _sets(rng, lookup, NP=4, K=40, n_li=None):
    """NP correspondence sets of K slots (test_pallas_kernels.py inputs)."""
    hi = 30 if lookup else 480
    val = rng.uniform(0.5, 3.0, (NP, K)).astype(np.float32)
    lxy = rng.integers(0, hi, (NP, K, 2)).astype(np.float32)
    rxy = rng.integers(0, hi, (NP, K, 2)).astype(np.float32)
    lori = rng.uniform(-np.pi, np.pi, (NP, K)).astype(np.float32)
    rori = rng.uniform(-np.pi, np.pi, (NP, K)).astype(np.float32)
    li = rng.integers(0, n_li or K, (NP, K)).astype(np.int32)
    ri = rng.integers(0, K // 2, (NP, K)).astype(np.int32)
    valid = rng.random((NP, K)) > 0.15
    return val, lxy, lori, rxy, rori, li, ri, valid


def _packs(lxy, lori, rxy, rori):
    def pack(xy, o):
        return np.concatenate([xy, np.cos(o)[..., None], np.sin(o)[..., None]],
                              -1).astype(np.float32)
    return pack(lxy, lori), pack(rxy, rori)


def _packed_pair(val, gl, gr, li, ri, valid, lookup, iters, **kw):
    want = pk.fused_graph_filter_packed(
        jnp.asarray(val), jnp.asarray(gl), jnp.asarray(gr), jnp.asarray(li),
        jnp.asarray(ri), jnp.asarray(valid), lookup=lookup, dist_iters=iters,
        tile=2, interpret=True, **kw)
    got = ops.graph_filter_packed(T(val), T(gl), T(gr), T(li, torch.int32),
                                  T(ri, torch.int32), T(valid, torch.bool),
                                  lookup, iters, **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("stages", range(7))
@pytest.mark.parametrize("lookup,iters", MODES)
def test_graph_filter_packed_stages_match_pallas(rng, lookup, iters, stages):
    """Every partial sum of the bench hook, 0 (I/O floor) to 6 (score)."""
    val, lxy, lori, rxy, rori, li, ri, valid = _sets(rng, lookup)
    gl, gr = _packs(lxy, lori, rxy, rori)
    got, want = _packed_pair(val, gl, gr, li, ri, valid, lookup, iters,
                             stages=stages)
    np.testing.assert_allclose(got, want, **TOL)
    assert ops.graph_filter_packed.launches == 0   # CPU tensors: plain path


@pytest.mark.parametrize("truncate", [False, True])
@pytest.mark.parametrize("lookup,iters", MODES)
def test_graph_filter_stage2_cap_matches_pallas(rng, lookup, iters,
                                                truncate):
    """stage2_cap above every set's stage-1 survivor count (latent indices
    take at most 12 values) changes nothing; below it, the survivors past
    the cap drop out of stage 2 while its seed still counts them all."""
    val, lxy, lori, rxy, rori, li, ri, valid = _sets(rng, lookup, NP=6,
                                                     n_li=12)
    gl, gr = _packs(lxy, lori, rxy, rori)
    stats = {}
    ops.graph_filter_packed_plain(T(val), T(gl), T(gr), T(li, torch.int32),
                                  T(ri, torch.int32), T(valid, torch.bool),
                                  lookup, iters, stats=stats)
    n1 = stats["n_stage1"].numpy()
    cap = max(1, int(n1.max()) - 1) if truncate else 12
    assert (n1 > cap).any() == truncate, (n1, cap)
    for stages in (4, 6):
        got, want = _packed_pair(val, gl, gr, li, ri, valid, lookup, iters,
                                 stages=stages, stage2_cap=cap)
        np.testing.assert_allclose(got, want, **TOL)
        base, _ = _packed_pair(val, gl, gr, li, ri, valid, lookup, iters,
                               stages=stages)
        if not truncate:
            np.testing.assert_array_equal(got, base)
        elif stages == 4:                    # fewer survivors, fewer pairs
            assert (got <= base).all()


@pytest.mark.parametrize("lookup,iters", MODES)
def test_graph_filter_matches_pallas(rng, lookup, iters):
    """The xy / ori entry point (cos / sin built by the wrapper)."""
    val, lxy, lori, rxy, rori, li, ri, valid = _sets(rng, lookup, NP=6,
                                                     K=48)
    want = pk.fused_graph_filter(
        jnp.asarray(val), jnp.asarray(lxy), jnp.asarray(lori),
        jnp.asarray(rxy), jnp.asarray(rori), jnp.asarray(li),
        jnp.asarray(ri), jnp.asarray(valid), lookup=lookup, dist_iters=iters,
        tile=2, interpret=True)
    got = ops.graph_filter(T(val), T(lxy), T(lori), T(rxy), T(rori),
                           T(li, torch.int32), T(ri, torch.int32),
                           T(valid, torch.bool), lookup, iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert ops.graph_filter.launches == 0


def _planes(rng, lookup, NT, B, P, R):
    hi = 30 if lookup else 480
    lx, ly = (rng.integers(0, hi, (NT, P)).astype(np.float32)
              for _ in range(2))
    lo = rng.uniform(-np.pi, np.pi, (NT, P)).astype(np.float32)
    rx, ry = (rng.integers(0, hi, (B, R)).astype(np.float32)
              for _ in range(2))
    ro = rng.uniform(-np.pi, np.pi, (B, R)).astype(np.float32)
    return (np.stack([lx, ly, np.cos(lo), np.sin(lo)], axis=1),
            np.stack([rx, ry, np.cos(ro), np.sin(ro)], axis=1))


@pytest.mark.parametrize("use_simi", [False, True])
@pytest.mark.parametrize("lookup,iters", MODES)
def test_graph_filter_infuse_matches_pallas(rng, lookup, iters, use_simi):
    """In-kernel gathers from the coordinate planes, with the weights given
    or recovered from the similarity block (test_pallas_kernels.py:103)."""
    NT, B, K, P, R = 2, 4, 32, 16, 24
    lpackT, rpackT = _planes(rng, lookup, NT, B, P, R)
    li = rng.integers(0, P, (NT, B, K)).astype(np.int32)
    ri = rng.integers(0, R, (NT, B, K)).astype(np.int32)
    valid = rng.random((NT, B, K)) > 0.15
    simi = rng.uniform(0.0, 3.0, (NT, B, P, R)).astype(np.float32)
    val = rng.uniform(0.5, 3.0, (NT, B, K)).astype(np.float32)
    want = pk.fused_graph_filter_infuse(
        None if use_simi else jnp.asarray(val), jnp.asarray(li),
        jnp.asarray(ri), jnp.asarray(valid), jnp.asarray(lpackT),
        jnp.asarray(rpackT), lookup=lookup, dist_iters=iters,
        simi=jnp.asarray(simi) if use_simi else None, tile_b=2,
        interpret=True)
    got = ops.graph_filter_infuse(
        None if use_simi else T(val), T(li, torch.int32), T(ri, torch.int32),
        T(valid, torch.bool), T(lpackT), T(rpackT), lookup, iters,
        simi=T(simi) if use_simi else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert ops.graph_filter_infuse.launches == 0


def test_infuse_gather_outside_the_planes_gives_zeros(rng):
    """An index outside [0, P) / [0, R) gathers zeros (a one-hot row of
    zeros on the TPU), weights included."""
    lpackT, rpackT = _planes(rng, False, 1, 1, 4, 5)
    li = T(np.array([[[0, 4, -1, 3]]]), torch.int32)
    ri = T(np.array([[[1, 5, 2, -2]]]), torch.int32)
    simi = T(rng.uniform(1, 2, (1, 1, 4, 5)))
    gl, gr, val = ops.infuse_gather(li, ri, T(lpackT), T(rpackT), simi)
    assert (gl[0, 0, 1:3] == 0).all() and (gl[0, 0, 0] != 0).any()
    assert (gr[0, 0, [1, 3]] == 0).all() and (gr[0, 0, 0] != 0).any()
    assert val[0, 0, 1:].eq(0).all() and val[0, 0, 0] == simi[0, 0, 0, 1]


def _similarity(rng, NT, B, P, R, D):
    """Descriptors and validity; entry 0 holds a noisy copy of template
    0's minutiae (a mate)."""
    lat = rng.standard_normal((NT, P, D)).astype(np.float32)
    lat /= np.linalg.norm(lat, axis=-1, keepdims=True)
    rol = rng.standard_normal((B, R, D)).astype(np.float32)
    rol[0, :P] = lat[0] + 0.2 * rng.standard_normal((P, D))
    rol /= np.linalg.norm(rol, axis=-1, keepdims=True)
    lv = rng.random((NT, P)) > 0.1
    rv = rng.random((B, R)) > 0.1
    return lat, rol, lv, rv


def test_minutiae_correspondence_indices_match_jax(rng):
    """The exact top-N indices over the batched normalized similarity equal
    JAX's (approx=False), and the one-matrix form equals JAX's per pair."""
    NT, B, Lm, Rm = 2, 3, 20, 28
    simi = rng.uniform(0, 2, (NT, B, Lm, Rm)).astype(np.float32)
    lv = rng.random((NT, Lm)) > 0.2
    rv = rng.random((B, Rm)) > 0.2
    simi = np.where(lv[:, None, :, None] & rv[None, :, None, :], simi, 0.0)
    simi = simi.astype(np.float32)
    wli, wri, wvalid = jax_indices(jnp.asarray(simi), jnp.asarray(lv),
                                   jnp.asarray(rv), top_n=40, approx=False)
    li, ri, valid = minutiae_correspondence_indices(
        T(simi), T(lv, torch.bool), T(rv, torch.bool), top_n=40)
    np.testing.assert_array_equal(li.numpy(), np.asarray(wli))
    np.testing.assert_array_equal(ri.numpy(), np.asarray(wri))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(wvalid))
    assert li.dtype == ri.dtype == torch.int32
    val, li1, ri1, valid1 = minutiae_correspondences(
        T(simi[1, 2]), T(lv[1], torch.bool), T(rv[2], torch.bool), top_n=40)
    jval, jli, jri, jvalid = jax_corr(jnp.asarray(simi[1, 2]),
                                      jnp.asarray(lv[1]), jnp.asarray(rv[2]),
                                      top_n=40)
    np.testing.assert_array_equal(li1.numpy(), np.asarray(jli))
    np.testing.assert_array_equal(ri1.numpy(), np.asarray(jri))
    np.testing.assert_array_equal(valid1.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(val.numpy(), np.asarray(jval))


def test_infuse_after_selection_matches_minutiae_match(rng):
    """Similarity, the port's exact selection and the infuse filter with
    in-kernel weight recovery reproduce the whole minutiae match at
    row_cap = R, the port's and the JAX kernel's
    (test_pallas_kernels.py:152-193)."""
    NT, B, P, R, D, K = 2, 4, 16, 24, 32, 20
    lat, rol, lv, rv = _similarity(rng, NT, B, P, R, D)
    lpackT, rpackT = _planes(rng, False, NT, B, P, R)
    rpackT[0, :, :P] = lpackT[0]              # the mate's geometry agrees
    want = pk.fused_minutiae_match(
        jnp.asarray(lat), jnp.asarray(lv, jnp.float32),
        jnp.asarray(np.swapaxes(rol, 1, 2)), jnp.asarray(rv, jnp.float32),
        jnp.asarray(lpackT), jnp.asarray(rpackT), top_n=K, row_cap=R,
        tile_b=2, interpret=True)
    simi = minutiae_similarity(T(lat), T(lv), T(rol), T(rv))
    li, ri, valid = minutiae_correspondence_indices(
        simi, T(lv, torch.bool), T(rv, torch.bool), top_n=K)
    got = ops.graph_filter_infuse(None, li, ri, valid, T(lpackT), T(rpackT),
                                  False, 5, simi=simi)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    port = ops.minutiae_match(T(lat), T(lv), T(rol), T(rv),
                              T(np.swapaxes(lpackT, 1, 2)),
                              T(np.swapaxes(rpackT, 1, 2)), top_n=K,
                              row_cap=R)
    np.testing.assert_allclose(got.numpy(), port.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert float(got[0, 0]) > 1.0


def test_filter_wrappers_validate_inputs(rng):
    val, lxy, lori, rxy, rori, li, ri, valid = _sets(rng, True, NP=2, K=8)
    gl, gr = _packs(lxy, lori, rxy, rori)
    args = [T(val), T(gl), T(gr), T(li, torch.int32), T(ri, torch.int32),
            T(valid, torch.bool)]
    with pytest.raises(TypeError):           # indices must be int32
        ops.graph_filter_packed(*args[:3], T(li, torch.long), *args[4:],
                                True, 3)
    with pytest.raises(ValueError):
        ops.graph_filter_packed(*args, True, 3, stage2_cap=-1)
    lpackT, rpackT = _planes(rng, True, 1, 2, 8, 8)
    idx = T(np.zeros((1, 2, 8)), torch.int32)
    vmask = T(np.ones((1, 2, 8)), torch.bool)
    with pytest.raises(ValueError):          # exactly one of val and simi
        ops.graph_filter_infuse(None, idx, idx, vmask, T(lpackT), T(rpackT),
                                True, 3)
