"""The port's gallery build (PQ, CompNet DR, postprocess) against the JAX
package on the CPU, on inputs made from numpy seeds."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.cluster.vq import vq

from msu_latentafis_tpu.models.compnet import CompNet as FlaxCompNet
from msu_latentafis_tpu.models.compnet import \
    compress_descriptors as jax_compress
from msu_latentafis_tpu.ops import pq as jpq
from msu_latentafis_tpu.pipeline import postprocess as jpost
from msu_latentafis_tpu.templates import codec as jcodec
from msu_latentafis_tpu.utils import synthetic as jsyn
from msu_latentafis_tpu_torch.models.compnet import (
    CompNet, compnet_from_flax, compress_descriptors)
from msu_latentafis_tpu_torch.ops import pq
from msu_latentafis_tpu_torch.pipeline import ModelBundle, postprocess
from msu_latentafis_tpu_torch.templates import (
    read_final_template, write_codebook)
from msu_latentafis_tpu_torch.utils import synthetic as syn


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch on one intra-op thread: the suite's workers share the host's
    cores, and an intra-op pool in each spins waiting on the others (a
    test ran 7x slower with 8 threads than with 1 beside 8 busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STANDIN = os.path.join(ROOT, "checkpoints", "standin", "compnet")
DR_TOL = dict(rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# PQ
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N", [200, 1025])
def test_pq_encode_equals_jax_and_scipy(N):
    rng = np.random.default_rng(N)
    cb = syn.random_codebook(rng)
    des = syn.random_descriptors(rng, N)
    codes = pq.pq_encode(des, cb, device="cpu")
    assert codes.dtype == np.uint8 and codes.shape == (N, 16)
    np.testing.assert_array_equal(codes, jpq.pq_encode(des, cb))
    ref = np.stack([vq(des[:, m * 6:(m + 1) * 6], cb[m])[0]
                    for m in range(16)], axis=1)
    np.testing.assert_array_equal(codes, ref)
    np.testing.assert_array_equal(pq.pq_decode(codes, cb),
                                  jpq.pq_decode(codes, cb))
    assert pq.pq_encode(des[:0], cb, device="cpu").shape == (0, 16)


def test_pq_encode_keeps_the_first_of_tied_centroids():
    cb = syn.random_codebook(np.random.default_rng(1))
    cb[:, 7] = cb[:, 3]                       # centroid 7 duplicates 3
    des = cb[np.arange(16), np.full(16, 3)].reshape(1, 96)
    codes = pq.pq_encode(des, cb, device="cpu")
    np.testing.assert_array_equal(codes, jpq.pq_encode(des, cb))
    assert np.all(codes == 3)


def test_code_flip_bound_measures_the_gap():
    rng = np.random.default_rng(2)
    cb = syn.random_codebook(rng)
    des = syn.random_descriptors(rng, 50)
    a = pq.pq_encode(des, cb, device="cpu")
    b = a.copy()
    b[3, 5] = (int(b[3, 5]) + 1) % 256         # a far code: gap above bound
    gaps = pq.code_flip_bound(des, cb, a, b)
    assert gaps.shape == (1, 2) and gaps[0, 0] > gaps[0, 1] > 0
    assert pq.code_flip_bound(des, cb, a, a).shape == (0, 2)


def _index_order_codes(x, cb):
    """Codes of the expansion summed in index order, each product and sum
    its own rounding: another summation order than the batched product's."""
    xx = (x[..., 0] * x[..., 0])[:, :, None]
    dot = (2.0 * x[..., None, 0]) * cb[:, None, :, 0]
    cc = cb[..., 0] * cb[..., 0]
    for k in range(1, x.shape[-1]):
        xx = xx + (x[..., k] * x[..., k])[:, :, None]
        dot = dot + (2.0 * x[..., None, k]) * cb[:, None, :, k]
        cc = cc + cb[..., k] * cb[..., k]
    return torch.argmin((xx - dot) + cc[:, None, :], dim=2)


def test_tie_bound_covers_another_summation_order():
    """Wherever another summation order picks another code than the CPU
    path, the CPU path's two best distances lie within ``tie_bound``: the
    card's refine catches every entry whose code could differ."""
    rng = np.random.default_rng(40)
    cb = torch.as_tensor(syn.random_codebook(rng), dtype=torch.float32)
    x = torch.as_tensor(syn.random_descriptors(rng, 20000)) \
        .reshape(-1, 16, 6).transpose(0, 1).contiguous()
    a = torch.arange(500) % 256
    x[:, :500] = (cb[:, a] + cb[:, (a + 1) % 256]) / 2     # near ties
    d2 = pq._distances(x, cb)
    codes = torch.argmin(d2, dim=2)
    first, tied = pq._rank(d2, x)            # the card's ranking pass
    assert torch.equal(first[~tied], codes[~tied])
    other = _index_order_codes(x, cb)
    differ = other != codes
    assert differ.any() and tied[differ].all()
    assert tied.float().mean() < 0.05


def test_refine_writes_the_cpu_codes():
    """The card's refine, run on CPU tensors: wrong codes at the tied
    entries come back as the CPU path's; a batch of one row gives that
    row's codes within a larger batch."""
    rng = np.random.default_rng(41)
    cb = torch.as_tensor(syn.random_codebook(rng), dtype=torch.float32)
    x = torch.as_tensor(syn.random_descriptors(rng, 3000)) \
        .reshape(-1, 16, 6).transpose(0, 1).contiguous()
    want = pq.assign_rows(x, cb)
    out = want.clone()
    subs = torch.tensor([0, 0, 3, 15, 15])
    rows = torch.tensor([5, 2999, 7, 0, 1])
    out[subs, rows] = (out[subs, rows] + 1) % 256
    pq._refine(x, cb, out, subs, rows)
    assert torch.equal(out, want)
    for r in (0, 17, 2999):
        assert torch.equal(pq.assign_rows(x[:, r:r + 1], cb)[:, 0],
                           want[:, r])


@pytest.mark.parametrize("far", [False, True])
def test_train_codebook_steps_equal_jax(far):
    """From the point initialization of train_codebook(seed=3), every Lloyd
    step's assignments equal the JAX package's, and its centroids are
    within atol 1e-5 of JAX's at every step and in the final codebook.
    ``far`` moves 8 of each subspace's 256 starting centroids out of reach
    of every row: their clusters stay empty and the centroids stay put."""
    rng = np.random.default_rng(20)
    x = syn.random_descriptors(rng, 2000)
    N, S, K, d, iters = 2000, 16, 256, 6, 5
    init = pq.init_indices(N, S, K, seed=3)
    c0 = np.stack([x[init[m], m * d:(m + 1) * d] for m in range(S)])
    if far:
        c0[:, ::32] += 10.0
    xs = torch.as_tensor(x).reshape(N, S, d).transpose(0, 1).contiguous()
    c = torch.as_tensor(c0)
    cj = [jnp.asarray(c0[m]) for m in range(S)]
    empty = 0
    for _ in range(iters):
        c_next, assign = pq.lloyd_step(xs, c)
        for m in range(S):
            sub = jnp.asarray(x[:, m * d:(m + 1) * d])
            np.testing.assert_array_equal(
                assign[m].numpy(), np.asarray(jpq._assign(sub, cj[m])))
            empty += K - len(np.unique(assign[m].numpy()))
            cj[m] = jpq._lloyd_step(sub, cj[m], K)
            np.testing.assert_allclose(c_next[m].numpy(), np.asarray(cj[m]),
                                       rtol=0, atol=1e-5)
        c = c_next
    if far:
        assert empty >= S * 8 * iters
        np.testing.assert_array_equal(c[:, ::32].numpy(), c0[:, ::32])
        return
    np.testing.assert_allclose(
        pq.train_codebook(x, iters=iters, seed=3, device="cpu"),
        jpq.train_codebook(x, iters=iters, seed=3), rtol=0, atol=1e-5)


def test_train_codebook_rejects_bad_shapes():
    x = np.zeros((300, 96), np.float32)
    with pytest.raises(ValueError):
        pq.train_codebook(x[:256], device="cpu")
    with pytest.raises(ValueError):
        pq.train_codebook(x[:, :95], device="cpu")


# ---------------------------------------------------------------------------
# CompNet
# ---------------------------------------------------------------------------

def _flax_vars(seed: int):
    """A seeded Flax CompNet with non-trivial batch statistics."""
    v = FlaxCompNet().init(jax.random.PRNGKey(seed), jnp.zeros((1, 192)),
                           train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(seed)
    stats = v["batch_stats"]
    for bn in [stats["BatchNorm_0"], stats["BatchNorm_1"]] + list(
            stats["BasicBlock_0"].values()):
        bn["mean"] = rng.normal(0, 0.1, 96).astype(np.float32)
        bn["var"] = rng.uniform(0.05, 2.0, 96).astype(np.float32)
    return v


def _jax_apply(variables, x):
    return np.asarray(FlaxCompNet().apply(variables, jnp.asarray(x),
                                          train=False))


@pytest.fixture(scope="module")
def flax_vars():
    return _flax_vars(1)


def test_compnet_from_flax_matches_flax(flax_vars):
    net = compnet_from_flax(flax_vars)
    assert isinstance(net, CompNet) and not net.training
    x = np.random.default_rng(5).standard_normal((300, 192)) \
        .astype(np.float32)
    with torch.no_grad():
        out = net(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(out, _jax_apply(flax_vars, x), **DR_TOL)
    extra = dict(flax_vars, params=dict(flax_vars["params"],
                                        Dense_9={"kernel": np.zeros((1, 1))}))
    with pytest.raises(ValueError, match="Dense_9"):
        compnet_from_flax(extra)
    missing = dict(flax_vars, batch_stats=dict(flax_vars["batch_stats"]))
    del missing["batch_stats"]["BatchNorm_1"]
    with pytest.raises(RuntimeError):
        compnet_from_flax(missing)


@pytest.mark.parametrize("N", [0, 1, 300])
def test_compress_descriptors_matches_jax(flax_vars, N):
    x = np.random.default_rng(N).standard_normal((N, 192)).astype(np.float32)
    got = ModelBundle(compnet_from_flax(flax_vars), device="cpu").compress(x)
    want = jax_compress(_jax_apply, flax_vars, x)
    assert got.shape == want.shape == (N, 96) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **DR_TOL)
    if N:
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.73,
                                   rtol=1e-6)


def test_standin_checkpoint_compress_matches_jax():
    """The stand-in checkpoint (trained batch statistics), restored by the
    JAX package's Orbax reader, through compnet_from_flax."""
    if not os.path.isdir(STANDIN):
        pytest.skip("checkpoints/standin/compnet is absent from this checkout")
    from msu_latentafis_tpu.pipeline.models_bundle import _try_restore
    init = FlaxCompNet().init(jax.random.PRNGKey(0), jnp.zeros((1, 192)),
                              train=False)
    v = jax.tree_util.tree_map(np.asarray, _try_restore(STANDIN, init))
    var = v["batch_stats"]["BatchNorm_0"]["var"]
    assert not np.allclose(var, 1.0), "the checkpoint did not restore"
    x = np.random.default_rng(9).standard_normal((300, 192)) \
        .astype(np.float32)
    got = compress_descriptors(compnet_from_flax(v), x)
    np.testing.assert_allclose(got, jax_compress(_jax_apply, v, x), **DR_TOL)


# ---------------------------------------------------------------------------
# postprocess
# ---------------------------------------------------------------------------

class _JaxBundle:
    """The one method of the JAX package's ModelBundle that postprocess
    calls, over the same Flax variables."""

    def __init__(self, variables):
        self.variables = variables

    def compress(self, des):
        return jax_compress(_jax_apply, self.variables, des)


def _tfc_gallery(rng, tdir, ldir):
    """JAX-written TF_C files: 6 rolled prints (one with no texture
    template, one empty) and 2 latents, 192-d descriptors."""
    os.makedirs(tdir)
    os.makedirs(ldir)
    for j in range(6):
        t = jsyn.make_rolled_template(rng, n_minu=int(rng.integers(10, 40)),
                                      n_tex=int(rng.integers(20, 80)),
                                      des_dim=192)
        mt = t.minu_template[0]
        mt.minutiae = np.column_stack([mt.minutiae, np.ones(len(mt.minutiae))])
        tt = t.texture_template[0]
        tt.des = jsyn.random_descriptors(rng, len(tt.minutiae), 192)
        tt.minutiae = tt.minutiae[:, :3] * [16, 16, 1] + [24, 24, 0]
        if j == 4:
            t.texture_template = []
        jcodec.write_template(os.path.join(tdir, f"r{j}.dat"),
                              None if j == 5 else t, is_latent=False)
    for i in range(2):
        t = jsyn.make_latent_template(rng, n_minu=20, n_tex=40, des_dim=192,
                                      n_minu_templates=3)
        jcodec.write_template(os.path.join(ldir, f"l{i}.dat"), t)


def _files(d):
    return sorted(os.listdir(d))


def test_postprocess_matches_jax(tmp_path, flax_vars):
    """template_compression + encode_pq: the port's final files against the
    JAX package's (codes equal, floats within the DR tolerance), and the
    port's encode_pq on the JAX package's DR output byte for byte."""
    rng = np.random.default_rng(2027)
    cb = syn.random_codebook(rng)
    cb_path = str(tmp_path / "cb.dat")
    write_codebook(cb_path, cb)
    src = {"rolled": str(tmp_path / "tfc_r"), "latent": str(tmp_path / "tfc_l")}
    _tfc_gallery(rng, src["rolled"], src["latent"])
    port = ModelBundle(compnet_from_flax(flax_vars), device="cpu")
    jax_bundle = _JaxBundle(flax_vars)
    for kind, is_latent in (("rolled", False), ("latent", True)):
        dr, final = {}, {}
        for who, mod, bundle in (("port", postprocess, port),
                                 ("jax", jpost, jax_bundle)):
            dr[who] = str(tmp_path / f"{who}_dr_{kind}")
            final[who] = str(tmp_path / f"{who}_final_{kind}")
            mod.template_compression(bundle, src[kind], dr[who],
                                     is_latent=is_latent)
            kw = dict(device="cpu") if who == "port" else {}
            mod.encode_pq(dr[who], final[who], kind, cb_path, **kw)
        cross = str(tmp_path / f"cross_{kind}")
        postprocess.encode_pq(dr["jax"], cross, kind, cb_path, device="cpu")
        assert _files(final["port"]) == _files(final["jax"]) == _files(cross)
        for name in _files(final["jax"]):
            with open(os.path.join(cross, name), "rb") as f, \
                    open(os.path.join(final["jax"], name), "rb") as g:
                assert f.read() == g.read(), name
            a = read_final_template(os.path.join(final["port"], name), kind)
            b = read_final_template(os.path.join(final["jax"], name), kind)
            assert len(a.minu_template) == len(b.minu_template)
            for x, y in zip(a.minu_template, b.minu_template):
                np.testing.assert_array_equal(x.minutiae, y.minutiae)
                np.testing.assert_allclose(x.des, y.des, **DR_TOL)
            for x, y in zip(a.texture_template, b.texture_template):
                if kind == "rolled":
                    np.testing.assert_array_equal(x.des, y.des)
                else:
                    np.testing.assert_allclose(x.des, y.des, **DR_TOL)
        if kind == "rolled":
            assert _files(final["jax"]) == [f"r{j}.dat" for j in range(5)]
            assert os.path.getsize(os.path.join(final["port"], "r4.dat")) == 2


# ---------------------------------------------------------------------------
# the port's synthetic templates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 5, 7, 11, 1234, 20261017, 20270820,
                                  20271014])
def test_synthetic_mate_codes_equal_jax(seed):
    """The port's make_rolled_template encodes a mate's texture with
    ops.pq.pq_encode: the same codes as the JAX package's generator for
    the seeds the port's tests draw from."""
    out = []
    for mod in (syn, jsyn):
        rng = np.random.default_rng(seed)
        cb = mod.random_codebook(rng)
        lat = mod.make_latent_template(rng, n_minu=30, n_tex=200)
        out.append(mod.make_rolled_template(rng, n_minu=60, n_tex=300,
                                            mated_latent=lat, codebook=cb))
    a, b = (t.texture_template[0] for t in out)
    np.testing.assert_array_equal(a.des, b.des)
    np.testing.assert_array_equal(a.minutiae, b.minutiae)
    np.testing.assert_array_equal(out[0].minu_template[0].des,
                                  out[1].minu_template[0].des)
