"""The port's dense engine (CPU, plain kernel versions) against the JAX
engine, the NumPy executable spec, the JAX gallery layout and the CLI.

Inputs are made with numpy from fixed seeds and handed to both packages.
``row_cap = Rm`` makes the port's minutiae top-K exact, as the JAX CPU
path's ``top_k`` is (cf. test_pallas_kernels.py:179).
"""
import os
import re

import numpy as np
import pytest
import torch

from msu_latentafis_tpu.matcher import reference_impl as spec
from msu_latentafis_tpu.matcher.engine import MatchEngine as JaxEngine
from msu_latentafis_tpu.templates import codec as jcodec
from msu_latentafis_tpu_torch import cli
from msu_latentafis_tpu_torch.matcher.convert import gallery_from_jax
from msu_latentafis_tpu_torch.matcher.engine import (MatchEngine,
                                                     write_score_csv)
from msu_latentafis_tpu_torch.templates import (
    pack_gallery, pack_latent, read_final_template, write_codebook,
    write_final_latent_template, write_final_rolled_pq_template)
from msu_latentafis_tpu_torch.utils.synthetic import (
    make_latent_template, make_rolled_template, random_codebook,
    synthetic_packed_gallery)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch on one intra-op thread: the suite's workers share the host's
    cores, and an intra-op pool in each spins waiting on the others (a
    test ran 7x slower with 8 threads than with 1 beside 8 busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

N_LATENTS = 8
N_GALLERY = 25
CAPS = dict(minu_cap=32, tex_cap=48)


def _to_pixels(t):
    """Writers quantize texture coords (x-24)/16; synthetic templates carry
    quantized coords, so map them to pixel space before writing."""
    for tt in t.texture_template:
        if tt.minutiae is not None and len(tt.minutiae):
            m = np.asarray(tt.minutiae, np.float64)
            m[:, :2] = m[:, :2] * 16.0 + 24.0
            tt.minutiae = m
    return t


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """8 latents x 25 rolled templates written as final .dat files (the
    first 16 rolled entries are mates) and read back by both codecs."""
    rng = np.random.default_rng(20270820)
    cb = random_codebook(rng)
    root = tmp_path_factory.mktemp("torch_sweep")
    lat_files, gal_files, latents = [], [], []
    for i in range(N_LATENTS):
        t = make_latent_template(rng, n_minu=int(rng.integers(8, 33)),
                                 n_tex=int(rng.integers(16, 49)))
        fn = os.path.join(root, f"lat{i}.dat")
        write_final_latent_template(fn, _to_pixels(t))
        lat_files.append(fn)
        latents.append(read_final_template(fn, kind="latent"))
    for j in range(N_GALLERY):
        mate_of = j % N_LATENTS if j < 2 * N_LATENTS else None
        t = make_rolled_template(
            rng, n_minu=int(rng.integers(10, 33)),
            n_tex=int(rng.integers(16, 49)),
            mated_latent=latents[mate_of] if mate_of is not None else None,
            codebook=cb if mate_of is not None else None)
        fn = os.path.join(root, f"rol{j:02d}.dat")
        write_final_rolled_pq_template(fn, _to_pixels(t))
        gal_files.append(fn)
    return cb, lat_files, gal_files, root


def test_codec_bytes_identical(sweep, tmp_path):
    """The port's writers produce the JAX package's bytes, and both readers
    parse them to the same arrays."""
    cb = sweep[0]
    rng = np.random.default_rng(5)
    lat = _to_pixels(make_latent_template(rng, n_minu=12, n_tex=20))
    rol = _to_pixels(make_rolled_template(rng, n_minu=14, n_tex=20))
    for t, kind, writer in [(lat, "latent", "write_final_latent_template"),
                            (rol, "rolled", "write_final_rolled_pq_template")]:
        a, b = tmp_path / f"port_{kind}.dat", tmp_path / f"jax_{kind}.dat"
        {"latent": write_final_latent_template,
         "rolled": write_final_rolled_pq_template}[kind](a, t)
        getattr(jcodec, writer)(b, t)
        assert a.read_bytes() == b.read_bytes()
        mine = read_final_template(a, kind=kind)
        theirs = jcodec.read_final_template(a, kind=kind)
        for m, w in zip(mine.minu_template + mine.texture_template,
                        theirs.minu_template + theirs.texture_template):
            np.testing.assert_array_equal(m.minutiae, w.minutiae)
            np.testing.assert_array_equal(m.des, w.des)
    assert cb.shape == (16, 256, 6)


def test_strict_parity_200_pairs(sweep):
    """Port engine vs the NumPy spec through real .dat files, 200 pairs, at
    the JAX engine's own bar (test_parity_sweep.py: rtol 1e-6, atol 2e-5)."""
    cb, lat_files, gal_files, _ = sweep
    gallery = [read_final_template(f, kind="rolled") for f in gal_files]
    engine = MatchEngine(cb, block_size=8, row_cap=CAPS["minu_cap"],
                         device="cpu")
    dev_gal = engine.load_gallery(pack_gallery(gallery, cb, **CAPS))
    jgal = [jcodec.read_final_template(f, kind="rolled") for f in gal_files]
    n_checked = 0
    for li, fn in enumerate(lat_files):
        lat = read_final_template(fn, kind="latent")
        packed = pack_latent(lat, quantize_tex_xy=False, **CAPS)
        got = engine.one_to_list(packed, dev_gal).scores
        jlat = jcodec.read_final_template(fn, kind="latent")
        want = np.array([
            (lambda s: -1.0 if s is None else s)(
                spec.one2one_fused_score(jlat, rolled, cb))
            for rolled in jgal])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=2e-5,
                                   err_msg=f"latent {li}: port vs spec")
        n_checked += len(gallery)
    assert n_checked == N_LATENTS * N_GALLERY


@pytest.fixture(scope="module")
def packed_pair():
    """A small packed gallery (mates, impostors and one empty entry) and two
    same-shape latents, from one numpy seed."""
    rng = np.random.default_rng(11)
    cb = random_codebook(rng)
    lats = [make_latent_template(rng, n_minu=20, n_tex=40) for _ in range(2)]
    rolled = [make_rolled_template(
        rng, n_minu=24, n_tex=40, mated_latent=lats[i % 2] if i < 2 else None,
        codebook=cb if i < 2 else None) for i in range(6)]
    rolled.append(type(rolled[0])())                     # empty template
    pg = pack_gallery(rolled, cb, minu_cap=24, tex_cap=40)
    pls = [pack_latent(l, minu_cap=24, tex_cap=40, quantize_tex_xy=False)
           for l in lats]
    return cb, pg, pls


def test_engine_matches_jax_engine(packed_pair):
    """Port _match_all vs the JAX engine's CPU _match_all, fused and
    per-component, on the same packed inputs (rtol 1e-5, atol 1e-4)."""
    cb, pg, pls = packed_pair
    je = JaxEngine(cb, block_size=4)
    jgal = je.load_gallery(pg)
    te = MatchEngine(cb, block_size=4, row_cap=24, device="cpu")
    tgal = te.load_gallery(pg)
    want = np.asarray(je.match_scores_batch(pls, jgal))
    got = te.match_scores_batch(pls, tgal).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert got[0, 0] > 10 * max(got[0, 2:].max(), 1.0)
    assert got[0, 6] == -1.0 and got[1, 6] == -1.0       # empty entry
    ws_minu, ws_tex = je._match_fn(je._latent_dict(pls), je._gallery_dict(jgal),
                                   components=True)
    ts_minu, ts_tex = te._match_all(te.latent_batch(pls), tgal,
                                    components=True)
    np.testing.assert_allclose(ts_minu.numpy(), np.asarray(ws_minu),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ts_tex.numpy(), np.asarray(ws_tex),
                               rtol=1e-5, atol=1e-4)


def test_gallery_from_jax_round_trip(packed_pair):
    """The JAX DeviceGallery's arrays, converted, score exactly like the
    port's own load of the same PackedGallery."""
    cb, pg, pls = packed_pair
    je = JaxEngine(cb, block_size=4)
    jgal = je.load_gallery(pg)
    assert jgal.tex_dec is not None
    arrays = {k: np.asarray(v) for k, v in je._gallery_dict(jgal).items()}
    te = MatchEngine(cb, block_size=4, row_cap=24, device="cpu")
    conv = gallery_from_jax(arrays, names=jgal.names, n_real=jgal.n_real,
                            device="cpu")
    own = te.load_gallery(pg)
    for f in ("minu_des", "minu_pack", "tex_dec", "tex_sqnorm", "tex_pack"):
        np.testing.assert_array_equal(getattr(conv, f).numpy(),
                                      getattr(own, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(te.match_scores_batch(pls, conv).numpy(),
                                  te.match_scores_batch(pls, own).numpy())


@pytest.mark.parametrize("mode", [dict(compute_dtype="bf16"),
                                  dict(compute_dtype="bf16", tex_int8=True,
                                       minu_int8=True),
                                  dict(tex_int8=True, minu_int8=True)])
def test_gallery_from_jax_round_trip_modes(packed_pair, mode):
    """A bf16 or int8 JAX gallery (bf16 / int8 minu_des with minu_scale,
    bf16 / int8 tex_dec), carried over, keeps its types and bits and scores
    exactly like the port's own load in the same mode."""
    import jax.numpy as jnp
    cb, pg, pls = packed_pair
    bf16 = mode.get("compute_dtype") == "bf16"
    flags = {k: v for k, v in mode.items() if k != "compute_dtype"}
    je = JaxEngine(cb, block_size=4, compute_dtype=jnp.bfloat16 if bf16
                   else jnp.float32, **flags)
    te = MatchEngine(cb, block_size=4, row_cap=24, device="cpu",
                     compute_dtype=torch.bfloat16 if bf16 else torch.float32,
                     **flags)
    jgal = je.load_gallery(pg)
    arrays = {k: np.asarray(v) for k, v in je._gallery_dict(jgal).items()}
    conv = gallery_from_jax(arrays, names=jgal.names, n_real=jgal.n_real,
                            device="cpu")
    own = te.load_gallery(pg)
    for f in ("minu_des", "tex_dec", "minu_pack", "tex_sqnorm", "tex_pack"):
        a, b = getattr(conv, f), getattr(own, f)
        assert a.dtype == b.dtype, f
        assert torch.equal(a, b), f
    assert (conv.minu_scale is None) == (own.minu_scale is None)
    if own.minu_scale is not None:
        assert torch.equal(conv.minu_scale, own.minu_scale)
    assert torch.equal(te.match_scores_batch(pls, conv),
                       te.match_scores_batch(pls, own))
    bad = dict(arrays, minu_des=arrays["minu_des"].astype(np.float16))
    with pytest.raises(ValueError):
        gallery_from_jax(bad, device="cpu")


def test_cli_match_writes_rank_csv(sweep, tmp_path, capsys):
    """``match`` on a .dat gallery: the latent's mate is rank 1 and the CSV
    has the reference's One2List format."""
    cb, lat_files, gal_files, root = sweep
    gdir = tmp_path / "gallery"
    gdir.mkdir()
    for f in gal_files[:12]:
        os.symlink(f, gdir / os.path.basename(f))
    cbf = tmp_path / "codebook.dat"
    write_codebook(cbf, cb)
    sdir = tmp_path / "scores"
    rc = cli.main(["match", "-l", lat_files[3], "-g", str(gdir), "-c",
                   str(cbf), "-s", str(sdir), "--device", "cpu"])
    assert rc == 0
    lines = (sdir / "lat3.csv").read_text().splitlines()
    assert lines[0] == "filename,score"
    assert len(lines) == 1 + 12
    for r, line in enumerate(lines[1:], start=1):
        assert re.fullmatch(rf"{r}rol\d\d,-?\d+(\.\d+)?(e-?\d+)?", line), line
    assert re.match(r"1rol(03|11),", lines[1])   # lat3's two mates
    out = capsys.readouterr().out
    assert "Rank     Filename      Score" in out


def test_engine_matches_jax_on_jittered_gallery(packed_pair, tmp_path):
    """A vectorized synthetic gallery with per-entry jittered counts (and
    block padding: 10 entries, block 4), then the List2List score CSV."""
    cb, _, pls = packed_pair
    pg = synthetic_packed_gallery(np.random.default_rng(4), cb, 10,
                                  n_minu=24, n_tex=40)
    je = JaxEngine(cb, block_size=4)
    te = MatchEngine(cb, block_size=4, row_cap=24, device="cpu")
    want = np.asarray(je.match_scores_batch(pls, je.load_gallery(pg)))
    tgal = te.load_gallery(pg)
    got = te.match_scores_batch(pls, tgal).numpy()
    assert got.shape == (2, 12)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    res = te.one_to_list(pls[0], tgal)
    assert res.scores.shape == (10,)
    write_score_csv(tmp_path / "s.csv", res)
    lines = (tmp_path / "s.csv").read_text().splitlines()
    assert lines == [f"{n},{s:.3f}" for n, s in zip(pg.names, res.scores)]
