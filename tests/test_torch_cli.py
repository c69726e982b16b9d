"""The rest of the port's ``match`` surface against the JAX package, on the
CPU: ``repad_latent``, ``list_to_list`` (the -ldir batches over shape
buckets), the -ldir score files, the correspondence files of -l,
``one_to_one_all_templates`` and ``AfisConfig.save``.

Inputs are .dat files written from numpy-seeded synthetic templates with
``random_codebook`` (``write_codebook``), read by both packages. The port's
engine runs with ``row_cap`` = the gallery's Rm, which makes its minutiae
top-120 exact as the JAX CPU path's ``top_k`` is (tests/test_torch_engine.py
does the same); the CLI's engine is given that row_cap through a patched
constructor. Bars: scores within rtol 1e-6 / atol 2e-5 of the JAX engine
(the engine's bar against the spec, tests/test_parity_sweep.py:89-90);
score files line for line, each printed score within one unit of its
third decimal (the bar after the writers' 3-decimal rounding); corr files
byte for byte.
"""
import dataclasses
import filecmp
import functools
import json
import os

import numpy as np
import pytest
import torch

from msu_latentafis_tpu import cli as jcli
from msu_latentafis_tpu.config import AfisConfig as JaxConfig
from msu_latentafis_tpu.matcher import reference_impl as jspec
from msu_latentafis_tpu.matcher.engine import MatchEngine as JaxEngine
from msu_latentafis_tpu.matcher.engine import \
    write_corr_files as jax_write_corr_files
from msu_latentafis_tpu.templates import codec as jcodec
from msu_latentafis_tpu.templates import packing as jpacking
from msu_latentafis_tpu.utils import logging as jlogging
from msu_latentafis_tpu.utils import timing as jtiming
from msu_latentafis_tpu_torch import cli
from msu_latentafis_tpu_torch.config import AfisConfig
from msu_latentafis_tpu_torch.matcher import engine as engine_mod
from msu_latentafis_tpu_torch.matcher import reference_impl as spec
from msu_latentafis_tpu_torch.matcher.engine import (MatchEngine,
                                                     write_corr_files)
from msu_latentafis_tpu_torch.templates import (
    pack_gallery, pack_latent, read_final_template, repad_latent,
    write_codebook, write_final_latent_template,
    write_final_rolled_pq_template)
from msu_latentafis_tpu_torch.utils import logging as plogging
from msu_latentafis_tpu_torch.utils import timing as ptiming
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

RTOL, ATOL = 1e-6, 2e-5
GALLERY = 12
# (minutiae, texture minutiae) of the latents: three (Lm, Lt) buckets
LATENTS = [(12, 40), (40, 150), (20, 100), (36, 60), (8, 200), (28, 130)]
RM = 48


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
def files(tmp_path_factory):
    """A gallery of 12 rolled .dat files (entry j mates latent j for j < 6),
    a latent directory of 6 latents and one empty latent file."""
    rng = np.random.default_rng(20271014)
    cb = random_codebook(rng)
    root = tmp_path_factory.mktemp("torch_cli")
    gdir, ldir = root / "gallery", root / "latents"
    gdir.mkdir()
    ldir.mkdir()
    cbf = root / "codebook.dat"
    write_codebook(str(cbf), cb)
    lats = []
    for i, (nm, nt) in enumerate(LATENTS):
        t = make_latent_template(rng, n_minu=nm, n_tex=nt)
        write_final_latent_template(str(ldir / f"lat{i}.dat"), _to_pixels(t))
        lats.append(read_final_template(str(ldir / f"lat{i}.dat"),
                                        kind="latent"))
    (ldir / "lat9_empty.dat").write_bytes(b"")
    for j in range(GALLERY):
        mate = lats[j] if j < len(lats) else None
        t = make_rolled_template(rng, n_minu=int(rng.integers(20, RM + 1)),
                                 n_tex=int(rng.integers(40, 120)),
                                 mated_latent=mate,
                                 codebook=cb if mate is not None else None)
        write_final_rolled_pq_template(str(gdir / f"r{j:02d}.dat"),
                                       _to_pixels(t))
    return cb, cbf, gdir, ldir


def _latents(ldir):
    out = []
    for i in range(len(LATENTS)):
        t = read_final_template(str(ldir / f"lat{i}.dat"), kind="latent")
        out.append(pack_latent(t, quantize_tex_xy=False))
    return out


def _gallery(gdir, cb):
    files = sorted(gdir.glob("*.dat"))
    return pack_gallery([read_final_template(str(f), kind="rolled")
                         for f in files], cb, names=[f.stem for f in files])


def test_repad_latent_matches_jax(files):
    """Growing and shrinking the padding: the port's arrays equal the JAX
    package's bit for bit, valid counts kept."""
    cb, _, _, ldir = files
    for i in range(len(LATENTS)):
        fn = str(ldir / f"lat{i}.dat")
        p = pack_latent(read_final_template(fn, kind="latent"),
                        quantize_tex_xy=False)
        j = jpacking.pack_latent(jcodec.read_final_template(fn, kind="latent"),
                                 quantize_tex_xy=False)
        lm0, lt0 = int(p.minu_n.max()), int(p.tex_n)
        for lm, lt in ((lm0, lt0), (64, 256), (p.minu_des.shape[1] + 8,
                                               p.tex_des.shape[0])):
            got, want = repad_latent(p, lm, lt), jpacking.repad_latent(j, lm,
                                                                       lt)
            for f in dataclasses.fields(got):
                a, b = getattr(got, f.name), getattr(want, f.name)
                if isinstance(a, np.ndarray):
                    assert a.dtype == b.dtype and a.shape == b.shape, f.name
                    np.testing.assert_array_equal(a, b, err_msg=f.name)
            assert got.minu_des.shape[1] == lm and got.tex_des.shape[0] == lt
    with pytest.raises(AssertionError):
        repad_latent(p, lm0 - 1, lt0)


def test_list_to_list_matches_jax_and_one_to_list(files, monkeypatch):
    """Buckets of (T, Lm, Lt, D) in batches (of 2 here, so that a bucket
    takes several): input order kept, rows equal to the JAX engine's
    list_to_list within the engine's bar and to the port's own one_to_list
    bit for bit (padding adds nothing to a sum)."""
    cb, _, gdir, ldir = files
    pg = _gallery(gdir, cb)
    lats = _latents(ldir)
    keys = {(-(-int(l.minu_n.max()) // engine_mod.LM_BUCKET),
             -(-int(l.tex_n) // engine_mod.LT_BUCKET)) for l in lats}
    assert len(keys) >= 2
    engine = MatchEngine(cb, block_size=8, row_cap=RM, device="cpu")
    gal = engine.load_gallery(pg)
    monkeypatch.setattr(engine_mod, "MAX_BATCH", 2)
    got = engine.list_to_list(lats, gal)
    je = JaxEngine(cb, block_size=8)
    want = je.list_to_list(lats, je.load_gallery(pg), max_batch=2)
    assert len(got) == len(lats)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.names == w.names == pg.names
        np.testing.assert_allclose(g.scores, w.scores, rtol=RTOL, atol=ATOL,
                                   err_msg=f"latent {i}")
        solo = engine.one_to_list(lats[i], gal).scores
        np.testing.assert_array_equal(g.scores, solo, err_msg=f"latent {i}")
        assert int(np.argmax(g.scores)) == i              # the mate


def _port_cli(monkeypatch):
    monkeypatch.setattr(cli, "MatchEngine",
                        functools.partial(MatchEngine, row_cap=RM))


def _csv(path):
    return [l.split(",") for l in path.read_text().splitlines()]


def test_ldir_score_files_match_jax_cli(files, tmp_path, monkeypatch,
                                        capsys, caplog):
    """-ldir: one score file per latent, every entry's score, as the JAX
    CLI writes it; the empty latent's file holds 0; the mates lead. The
    CLI prints its phases, logs each latent's score statistics and the
    run's phases as JSON events, and --trace writes a trace with the
    engine's spans."""
    cb, cbf, gdir, ldir = files
    _port_cli(monkeypatch)
    monkeypatch.setenv("AFIS_COMPILE_CACHE", str(tmp_path / "jax_cache"))
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    args = ["match", "-ldir", str(ldir), "-g", str(gdir), "-c", str(cbf)]
    with caplog.at_level("INFO", logger="msu_latentafis_tpu_torch"):
        assert cli.main(args + ["-s", str(ours), "--device", "cpu",
                                "--trace", str(tmp_path / "trace")]) == 0
    out = capsys.readouterr().out
    assert "native loader" in out and f"Matched {len(LATENTS)} latents" in out
    for phase in ("load gallery", "read latents", "match"):
        assert phase in out
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    spans = [e["name"] for e in trace["traceEvents"] if e.get("cat") == "span"]
    assert spans.count("search") == 1 and "exact" in spans
    events = [json.loads(r.getMessage()) for r in caplog.records]
    stats = {e["latent"]: e for e in events if e["event"] == "scores"}
    assert sorted(stats) == [f"lat{i}" for i in range(len(LATENTS))]
    assert all(e["n"] == GALLERY for e in stats.values())
    run = [e for e in events if e["event"] == "match"][-1]
    assert run["loader"] == "native" and run["gallery"] == GALLERY
    assert set(run["phases"]) == {"load gallery", "read latents", "match"}
    assert run["counters"]["latents"] >= len(LATENTS)
    assert run["counters"]["empty latents"] >= 1
    assert jcli.main(args + ["-s", str(theirs)]) == 0
    names = sorted(os.listdir(theirs))
    assert sorted(os.listdir(ours)) == names
    assert len(names) == len(LATENTS) + 1
    assert (ours / "lat9_empty.csv").read_text() == "0\n"
    for name in names:
        a, b = _csv(ours / name), _csv(theirs / name)
        assert len(a) == len(b) and [r[0] for r in a] == [r[0] for r in b]
        if name == "lat9_empty.csv":
            assert a == b
            continue
        assert len(a) == GALLERY
        sa = np.array([float(r[1]) for r in a])
        sb = np.array([float(r[1]) for r in b])
        assert np.abs(sa - sb).max() <= 1e-3 + 1e-9, name
        i = int(name[3])
        assert a[int(np.argmax(sa))][0] == f"r{i:02d}", name


def test_l_writes_corr_files_like_jax(files, tmp_path, monkeypatch):
    """-l: the ranked file and, for each of the top-24 candidates (here the
    whole gallery) and each selected latent minutiae template, a
    corr<latent>_<name>_<i>.csv byte-identical to the JAX CLI's."""
    cb, cbf, gdir, ldir = files
    _port_cli(monkeypatch)
    monkeypatch.setenv("AFIS_COMPILE_CACHE", str(tmp_path / "jax_cache"))
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    args = ["match", "-l", str(ldir / "lat1.dat"), "-g", str(gdir), "-c",
            str(cbf)]
    assert cli.main(args + ["-s", str(ours), "--device", "cpu"]) == 0
    assert jcli.main(args + ["-s", str(theirs)]) == 0
    corr = sorted(f for f in os.listdir(theirs) if f.startswith("corr"))
    assert len(corr) == GALLERY * 3
    assert sorted(f for f in os.listdir(ours) if f.startswith("corr")) == corr
    match, mismatch, errors = filecmp.cmpfiles(ours, theirs, corr,
                                               shallow=False)
    assert not mismatch and not errors and len(match) == len(corr)
    assert (ours / "corrlat1_r01_0.csv").stat().st_size > 0   # the mate
    ranked = (ours / "lat1.csv").read_text().splitlines()
    assert ranked[0] == "filename,score" and ranked[1].startswith("1r01,")


def test_write_corr_files_bytes_equal_jax(files, tmp_path):
    """write_corr_files for each latent with its mate, another latent's
    mate and an impostor: the same files, byte for byte, as the JAX
    package's."""
    cb, _, gdir, ldir = files
    gal = sorted(gdir.glob("*.dat"))
    n = 0
    for i in range(len(LATENTS)):
        fn = str(ldir / f"lat{i}.dat")
        lt = read_final_template(fn, kind="latent")
        jlt = jcodec.read_final_template(fn, kind="latent")
        for rf in (gal[i], gal[(i + 1) % len(LATENTS)], gal[-1 - i % 3]):
            rt = read_final_template(str(rf), kind="rolled")
            jrt = jcodec.read_final_template(str(rf), kind="rolled")
            a = write_corr_files(lt, rt, cb, str(tmp_path / f"p{i}_{rf.stem}"))
            b = jax_write_corr_files(jlt, jrt, cb,
                                     str(tmp_path / f"j{i}_{rf.stem}"))
            assert len(a) == len(b) == 3
            for x, y in zip(a, b):
                assert open(x, "rb").read() == open(y, "rb").read()
                n += os.path.getsize(x) > 0
    assert n >= len(LATENTS)                    # the mates' files hold rows


def test_one_to_one_all_templates_matches_jax_and_spec(files):
    """Every latent minutiae template against rolled template 0, then the
    texture template: the port's engine against the JAX engine and the
    port's own NumPy spec (tests/test_matcher_parity.py:180-200), and the
    port's spec against the JAX package's."""
    cb, _, gdir, ldir = files
    rng = np.random.default_rng(7)
    latent = make_latent_template(rng, n_minu=14, n_tex=36,
                                  n_minu_templates=28)
    mate = make_rolled_template(rng, n_minu=24, n_tex=60,
                                mated_latent=latent, codebook=cb)
    imp = make_rolled_template(rng, n_minu=24, n_tex=60)
    engine = MatchEngine(cb, block_size=4, row_cap=24, device="cpu")
    je = JaxEngine(cb, block_size=4)
    for rolled in (mate, imp):
        want_spec = np.asarray(spec.one2one_all_templates_scores(
            latent, rolled, cb), np.float32)
        np.testing.assert_array_equal(want_spec, np.asarray(
            jspec.one2one_all_templates_scores(latent, rolled, cb),
            np.float32))
        got = engine.one_to_one_all_templates(latent, rolled)
        assert got.shape == want_spec.shape == (29,)
        np.testing.assert_allclose(got, want_spec, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(
            got, je.one_to_one_all_templates(latent, rolled), rtol=RTOL,
            atol=ATOL)
    empty = type(latent)()
    assert not engine.one_to_one_all_templates(empty, mate).any()


def test_config_save_writes_jax_bytes(tmp_path):
    """AfisConfig.save writes the JAX package's bytes for the same fields,
    and load reads them back."""
    fields = dict(CodebookPath="cb.dat", ScorePath="scores",
                  MatchBlockSize=128, ComputeDtype="bfloat16",
                  MinuPath="minu", GalleryShards=4)
    AfisConfig(**fields).save(str(tmp_path / "port.config"))
    JaxConfig(**fields).save(str(tmp_path / "jax.config"))
    assert (tmp_path / "port.config").read_bytes() == \
        (tmp_path / "jax.config").read_bytes()
    AfisConfig().save(str(tmp_path / "p0"))
    JaxConfig().save(str(tmp_path / "j0"))
    assert (tmp_path / "p0").read_bytes() == (tmp_path / "j0").read_bytes()
    assert AfisConfig.load(str(tmp_path / "port.config")) == \
        AfisConfig(**fields)


def test_timing_and_logging_match_jax(tmp_path, caplog):
    """PhaseTimer's buckets and table, score_stats and the JSON event lines
    as the JAX package's; device_trace writes a Chrome trace (CPU here)."""
    timers = (ptiming.PhaseTimer(), jtiming.PhaseTimer())
    for t in timers:
        for name in ("load", "match", "load"):
            with t.phase(name):
                pass
    assert [t.counts for t in timers][0] == timers[1].counts == \
        {"load": 2, "match": 1}
    assert list(timers[0].report()) == list(timers[1].report())
    assert timers[0].pretty().splitlines()[0] == \
        timers[1].pretty().splitlines()[0]
    scores = np.random.default_rng(3).normal(10, 5, 200).astype(np.float32)
    scores[:7] = -1.0
    assert plogging.score_stats(scores) == jlogging.score_stats(scores)
    assert plogging.score_stats(-np.ones(3)) == {"n": 0}
    plogging.count("latents", 3)
    assert plogging.counters["latents"] >= 3
    with caplog.at_level("INFO", logger="msu_latentafis_tpu_torch"):
        plogging.event("match", latent="lat0", n=12)
    rec = json.loads(caplog.records[-1].getMessage())
    assert rec["event"] == "match" and rec["latent"] == "lat0" and \
        rec["n"] == 12
    with ptiming.device_trace(None):
        pass
    with ptiming.device_trace(str(tmp_path / "trace")):
        np.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
