"""Latents at their own sizes, on the CPU: the configuration's law of
latent sizes (``gen.count_law``), the latents handed to the program as its
packer sizes them (``harness.Program``), the work counted from each
batch's latents (``work.window_least_s``), and the check judging such
latents; and, for every configuration without a law, the draws and the
program's latent arrays as they were before the law existed.

    python -m pytest afis_bench/tests -q

The program's gap, for the configuration that will state a law: its
serving path (``MatchEngine.match_scores_batch_reranked``) stacks a batch
with ``latent_batch``'s ``np.stack``, which takes only latents of one
shape, so a serving batch of 8 latents of unequal sizes fails there (a
ValueError from NumPy). The serving tests below run at batch 1; the dense
path (``list_to_list``) buckets latents by size and takes any batch. A
serving cell of such latents waits for the program to batch them.
"""
import hashlib
import json

import numpy as np
import pytest
import torch

from afis_bench import check as C
from afis_bench import harness as H
from afis_bench import reference as R
from afis_bench.gen import Draws, count_law, latent_counts
from afis_bench.window import ClosedLoop
from afis_bench.work import Shapes, bound_s, latent_sizes, window_least_s

from test_afis_bench_control import Stale, limits_of
from test_afis_bench_harness import BENCH, toy_bench

LAW = {"law": "loguniform", "minu": [3, 16], "tex": [5, 40]}
KEYS = ("minu_des", "minu_xy", "minu_ori", "minu_n", "tex_des", "tex_xy",
        "tex_ori", "tex_n")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def law_bench(tmp_path, mixes=("serve",), law=LAW, batch=None):
    """``toy_bench`` with the toy configuration's latents sized by
    ``law`` (Lm 16, Lt 40) and, where given, the mixes' batch."""
    bench, cells = toy_bench(tmp_path, mixes=mixes)
    p = bench.base / "configs" / "toy.json"
    cfg = json.loads(p.read_text())
    cfg["latent"]["counts"] = law
    p.write_text(json.dumps(cfg))
    if batch is not None:
        for name in mixes:
            q = bench.base / "mixes" / f"toy{name}.json"
            q.write_text(json.dumps({**json.loads(q.read_text()),
                                     "batch": batch}))
    return bench, cells


def toy_config(tmp_path, law=LAW) -> dict:
    bench, _ = law_bench(tmp_path, law=law)
    return bench.config("toy")


# ---------------------------------------------------------------------------
# (a) no law: the draws and the latent arrays as before the law existed
# ---------------------------------------------------------------------------

# sha256 (first 16 hex digits) of each group of tensors, in the order
# below, each tensor's dtype and shape hashed before its bytes: computed
# with the gen.py and harness.py of the commit before the law of latent
# sizes was added, on this CPU build of torch, one thread, gallery 4,096,
# pool 16.
PARENT_SUMS = {
    ("g100k_448", 3): {
        "codebook+mate_pos": "3eecd8a3b213e51c",
        "latents": "e9da1e689201cf72", "mates": "1cd631250c638c44",
        "chunks": "717e6159908a03f2", "program": "99e183149f4dfee9"},
    ("g100k_448", 2 ** 31 + 11): {
        "codebook+mate_pos": "718f12d83b41c938",
        "latents": "2182207f04baef3b", "mates": "0e90611752c27528",
        "chunks": "f3843a0c8a838693", "program": "5d1853d16f90e52a"},
    ("g100k_cap", 3): {
        "codebook+mate_pos": "3eecd8a3b213e51c",
        "latents": "aa8e80414ae69737", "mates": "d3292d864bc8de1a",
        "chunks": "c351eb0bbb7ca8fd", "program": "d1ffd682fb2af429"},
    ("g100k_cap", 2 ** 31 + 11): {
        "codebook+mate_pos": "718f12d83b41c938",
        "latents": "2ba7b26dbc110ce7", "mates": "d8e3be3ffede5ec7",
        "chunks": "25b2793f8e202be7", "program": "25be4d775ac0e93e"},
}


def group_sums(d: Draws, prog) -> dict:
    def digest(arrays):
        h = hashlib.sha256()
        for a in arrays:
            a = a.cpu().numpy() if isinstance(a, torch.Tensor) \
                else np.asarray(a)
            a = np.ascontiguousarray(a)
            h.update(str((a.dtype.str, a.shape)).encode() + a.tobytes())
        return h.hexdigest()[:16]
    return {
        "codebook+mate_pos": digest([d.codebook, d.mate_pos]),
        "latents": digest(d.latents[k] for k in KEYS),
        "mates": digest(d.mates[k] for k in d.mates),
        "chunks": digest(v for c in range(d.n_chunks)
                         for v in d.chunk(c).values()),
        "program": digest(getattr(l, k) for k in KEYS
                          for l in prog.latents)}


@pytest.mark.parametrize("config,seed", sorted(PARENT_SUMS))
def test_no_law_draws_and_arrays_are_the_parents(config, seed):
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    assert count_law(cfg["latent"]) is None
    cfg["gallery"] = 4096
    d = Draws(cfg, 16, seed, "cpu")
    prog = H.Program(cfg, {}, d, "cpu")
    assert group_sums(d, prog) == PARENT_SUMS[(config, seed)]


# ---------------------------------------------------------------------------
# (b) a law: its counts, its zeros, the packer's sizes, the mates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("law,match", [
    ({"law": "uniform", "minu": [3, 16], "tex": [5, 40]}, "law"),
    ({"law": "loguniform", "minu": [0, 16], "tex": [5, 40]}, "minu"),
    ({"law": "loguniform", "minu": [3, 17], "tex": [5, 40]}, "minu"),
    ({"law": "loguniform", "minu": [3, 16], "tex": [41, 40]}, "tex"),
])
def test_a_law_outside_its_limits_is_refused(tmp_path, law, match):
    cfg = toy_config(tmp_path, law)
    with pytest.raises(ValueError, match=match):
        Draws(cfg, 8, 1, "cpu")


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 3, 987654321987])
def test_law_counts_stay_in_bounds_and_zero_the_rest(tmp_path, seed):
    cfg = toy_config(tmp_path)
    d = Draws(cfg, 48, seed, "cpu")
    lat = d.latents
    mn, tn = lat["minu_n"], lat["tex_n"]
    assert mn.dtype == tn.dtype == torch.int32
    assert int(mn.min()) >= 3 and int(mn.max()) <= 16
    assert int(tn.min()) >= 5 and int(tn.max()) <= 40
    # the draws spread over the range, templates independently
    assert len(torch.unique(mn)) > 6 and len(torch.unique(tn)) > 10
    assert bool((mn[:, 0] != mn[:, 1]).any())
    m_out = torch.arange(16)[None, None] >= mn[..., None]
    t_out = torch.arange(40)[None] >= tn[:, None]
    assert bool((lat["minu_des"][m_out] == 0).all())
    assert bool((lat["minu_xy"][m_out] == 0).all())
    assert bool((lat["minu_ori"][m_out] == 0).all())
    assert bool((lat["tex_des"][t_out] == 0).all())
    assert bool((lat["tex_xy"][t_out] == 0).all())
    assert bool((lat["tex_ori"][t_out] == 0).all())
    assert bool((lat["minu_des"][~m_out].norm(dim=-1) > 1).all())
    # the counts are the law's stream alone, the same on any device
    want = latent_counts(cfg["latent"], 48, seed)
    assert np.array_equal(mn.numpy(), want[0])
    assert np.array_equal(tn.numpy(), want[1])


def test_a_law_changes_no_other_stream(tmp_path):
    """The valid slots, the mates outside their planted slots and the
    gallery are those of the same configuration without the law."""
    cfg = toy_config(tmp_path)
    full = json.loads(json.dumps(cfg))
    del full["latent"]["counts"]
    a, b = Draws(cfg, 8, 77, "cpu"), Draws(full, 8, 77, "cpu")
    m_in = torch.arange(16)[None, None] < a.latents["minu_n"][..., None]
    t_in = torch.arange(40)[None] < a.latents["tex_n"][:, None]
    for k, m in (("minu_des", m_in), ("minu_xy", m_in), ("minu_ori", m_in),
                 ("tex_des", t_in), ("tex_xy", t_in), ("tex_ori", t_in)):
        assert torch.equal(a.latents[k][m], b.latents[k][m]), k
    assert np.array_equal(a.codebook, b.codebook)
    assert torch.equal(a.mate_pos, b.mate_pos)
    for c in range(a.n_chunks):
        ra, rb = a.chunk(c), b.chunk(c)
        keep = torch.ones(ra["minu_n"].shape[0], dtype=torch.bool)
        here = (a.mate_pos >= c * 2048) & (a.mate_pos < (c + 1) * 2048)
        keep[(a.mate_pos[here] - c * 2048).long()] = False
        for k in ra:
            assert torch.equal(ra[k][keep], rb[k][keep]), k
    # a mate: template 0's first n_0 minutiae and the first tex_n virtual
    # minutiae planted; the slots after them keep the entry's own draws
    for i in range(8):
        n0, tn = int(a.latents["minu_n"][i, 0]), int(a.latents["tex_n"][i])
        assert torch.equal(a.mates["minu_ori"][i, :n0],
                           a.latents["minu_ori"][i, 0, :n0])
        assert torch.equal(a.mates["minu_ori"][i, :n0],
                           b.mates["minu_ori"][i, :n0])
        assert torch.equal(a.mates["minu_des"][i, :n0],
                           b.mates["minu_des"][i, :n0])
        assert torch.equal(a.mates["tex_xy"][i, :tn],
                           a.latents["tex_xy"][i, :tn])
        assert torch.equal(a.mates["tex_codes"][i, :tn],
                           b.mates["tex_codes"][i, :tn])
        assert not torch.equal(a.mates["minu_ori"][i, n0:16],
                               b.mates["minu_ori"][i, n0:16]) or n0 == 16
        if tn < 40:
            assert not torch.equal(a.mates["tex_ori"][i, tn:40],
                                   a.latents["tex_ori"][i, tn:40])


def packer_latent(d: Draws, i: int):
    """Latent ``i`` of the draws through the program's own packer."""
    from msu_latentafis_tpu_torch.templates.data_model import (
        MinuTemplate, Template, TextureTemplate)
    from msu_latentafis_tpu_torch.templates.packing import pack_latent
    lat = {k: v.numpy() for k, v in d.latents.items()}
    t = Template()
    for j in range(d.T):
        n = int(lat["minu_n"][i, j])
        m = np.concatenate([lat["minu_xy"][i, j, :n],
                            lat["minu_ori"][i, j, :n, None],
                            np.zeros((n, 1), np.float32)], axis=1)
        t.add_minu_template(MinuTemplate(minutiae=m,
                                         des=lat["minu_des"][i, j, :n]))
    n = int(lat["tex_n"][i])
    m = np.concatenate([lat["tex_xy"][i, :n], lat["tex_ori"][i, :n, None],
                        np.zeros((n, 1), np.float32)], axis=1)
    t.add_texture_template(TextureTemplate(minutiae=m,
                                           des=lat["tex_des"][i, :n]))
    return pack_latent(t, selected=tuple(range(d.T)), quantize_tex_xy=False)


def test_program_latents_are_the_packers(tmp_path):
    """Each latent reaches the program as its packer packs it, at the
    packer's sizes; a batch holds latents of unequal shapes, handed over
    as they come."""
    bench, (cell,) = law_bench(tmp_path)
    cfg, mix = bench.config("toy"), bench.mix("toyserve")
    d = Draws(cfg, 8, 2 ** 31 + 9, "cpu")
    prog = H.Program(cfg, mix, d, "cpu")
    for i, got in enumerate(prog.latents):
        want = packer_latent(d, i)
        lm, lt = H.packed_sizes(d.latents["minu_n"][i], d.latents["tex_n"][i])
        assert got.minu_des.shape == (3, lm, 96)
        assert got.tex_des.shape == (lt, 96)
        assert lm == -(-int(d.latents["minu_n"][i].max()) // 8) * 8
        for k in KEYS:
            a, b = getattr(got, k), getattr(want, k)
            assert a.shape == b.shape and np.array_equal(a, b), (i, k)
    batch_of = H.batches(8, int(mix["batch"]), 2 ** 31 + 9)
    shapes = {(prog.latents[i].minu_des.shape, prog.latents[i].tex_des.shape)
              for i in batch_of(0)}
    assert len(shapes) > 1
    assert H.packed_sizes([3, 9, 1], 33) == (16, 40)
    assert H.packed_sizes([8, 8, 8], 40) == (8, 40)


@pytest.mark.parametrize("seed", [4, 2 ** 31 + 21])
def test_each_planted_mate_ranks_first_by_the_reference(tmp_path, seed):
    cfg = toy_config(tmp_path)
    d = Draws(cfg, 8, seed, "cpu")
    prec = R.Precision(cfg["modes"])
    cb = R.Codebook(d.codebook, prec, "cpu")
    every = torch.arange(d.G)[None].expand(d.pool, d.G)
    s = R.exact_for(d, list(range(d.pool)), every, prec, cb)
    assert torch.equal(s.argmax(dim=1), d.mate_pos.long()), s


# ---------------------------------------------------------------------------
# (c) the work counted from each batch's latents
# ---------------------------------------------------------------------------

# the commit before the law: Shapes(config, mix).screen_batch() (both
# launches), exact_batch()'s first three launches and its length, for a
# batch of full latents
PARENT_WORK = {
    "g100k_448.serve": ([(943718400000.0, 1884900352, 989e12),
                         (4404019200000.0, 4662502400, 989e12)],
                        [(2030567424.0, 10467072, 989e12),
                         (19730006016.0, 25777920, 989e12),
                         (6881280.0, 5516032, 67e12)], 24),
    "g100k_448.dense": ([], [(16244539392.0, 10795008, 989e12),
                             (157840048128.0, 39237632, 989e12),
                             (55050240.0, 18438144, 67e12)], 588),
    "g100k_448.certified": ([(2831155200000.0, 1891501056, 989e12),
                             (30828134400000.0, 4663116800, 989e12)],
                            [(2030567424.0, 10467072, 989e12),
                             (19730006016.0, 25777920, 989e12),
                             (6881280.0, 5516032, 67e12)], 24),
    "g100k_cap.serve": ([(2516582400000.0, 1283400704, 989e12),
                         (9830400000000.0, 2403351552, 989e12)],
                        [(5401214976.0, 7689728, 989e12),
                         (98304000000.0, 16629152, 989e12),
                         (15360000.0, 12310048, 67e12)], 24),
    "g100k_cap.dense": ([], [(43209719808.0, 8302592, 989e12),
                             (786432000000.0, 46673152, 989e12),
                             (122880000.0, 41136384, 67e12)], 588),
    "g100k_cap.certified": ([(7549747200000.0, 1290202112, 989e12),
                             (153600000000000.0, 2404849152, 989e12)],
                            [(5401214976.0, 7689728, 989e12),
                             (98304000000.0, 16629152, 989e12),
                             (15360000.0, 12310048, 67e12)], 24),
}


def shapes_of(cell: str) -> Shapes:
    config, mix = cell.split(".")
    return Shapes(json.loads((BENCH / "configs" / f"{config}.json")
                             .read_text()),
                  json.loads((BENCH / "mixes" / f"{mix}.json").read_text()))


def close(a, b) -> bool:
    return all(x == pytest.approx(y, rel=1e-12, abs=0)
               for x, y in zip(a, b)) and len(a) == len(b)


@pytest.mark.parametrize("cell", sorted(PARENT_WORK))
def test_full_latents_count_the_parents_work(cell):
    sh = shapes_of(cell)
    screen, exact3, n_exact = PARENT_WORK[cell]
    full = [sh.full] * sh.batch
    for lats in (None, full):
        s, e = sh.screen_batch(lats), sh.exact_batch(lats)
        assert len(s) == len(screen) and all(map(close, s, screen))
        assert len(e) == n_exact
        assert all(close(w, exact3[k % 3]) for k, w in enumerate(e))
    # a window of 37 full batches: 37 times one batch's least time, also
    # where a view gives no latents (full ones for each window batch)
    bare = H.RunView(window=ClosedLoop(1.0))
    bare.window.batches = [(0.0, 1.0, sh.batch)] * 37
    for layer, work in (("screen", screen), ("exact", exact3)):
        one = bound_s(work) * (n_exact // 3 if layer == "exact" else 1)
        for lats in ([full] * 37, bare.window_latents()):
            got = window_least_s(sh, lats, layer)
            assert got == pytest.approx(one * 37, rel=1e-12, abs=0)


def test_a_batch_with_a_law_counts_its_valid_work_by_hand():
    sh = shapes_of("g100k_448.serve")        # prescreen t 1, lt 64
    G, Rm, Rt, D, B, cap = 100000, 96, 448, 96, 512, 8
    a, b = ((10, 20, 30), 100), ((64, 5, 7), 30)
    minu, adc = sh.screen_batch([a, b])
    assert minu[0] == 2.0 * G * (10 + 64) * Rm * D
    assert minu[1] == G * Rm * (D * 2 + 4) + (10 + 64) * (D * 2 + 4) \
        + 2 * G * 4
    assert adc[0] == 2.0 * G * (64 + 30) * Rt * D
    assert adc[1] == G * Rt * D * 1 + G * Rt * 8 + (64 + 30) * (D * 2 + 8) \
        + 2 * G * 4
    e = sh.exact_batch([a, b])
    assert len(e) == 6                       # m_pad 512: a block a latent
    for (m, t), (mm, rm, tm) in zip((a, b), (e[:3], e[3:])):
        P = sum(m)
        assert mm[0] == pytest.approx(sum(
            B * p * (2.0 * Rm * D + 5.0 * Rm + 2.0 * cap * Rm + 26.0 * cap)
            for p in m), rel=1e-15)
        assert mm[1] == P * (D * 2 + 20) + B * Rm * (D * 2 + 20) + 3 * B * 4
        assert rm[0] == 2.0 * B * t * Rt * D
        assert rm[1] == t * (D * 2 + 4) + B * Rt * D + B * Rt * 8 + B * t * 8
        assert tm[0] == 30.0 * B * t
        assert tm[1] == B * t * 8 + t * 20 + B * Rt * 16 + B * 4
    # dense: the whole batch a block, 196 blocks
    dn = shapes_of("g100k_448.dense")
    e = dn.exact_batch([a, b])
    assert len(e) == 3 * 196
    assert e[1][0] == 2.0 * B * 130 * Rt * D
    # a window sums its batches, each from its own latents
    want = bound_s(sh.screen_batch([a, b])) * 2 + bound_s(
        sh.screen_batch([b, b]))
    got = window_least_s(sh, [[a, b], [b, b], [a, b]], "screen")
    assert got == pytest.approx(want, rel=1e-15)
    assert window_least_s(sh, [[a, b]], "screen") \
        < window_least_s(sh, [[sh.full, sh.full]], "screen")


def test_padded_or_trimmed_latents_count_the_same_work(tmp_path):
    """The count depends on the draws alone: the same latents, trimmed
    to the packer's sizes, at full width, or repadded to the program's
    dense buckets, give the same sizes and the same work."""
    from msu_latentafis_tpu_torch.templates.packing import repad_latent
    bench, _ = law_bench(tmp_path, mixes=("serve", "dense"))
    cfg = bench.config("toy")
    d = Draws(cfg, 8, 123, "cpu")
    prog = H.Program(cfg, bench.mix("toyserve"), d, "cpu")
    drawn = latent_sizes(d.latents["minu_n"].numpy(),
                         d.latents["tex_n"].numpy())
    trimmed = [l for l in prog.latents]
    padded = [repad_latent(l, 32, 128) for l in prog.latents]
    for lats in (trimmed, padded):
        sizes = latent_sizes([l.minu_n for l in lats],
                             [l.tex_n for l in lats])
        assert sizes == drawn
    assert {l.minu_des.shape[1] for l in padded} == {32}
    for mix in ("toyserve", "toydense"):
        sh = Shapes(cfg, bench.mix(mix))
        batches = [drawn[:4], drawn[4:]]
        got = window_least_s(sh, batches, "exact")
        assert got == pytest.approx(sum(bound_s(sh.exact_batch(b))
                                        for b in batches), rel=1e-15)
        assert got < window_least_s(sh, [[sh.full] * 4] * 2, "exact")


# ---------------------------------------------------------------------------
# (d) the check judges latents at their own sizes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mix,batch", [("dense", None), ("dense", 1),
                                       ("serve", 1), ("certified", 1)])
def test_a_law_is_correct_through_the_program(tmp_path, mix, batch):
    bench, (cell,) = law_bench(tmp_path, mixes=(mix,), batch=batch)
    out = H.run_cell(bench, cell, 2 ** 31 + 41, 0.5, False, "cpu")
    assert out["correct"] is True, out["check"]
    assert out["failed"] == 0 and out["attempted"] > 0


def test_a_traced_law_run_counts_the_batches_it_ran(tmp_path):
    """The run hands the readers the sizes of every window batch's
    latents, one list a batch."""
    bench, (cell,) = law_bench(tmp_path, batch=1)
    (bench.base / "metrics" / "toy_sizes.py").write_text(
        "def read(run):\n"
        "    assert len(run.batch_latents) == len(run.window.batches)\n"
        "    assert all(len(b) == 1 for b in run.batch_latents)\n"
        "    return float(len({b[0] for b in run.batch_latents}))\n")
    bench.spec["per_layer"].append({
        "name": "toy_sizes", "unit": "sizes", "better": "higher",
        "source": "program_counter", "layer": "toy", "moves": "search_rate"})
    out = H.run_cell(bench, cell, 2 ** 31 + 43, 0.5, True, "cpu")
    assert out["correct"] is True, out["check"]
    assert out["metrics"]["toy_sizes"]["value"] > 1


@pytest.mark.parametrize("mix", ["serve", "dense"])
@pytest.mark.parametrize("seed", [13, 2 ** 31 + 7, 987654321989])
def test_the_control_of_a_law_is_not_correct(tmp_path, mix, seed):
    bench, (cell,) = law_bench(tmp_path, mixes=(mix,), batch=1)
    w = bench.cell(cell)
    config, mx = bench.config(w["config"]), bench.mix(w["traffic"])
    d = Draws(config, int(mx["pool"]), seed, "cpu")
    lats = C.sample_latents(list(range(d.pool)), int(mx["check_latents"]),
                            seed, d.pool, int(mx["batch"]))
    ans = C.control_answers(d, mx, R.Precision(config["modes"], True), lats,
                            seed)
    nums = C.judge(d, mx, R.Precision(config["modes"]), ans, lats, seed)
    real = "g100k_448.dense" if mix == "dense" else "g100k_448.serve"
    assert not C.verdict(nums, limits_of(real), 0), nums


@pytest.mark.parametrize("mix", ["serve", "dense"])
def test_a_stale_answer_of_a_law_is_not_correct(tmp_path, mix):
    bench, (cell,) = law_bench(tmp_path, mixes=(mix,), batch=1)
    q = bench.base / "mixes" / f"toy{mix}.json"
    q.write_text(json.dumps({**json.loads(q.read_text()),
                             "check_latents": 8}))
    real = "g100k_448.dense" if mix == "dense" else "g100k_448.serve"
    (bench.base / "limits" / f"{cell}.json").write_text(
        json.dumps(limits_of(real)))
    Stale.last = None
    out = H.run_cell(bench, cell, 5, 1.0, False, "cpu", program=Stale)
    assert out["correct"] is False, out["check"]
