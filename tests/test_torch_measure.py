"""The port's measuring scripts on the CPU against the JAX package.

``msu_latentafis_tpu_torch/scripts/{rank_parity_100k,rank_parity_structured,
profile_rerank,profile_match,bench_ladder}.py`` and the two pieces of
``utils/synthetic.py`` they need, at small sizes (block 8, Rm 20 / Rt 40 /
Lm 12 / Lt 30, G 64): the JAX side builds its galleries with its own
``device_synthetic_gallery`` and ``plant_gallery_entries``, the port reads
them through ``convert.gallery_from_jax``, and each script's record of the
port's outputs is held against the JAX script's loop run on the JAX
engine's outputs (restated below, lines cited). Ranks, overlaps and hits
exact; scores within the modes' rtol 1e-4 / atol 1e-3 (the two engines
sum in other orders); host-made templates and queries bit for bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msu_latentafis_tpu.matcher.engine import MatchEngine as JaxEngine
from msu_latentafis_tpu.ops.pq import pq_decode as jax_pq_decode
from msu_latentafis_tpu.templates.packing import PackedLatent as JaxLatent
from msu_latentafis_tpu.templates.packing import pack_gallery as jax_pack
from msu_latentafis_tpu.templates.packing import pack_latent as jax_pack_latent
from msu_latentafis_tpu.utils import synthetic as jsyn
from msu_latentafis_tpu_torch.matcher.convert import gallery_from_jax
from msu_latentafis_tpu_torch.matcher.engine import MatchEngine
from msu_latentafis_tpu_torch.matcher.kernels import ops
from msu_latentafis_tpu_torch.matcher.texture_match import decode_pq
from msu_latentafis_tpu_torch.scripts import bench_ladder as bl
from msu_latentafis_tpu_torch.scripts import measure as M
from msu_latentafis_tpu_torch.scripts import profile_match as pm
from msu_latentafis_tpu_torch.scripts import profile_rerank as pr
from msu_latentafis_tpu_torch.scripts import rank_parity_100k as rp
from msu_latentafis_tpu_torch.scripts import rank_parity_structured as rs
from msu_latentafis_tpu_torch.utils import synthetic as tsyn


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch on one intra-op thread: the suite's workers share the host's
    cores, and an intra-op pool in each spins waiting on the others (a
    test ran 7x slower with 8 threads than with 1 beside 8 busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ENGINE_TOL = dict(rtol=1e-4, atol=1e-3)
SHAPES = (20, 40, 12, 30)           # Rm, Rt, Lm, Lt
G, BLOCK, NL, NM = 64, 8, 2, 6
M_RERANK, PRESCREEN = 24, (24, 16, 1)
ROW_CAP = SHAPES[0]                 # the exact top-120, as JAX's CPU top_k
MODES = {"448": False, "cap": True}


def packed_equal(a, b):
    for f in dataclasses.fields(a):
        if f.name not in ("names", "name"):
            np.testing.assert_array_equal(getattr(a, f.name),
                                          getattr(b, f.name), err_msg=f.name)


# ---------------------------------------------------------------------------
# utils/synthetic.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("noise,tex_noise", [(0.25, 0.0), (0.8, 0.8),
                                             (2.0, 3.0)])
def test_make_rolled_template_grades_match_jax(noise, tex_noise):
    """A graded near-mate: the same template from the same seed, and the
    generator left in the same state."""
    cb = tsyn.random_codebook(np.random.default_rng(0))
    rj, rt = np.random.default_rng(5), np.random.default_rng(5)
    lj = jsyn.make_latent_template(rj, n_minu=12, n_tex=30)
    lt = tsyn.make_latent_template(rt, n_minu=12, n_tex=30)
    kw = dict(n_minu=20, n_tex=40, codebook=cb, noise=noise,
              tex_noise=tex_noise)
    tj = jsyn.make_rolled_template(rj, mated_latent=lj, **kw)
    tt = tsyn.make_rolled_template(rt, mated_latent=lt, **kw)
    for a, b in ((tj.minu_template[0], tt.minu_template[0]),
                 (tj.texture_template[0], tt.texture_template[0])):
        np.testing.assert_array_equal(a.minutiae, b.minutiae)
        np.testing.assert_array_equal(a.des, b.des)
    assert rj.bit_generator.state == rt.bit_generator.state
    plain = tsyn.make_rolled_template(np.random.default_rng(5),
                                      n_minu=20, n_tex=40)
    assert not np.array_equal(plain.texture_template[0].des,
                              tt.texture_template[0].des)


def test_codes_resident_synthetic_gallery():
    """codes_resident keeps only the uint8 codes: tex_sqnorm is the f32
    decode's, the int8 minutiae sit at the JAX generator's fixed scale, and
    the tensors and scores equal its both_layouts predecoded twin's."""
    cb = tsyn.random_codebook(np.random.default_rng(3))
    e = MatchEngine(cb, block_size=4, compute_dtype=torch.bfloat16,
                    minu_int8=True, row_cap=8, device="cpu")
    kw = dict(n_minu=8, n_tex=12, seed=1, chunk=4)
    codes = tsyn.device_synthetic_gallery(e, 10, codes_resident=True, **kw)
    pre, twin = tsyn.device_synthetic_gallery(e, 10, both_layouts=True, **kw)
    assert codes.tex_dec is None and codes.codes_resident
    real = slice(0, 10)
    dec = decode_pq(codes.tex_codes[real], e.codebook_t)
    assert torch.equal(codes.tex_sqnorm[real], (dec * dec).sum(dim=2))
    # the JAX generator's scale (its synthetic.py:170, :238-239), bit for bit
    assert codes.minu_scale.numpy().tobytes() == \
        np.full((1,), jsyn.DES_NORM / 127.0 + 1e-12, np.float32).tobytes()
    assert codes.minu_des.dtype == torch.int8
    norms = (codes.minu_des[real].float() * codes.minu_scale).norm(dim=2)
    half_step = 0.5 * float(codes.minu_scale) * 96 ** 0.5
    assert float((norms - tsyn.DES_NORM).abs().max()) <= half_step
    for f in ("minu_des", "minu_pack", "minu_n", "tex_sqnorm", "tex_pack",
              "tex_n", "tex_codes"):
        assert torch.equal(getattr(codes, f), getattr(twin, f)), f
    rng = np.random.default_rng(4)
    lats = [M.pack(tsyn.make_latent_template(rng, n_minu=6, n_tex=10), 6, 10)
            for _ in range(2)]
    assert torch.equal(e.match_scores_batch(lats, codes),
                       e.match_scores_batch(lats, pre))
    with pytest.raises(ValueError):
        tsyn.device_synthetic_gallery(e, 10, codes_resident=True,
                                      both_layouts=True)


# ---------------------------------------------------------------------------
# rank parity: the port's records against the JAX scripts' loops
# ---------------------------------------------------------------------------

def jax_loop_100k(dense, idx, exact, margin, mate_pos, rnd):
    """rank_parity_100k.py:116-161 on the JAX engine's outputs (``rnd``:
    the script's round(x, 3), or float to keep the scores)."""
    results = {"latents": []}
    all_set24 = all_order24 = all_mate = True
    for i in range(len(mate_pos)):
        d_order = np.argsort(-dense[i], kind="stable")
        d_top24 = d_order[:24]
        srt = np.argsort(-np.asarray(exact[i]), kind="stable")
        s_top24_idx = np.asarray(idx[i])[srt[:24]]
        mate_rank_dense = int(np.where(d_order == mate_pos[i])[0][0]) + 1
        in_serve = np.where(np.asarray(idx[i])[srt] == mate_pos[i])[0]
        mate_rank_serve = int(in_serve[0]) + 1 if len(in_serve) else -1
        set_agree = len(set(d_top24) & set(s_top24_idx))
        order_agree = int(np.sum(d_top24 == s_top24_idx))
        all_set24 &= set_agree == 24
        all_order24 &= order_agree == 24
        all_mate &= mate_rank_dense == 1 and mate_rank_serve == 1
        d_scores24 = np.sort(dense[i][d_top24])[::-1]
        s_scores24 = np.sort(np.asarray(exact[i])[srt[:24]])[::-1]
        results["latents"].append({
            "mate_rank_dense": mate_rank_dense,
            "mate_rank_serving": mate_rank_serve,
            "top24_set_overlap": set_agree,
            "top24_order_agreement": order_agree,
            "top24_score_gap_max": rnd(float(
                np.max(np.abs(d_scores24 - s_scores24)))),
            "dense_24th_score": rnd(float(d_scores24[-1])),
            "serving_24th_score": rnd(float(s_scores24[-1])),
            "mate_score": rnd(float(dense[i, mate_pos[i]])),
            "best_impostor": rnd(float(np.max(
                np.delete(dense[i], mate_pos[i])))),
            "containment_margin": rnd(float(margin[i]))})
    gaps = [r["top24_score_gap_max"] for r in results["latents"]]
    results["summary"] = {
        "all_top24_sets_equal": bool(all_set24),
        "all_top24_orders_equal": bool(all_order24),
        "all_mates_rank1_both_modes": bool(all_mate),
        "max_top24_score_gap": max(gaps) if gaps else None}
    return results


def jax_loop_structured(dense, idx, exact, mate_pos, planted_sets, rnd):
    """rank_parity_structured.py:122-153 on the JAX engine's outputs."""
    out = {"latents": []}
    all_set = all_order = all_mate = True
    for i in range(len(mate_pos)):
        d_order = np.argsort(-dense[i], kind="stable")
        d_top24 = d_order[:24]
        srt = np.argsort(-np.asarray(exact[i]), kind="stable")
        s_top24 = np.asarray(idx[i])[srt[:24]]
        n_structured = sum(1 for g in d_top24 if g in planted_sets[i])
        set_overlap = len(set(d_top24) & set(s_top24))
        order_agree = int(np.sum(d_top24 == s_top24))
        mate_rank_dense = int(np.where(d_order == mate_pos[i])[0][0]) + 1
        in_s = np.where(np.asarray(idx[i])[srt] == mate_pos[i])[0]
        mate_rank_serve = int(in_s[0]) + 1 if len(in_s) else -1
        all_set &= set_overlap == 24
        all_order &= order_agree == 24
        all_mate &= mate_rank_dense == 1 and mate_rank_serve == 1
        out["latents"].append({
            "dense_top24_structured_entries": n_structured,
            "top24_set_overlap": set_overlap,
            "top24_order_agreement": order_agree,
            "mate_rank_dense": mate_rank_dense,
            "mate_rank_serving": mate_rank_serve,
            "dense_24th_score": rnd(float(dense[i][d_top24[-1]])),
            "serving_24th_score": rnd(float(np.asarray(exact[i])[srt[23]]))})
    out["summary"] = {"all_top24_sets_equal": bool(all_set),
                      "all_top24_orders_equal": bool(all_order),
                      "all_mates_rank1_both_modes": bool(all_mate)}
    return out


def assert_records_close(got: dict, want: dict):
    """Integers and flags equal, scores within ENGINE_TOL (NaN == NaN)."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, float):
            np.testing.assert_allclose(got[k], w, equal_nan=True,
                                       err_msg=k, **ENGINE_TOL)
        else:
            assert got[k] == w, k


def jax_run(je, jlats, jgal, mates_packed, positions):
    """The JAX scripts' steps after the gallery: plant (into a copy: the
    scatter donates its input), dense, serving."""
    jgal = dataclasses.replace(jgal, **{
        f.name: jnp.array(getattr(jgal, f.name))
        for f in dataclasses.fields(jgal)
        if f.name not in ("names", "n_real")
        and getattr(jgal, f.name) is not None})
    jgal = jsyn.plant_gallery_entries(jgal, je, mates_packed, positions)
    dense = np.asarray(je.match_scores_batch(jlats, jgal))[:, :G]
    PK, PLT, PT = PRESCREEN
    idx, exact, margin, _ = je.match_scores_batch_reranked(
        jlats, jgal, m=M_RERANK, prescreen_k=PK, prescreen_lt=PLT,
        prescreen_t=PT)
    arrays = {k: np.asarray(v) for k, v in je._gallery_dict(jgal).items()}
    return dict(dense=dense, idx=np.asarray(idx), exact=np.asarray(exact),
                margin=np.asarray(margin)), arrays


def port_run(cap, cb, arrays, lats):
    te = M.serving_engine(cb, cap, BLOCK, "cpu", row_cap=ROW_CAP)
    gal = gallery_from_jax(arrays, n_real=G, device="cpu")
    return rp.measure(te, gal, lats, G, M_RERANK, PRESCREEN)


@pytest.fixture(scope="module", params=list(MODES))
def parity(request):
    """Per mode, one JAX engine (its compiled programs shared by both
    scripts' galleries) and both scripts' JAX and port outputs."""
    cap = MODES[request.param]
    RM, RT, LM, LT = SHAPES
    cb = tsyn.random_codebook(np.random.default_rng(20261017))
    je = JaxEngine(cb, block_size=BLOCK, compute_dtype=jnp.bfloat16,
                   tex_int8=not cap, minu_int8=cap, codes_resident=cap)

    # both scripts draw the same gallery (seed 3), then plant their own
    jgal = jsyn.device_synthetic_gallery(je, G, n_minu=RM, n_tex=RT,
                                         codes_resident=cap, seed=3, chunk=32)
    out = {"cap": cap}
    # rank_parity_100k.py:60-83, the host side drawn as the script draws it
    rng = np.random.default_rng(23)
    lats_t = [jsyn.make_latent_template(rng, n_minu=LM, n_tex=LT)
              for _ in range(NL)]
    jlats = [jax_pack_latent(t, quantize_tex_xy=False, minu_cap=LM,
                             tex_cap=LT) for t in lats_t]
    mate_pos = [(i * G) // NL + (i * 977) % (G // NL) for i in range(NL)]
    mates = [jsyn.make_rolled_template(rng, n_minu=RM, n_tex=RT,
                                       mated_latent=lats_t[i], codebook=cb)
             for i in range(NL)]
    jmates = jax_pack(mates, cb, names=[f"mate{i}" for i in range(NL)],
                      minu_cap=RM, tex_cap=RT)
    tlats, tmates, tpos = rp.make_inputs(cb, G, NL, SHAPES)
    assert tpos == mate_pos
    packed_equal(tmates, jmates)
    for a, b in zip(tlats, jlats):
        packed_equal(a, b)
    jout, arrays = jax_run(je, jlats, jgal, jmates, mate_pos)
    out["100k"] = dict(jax=jout, port=port_run(cap, cb, arrays, tlats),
                       mate_pos=mate_pos)
    # rank_parity_structured.py:58-93; the planted entries packed at the
    # gallery's widths (the script packs them uncapped, which is the same
    # width at its 96 / 448 and 128 / 1000 and would not fit these)
    rng = np.random.default_rng(31)
    lats_t = [jsyn.make_latent_template(rng, n_minu=LM, n_tex=LT)
              for _ in range(NL)]
    jlats = [jax_pack_latent(t, quantize_tex_xy=False, minu_cap=LM,
                             tex_cap=LT) for t in lats_t]
    minu_noises = np.concatenate([[0.25], np.geomspace(0.35, 2.0, NM)])
    tex_noises = np.concatenate([[0.0], np.geomspace(0.3, 3.0, NM)])
    planted, positions = [], []
    all_pos = np.random.default_rng(7).choice(G, size=NL * (NM + 1),
                                              replace=False)
    k = 0
    for i in range(NL):
        for j in range(NM + 1):
            planted.append(jsyn.make_rolled_template(
                rng, n_minu=RM, n_tex=RT, mated_latent=lats_t[i],
                codebook=cb, noise=float(minu_noises[j]),
                tex_noise=float(tex_noises[j])))
            positions.append(int(all_pos[k]))
            k += 1
    jplanted = jax_pack(planted, cb, names=[f"p{i}" for i in
                                            range(len(planted))],
                        minu_cap=RM, tex_cap=RT)
    tlats, tplanted, tpositions = rs.make_inputs(cb, G, NL, NM, SHAPES)
    assert tpositions == positions
    packed_equal(tplanted, jplanted)
    for a, b in zip(tlats, jlats):
        packed_equal(a, b)
    jout, arrays = jax_run(je, jlats, jgal, jplanted, positions)
    out["structured"] = dict(
        jax=jout, port=port_run(cap, cb, arrays, tlats),
        mate_pos={i: positions[i * (NM + 1)] for i in range(NL)},
        planted={i: set(positions[i * (NM + 1):(i + 1) * (NM + 1)])
                 for i in range(NL)})
    return out


def test_rank_parity_100k_records_match_jax(parity):
    """rank_parity_100k's per-latent record and summary: the port's
    function on the JAX outputs is the JAX loop's record exactly; on the
    port's own outputs it is within the modes' tolerance of it."""
    s = parity["100k"]
    j, t, pos = s["jax"], s["port"], s["mate_pos"]
    want = jax_loop_100k(j["dense"], j["idx"], j["exact"], j["margin"], pos,
                         lambda x: round(x, 3))
    recs = [rp.latent_record(j["dense"][i], j["idx"][i], j["exact"][i],
                             j["margin"][i], pos[i]) for i in range(NL)]
    assert json_eq(recs, want["latents"])
    summary = rp.summarize(recs)
    assert {k: summary[k] for k in want["summary"]} == want["summary"]
    np.testing.assert_array_equal(t["idx"], j["idx"])
    want = jax_loop_100k(j["dense"], j["idx"], j["exact"], j["margin"], pos,
                         float)
    for i in range(NL):
        assert_records_close(rp.latent_record(
            t["dense"][i], t["idx"][i], t["exact"][i], t["margin"][i],
            pos[i], ndigits=None), want["latents"][i])
    assert all(r["mate_rank_dense"] == 1 for r in want["latents"])


def test_rank_parity_structured_records_match_jax(parity):
    """rank_parity_structured's per-latent record and summary, as above;
    the dense top-24 holds planted entries."""
    s = parity["structured"]
    j, t = s["jax"], s["port"]
    pos, planted = s["mate_pos"], s["planted"]
    want = jax_loop_structured(j["dense"], j["idx"], j["exact"], pos,
                               planted, lambda x: round(x, 3))
    recs = [rs.latent_record(j["dense"][i], j["idx"][i], j["exact"][i],
                             pos[i], planted[i]) for i in range(NL)]
    assert json_eq(recs, want["latents"])
    summary = rs.summarize(recs)
    assert {k: summary[k] for k in want["summary"]} == want["summary"]
    np.testing.assert_array_equal(t["idx"], j["idx"])
    want = jax_loop_structured(j["dense"], j["idx"], j["exact"], pos,
                               planted, float)
    for i in range(NL):
        assert_records_close(rs.latent_record(
            t["dense"][i], t["idx"][i], t["exact"][i], pos[i], planted[i],
            ndigits=None), want["latents"][i])
        assert want["latents"][i]["dense_top24_structured_entries"] > 0


def json_eq(a, b) -> bool:
    """Lists of records equal, NaN equal to NaN (a prescreen's margin)."""
    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(
            x[k] == y[k] or (x[k] != x[k] and y[k] != y[k]) for k in x)
        for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# the ladder's host-packed entries: mated1k, mated_cmc, rolled1k
# ---------------------------------------------------------------------------

def jax_mated_queries(packed, noise, rng, NQ, cb, tdes0=None):
    """bench_ladder.py:182-202 (tdes0 None: decoded inside the loop) and
    :335-356 (the decoded texture given)."""
    RM = packed.minu_des.shape[1]
    queries = []
    for i in range(NQ):
        md = packed.minu_des[i] + noise * rng.standard_normal(
            (RM, 96)).astype(np.float32)
        md /= np.linalg.norm(md, axis=1, keepdims=True) + 1e-7
        md *= jsyn.DES_NORM
        mxy = packed.minu_xy[i] + rng.normal(0, 3.0, (RM, 2))
        if tdes0 is None:
            tdes = jax_pq_decode(packed.tex_codes[i], cb).astype(np.float32)
            tdes += noise * rng.standard_normal(tdes.shape).astype(np.float32)
        else:
            tdes = tdes0[i] + noise * rng.standard_normal(
                tdes0[i].shape).astype(np.float32)
        tdes *= jsyn.DES_NORM / (np.linalg.norm(tdes, axis=1, keepdims=True)
                                 + 1e-7)
        queries.append(JaxLatent(
            minu_des=md[None].astype(np.float32),
            minu_xy=mxy[None].astype(np.float32),
            minu_ori=packed.minu_ori[i][None], minu_n=packed.minu_n[i][None],
            tex_des=tdes, tex_xy=packed.tex_xy[i], tex_ori=packed.tex_ori[i],
            tex_n=packed.tex_n[i]))
    return queries


def jax_ranks(je, queries, jgal):
    """bench_ladder.py:204-210."""
    ranks = []
    for i0 in range(0, len(queries), 8):
        s = np.asarray(je.match_scores_batch(queries[i0:i0 + 8], jgal))
        for k in range(s.shape[0]):
            order = np.argsort(-s[k, :G], kind="stable")
            ranks.append(int(np.where(order == i0 + k)[0][0]) + 1)
    return np.asarray(ranks)


@pytest.fixture(scope="module")
def ladder():
    RM, RT = SHAPES[:2]
    cb = tsyn.random_codebook(np.random.default_rng(20261017))
    je = JaxEngine(cb, block_size=BLOCK, compute_dtype=jnp.bfloat16,
                   tex_int8=True)
    te = MatchEngine(cb, block_size=BLOCK, compute_dtype=torch.bfloat16,
                     tex_int8=True, row_cap=ROW_CAP, device="cpu")
    rj, rt = np.random.default_rng(29), np.random.default_rng(29)
    jp = jsyn.synthetic_packed_gallery(rj, cb, G=G, n_minu=RM, n_tex=RT)
    tp = tsyn.synthetic_packed_gallery(rt, cb, G=G, n_minu=RM, n_tex=RT)
    packed_equal(tp, jp)
    return dict(cb=cb, je=je, te=te, rj=rj, rt=rt, jp=jp, tp=tp,
                jgal=je.load_gallery(jp), tgal=te.load_gallery(tp))


def test_ladder_mated_entries_match_jax(ladder):
    """mated1k's queries (drawn after the gallery from the same generator)
    and mated_cmc's (default_rng(101) per noise, one gallery, two noises)
    equal the JAX script's, and their dense ranks equal the JAX engine's."""
    s, NQ = ladder, 8
    jq = jax_mated_queries(s["jp"], 0.35, s["rj"], NQ, s["cb"])
    tq = bl.mated_queries(s["tp"], bl.decoded(s["tp"], s["cb"], NQ), 0.35,
                          s["rt"], NQ)
    for a, b in zip(tq, jq):
        packed_equal(a, b)
    ranks = bl.mated_ranks(s["te"], tq, s["tgal"], G)
    np.testing.assert_array_equal(ranks, jax_ranks(s["je"], jq, s["jgal"]))
    assert (ranks == 1).mean() == 1.0
    tdes0 = [jax_pq_decode(s["jp"].tex_codes[i], s["cb"]).astype(np.float32)
             for i in range(NQ)]
    curve = bl.cmc_curve(s["te"], s["tgal"], s["tp"],
                         bl.decoded(s["tp"], s["cb"], NQ), G, (0.35, 2.0),
                         NQ)
    for noise, ranks, dt in curve:
        jq = jax_mated_queries(s["jp"], noise, np.random.default_rng(101),
                               NQ, s["cb"], tdes0)
        np.testing.assert_array_equal(ranks,
                                      jax_ranks(s["je"], jq, s["jgal"]))
        point = bl.cmc_point(noise, ranks, dt)
        assert point["rank1"] == float((ranks == 1).mean())


def test_ladder_rolled1k_matches_jax(ladder):
    """rolled1k's queries (the rolled prints' minutiae templates and their
    texture decoded as the engine stores it) equal the JAX script's
    (:397-409, its _decode_all_fn), and both engines find every self-match
    at rank 1 with the same ranking."""
    s = ladder
    RT = SHAPES[1]
    dec = np.asarray(s["je"]._decode_all_fn(1, 8, RT, 16)(
        jnp.asarray(s["jp"].tex_codes[:8].reshape(8, -1))))
    if dec.dtype == np.int8:
        dec = dec.astype(np.float32) * s["je"]._tex_scale_g
    tq = bl.rolled_queries(s["te"], s["tp"], 8)
    for i, q in enumerate(tq):
        np.testing.assert_array_equal(q.tex_des, np.swapaxes(dec[i], 0, 1))
        np.testing.assert_array_equal(q.minu_des, s["tp"].minu_des[i][None])
    jq = [JaxLatent(**{f.name: getattr(q, f.name)
                       for f in dataclasses.fields(q)}) for q in tq]
    # the JAX scores of all 8 in one batch (the mated queries' shapes, so
    # its compiled program is reused); the port's as the script batches
    j = np.asarray(s["je"].match_scores_batch(jq, s["jgal"]))
    for lo in (0, 4):
        t = s["te"].match_scores_batch(tq[lo:lo + 4], s["tgal"]).numpy()
        np.testing.assert_allclose(t, j[lo:lo + 4], **ENGINE_TOL)
        for k in range(4):
            assert int(np.argmax(t[k, :G])) == int(np.argmax(j[lo + k, :G])) \
                == lo + k


def test_ladder_scale_two_ranks_over_gloo():
    """The weak-scaling entry at world sizes 1 and 2, one spawn: seconds per
    match at each, the first shard's scores equal at both."""
    results = {}
    bl.bench_scale(results, tsyn.random_codebook(np.random.default_rng(0)),
                   None, sizes=(1, 2), per_rank=32)
    r = results["scale_gloo_cpu"]
    assert set(r["seconds_per_match"]) == {"1", "2"}
    assert all(t > 0 for t in r["seconds_per_match"].values())
    assert r["weak_efficiency_vs_1"]["1"] == 1.0
    assert r["first_shard_scores_equal"] is True
    assert r["measured_on"] == "cpu (gloo)"


# ---------------------------------------------------------------------------
# profiles and entry points
# ---------------------------------------------------------------------------

def test_profile_match_stubs_and_restores():
    """Each variant runs with its kernels stubbed and no other; the
    originals come back after every variant, and after one that raises."""
    originals = {n: getattr(ops, n) for n in pm.STUBS}
    seen = {}

    def time_fn(engine, gal, warm, batch):
        seen[len(seen)] = {n for n in pm.STUBS
                           if getattr(ops, n) is pm.STUBS[n]}
        return 1.0 + len(seen)

    res = pm.profile(None, None, lambda tag: ([], [0]), time_fn=time_fn)
    assert [seen[i] for i in range(5)] == [set(v[1]) for v in pm.VARIANTS]
    assert list(res) == [v[0] for v in pm.VARIANTS]
    assert set(pm.breakdown(res)) == {"minu_kernel_s", "tex_kernel_s",
                                      "core_s", "adc_s", "scan_s"}
    assert all(getattr(ops, n) is f for n, f in originals.items())

    def failing(engine, gal, warm, batch):
        if ops.adc_rowmax is pm.STUBS["adc_rowmax"]:
            raise RuntimeError("variant fails")
        return 1.0
    with pytest.raises(RuntimeError):
        pm.profile(None, None, lambda tag: ([], [0]), time_fn=failing)
    assert all(getattr(ops, n) is f for n, f in originals.items())


def test_profile_stubs_keep_shapes():
    """The stubs return the shapes and types of the kernels they replace."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((2, 5, 8)), dtype=torch.bfloat16)
    dec = torch.zeros((3, 7, 8), dtype=torch.int8)
    best, bestj = pm.fake_adc(x, None, dec, None, None)
    assert best.shape == (2, 3, 5) and best.dtype == torch.float32
    assert bestj.shape == best.shape and bestj.dtype == torch.int32
    assert pm.fake_tex(best, bestj, None, None, None).shape == (2, 3)
    ldes = torch.zeros((6, 4, 8), dtype=torch.bfloat16)
    out = pm.fake_minu(ldes, None, dec, None, None, None, top_n=120)
    assert out.shape == (6, 3) and out.dtype == torch.float32


def test_profile_rerank_rates_on_the_cpu():
    """profile_rerank at small sizes: the breakdown adds up, the ADC rate
    at each block."""
    out = pr.run(G=G, NL=NL, block=BLOCK, m=M_RERANK, device="cpu",
                 shapes=SHAPES, blocks=(8, 16))
    assert out["breakdown_s"]["screen_scan"] + \
        out["breakdown_s"]["topk_gather_rerank"] == pytest.approx(
            out["full_s"])
    assert set(out["kernel_rates"]["adc_screen_tflops_by_block"]) == \
        {"8", "16"}
    assert out["config"]["card"] == "cpu"


MAINS = {"rank_parity_100k": rp.main, "rank_parity_structured": rs.main,
         "profile_rerank": pr.main, "profile_match": pm.main,
         "bench_ladder": bl.main}


@pytest.mark.parametrize("name", list(MAINS))
def test_entry_points_need_the_card_or_cpu(name, monkeypatch):
    """Without a card every entry point raises unless it gets --device
    cpu; nothing falls back to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        MAINS[name]([])


def test_profile_match_main_records_on_the_cpu(monkeypatch, tmp_path):
    """``--device cpu --record`` at small environment sizes writes
    results/torch/profile_match.json (here a temporary directory) with the
    JAX script's keys."""
    monkeypatch.setattr(M, "RESULTS", tmp_path)
    for k, v in (("PROF_GALLERY", "8"), ("PROF_LATENTS", "1"),
                 ("PROF_BLOCK", "8")):
        monkeypatch.setenv(k, v)
    assert pm.main(["--device", "cpu", "--record"]) == 0
    import json
    rec = json.loads((tmp_path / "profile_match.json").read_text())
    assert {"minu_kernel_s", "tex_kernel_s", "core_s", "adc_s",
            "scan_s"} <= set(rec)
    assert rec["config"]["gallery"] == 8 and rec["config"]["card"] == "cpu"
    assert all(getattr(ops, n) is not f for n, f in pm.STUBS.items())
