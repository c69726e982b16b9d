"""Rank-list parity of serving against dense over structured impostors.

    python -m msu_latentafis_tpu_torch.scripts.rank_parity_structured \
        [--shapes 448|cap|both] [--device cuda|cpu] [--record]

The port's counterpart of the JAX package's
``scripts/rank_parity_structured.py``. On an iid-noise gallery dense ranks
2-24 are noise, so no screen can reproduce them. Here each latent gets its
true mate plus PARITY_NEARMATES near-mates at graded descriptor noise
(minutiae 0.35-2.0, texture 0.3-3.0, ``make_rolled_template``'s noise and
tex_noise), so the dense top-24 is a ladder of genuinely similar entries.
Dense and serving (truncated prescreen, then the exact rerank) run on the
same data, in the JAX bench's modes per shape, and the record asks for
the top-24 set to be equal (order agreement reported). Times are steady
state (a warm-up call before each timed one).

Environment (the JAX script's names and defaults): PARITY_GALLERY
(100000), PARITY_LATENTS (4), PARITY_NEARMATES (50), PARITY_BLOCK (512),
PARITY_RERANK (256), PARITY_PRESCREEN / _LT / _T (256 / 64 / 1).
``--record`` writes ``results/torch/rank_parity_structured.json`` with
every shape run.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..templates.packing import pack_gallery
from ..utils.synthetic import (device_synthetic_gallery, make_latent_template,
                               make_rolled_template, plant_gallery_entries)
from . import measure as M

NOTE = ("dense top-24 is dominated by planted graded near-mates (structured "
        "entries above); set equality under the truncated-prescreen serving "
        "mode is the operative rank-list fidelity claim")


def noise_grades(NM: int):
    """(minutiae, texture) noise per planted entry, the true mate first
    (the JAX script's :74-75)."""
    return (np.concatenate([[0.25], np.geomspace(0.35, 2.0, NM)]),
            np.concatenate([[0.0], np.geomspace(0.3, 3.0, NM)]))


def make_inputs(cb, G: int, NL: int, NM: int, shapes: Sequence[int]):
    """(packed latents, packed planted entries, their positions): latents
    and then the near-mate ladders from default_rng(31), the positions
    from default_rng(7) (the JAX script's :58-89)."""
    RM, RT, LM, LT = shapes
    rng = np.random.default_rng(31)
    lats_t = [make_latent_template(rng, n_minu=LM, n_tex=LT)
              for _ in range(NL)]
    minu_noises, tex_noises = noise_grades(NM)
    all_pos = np.random.default_rng(7).choice(G, size=NL * (NM + 1),
                                              replace=False)
    planted = [make_rolled_template(
        rng, n_minu=RM, n_tex=RT, mated_latent=lats_t[i], codebook=cb,
        noise=float(minu_noises[j]), tex_noise=float(tex_noises[j]))
        for i in range(NL) for j in range(NM + 1)]
    packed = pack_gallery(planted, cb,
                          names=[f"p{i}" for i in range(len(planted))],
                          minu_cap=RM, tex_cap=RT)
    return ([M.pack(t, LM, LT) for t in lats_t], packed,
            [int(p) for p in all_pos])


def latent_record(dense, idx, exact, mate_pos: int, planted: set,
                  ndigits: Optional[int] = 3) -> dict:
    """One latent's record, as the JAX script's loop makes it (:122-143):
    dense [G], idx / exact [m_pad] the serving candidates and their exact
    scores, ``planted`` the positions of this latent's ladder; scores
    rounded to ``ndigits`` (None keeps them)."""
    def r(v):
        return float(v) if ndigits is None else round(float(v), ndigits)
    dense, idx, exact = (np.asarray(a) for a in (dense, idx, exact))
    d_order = np.argsort(-dense, kind="stable")
    d_top24 = d_order[:24]
    srt = np.argsort(-exact, kind="stable")
    s_top24 = idx[srt[:24]]
    in_s = np.where(idx[srt] == mate_pos)[0]
    return {"dense_top24_structured_entries": sum(
                1 for g in d_top24 if g in planted),
            "top24_set_overlap": len(set(d_top24) & set(s_top24)),
            "top24_order_agreement": int(np.sum(d_top24 == s_top24)),
            "mate_rank_dense": int(np.where(d_order == mate_pos)[0][0]) + 1,
            "mate_rank_serving": int(in_s[0]) + 1 if len(in_s) else -1,
            "dense_24th_score": r(dense[d_top24[-1]]),
            "serving_24th_score": r(exact[srt[23]])}


def summarize(records: Sequence[dict]) -> dict:
    """The JAX script's summary (:146-153)."""
    return {"all_top24_sets_equal": all(r["top24_set_overlap"] == 24
                                        for r in records),
            "all_top24_orders_equal": all(r["top24_order_agreement"] == 24
                                          for r in records),
            "all_mates_rank1_both_modes": all(
                r["mate_rank_dense"] == 1 and r["mate_rank_serving"] == 1
                for r in records),
            "note": NOTE}


def measure(engine, gal, lats, G: int, m: int,
            prescreen: Sequence[int]) -> dict:
    """Dense and serving, each a warm-up call and then the timed one."""
    dev = engine.device
    engine.match_scores_batch(lats, gal)
    scores, dense_s = M.clock(lambda: engine.match_scores_batch(lats, gal),
                              dev)
    PK, PLT, PT = prescreen
    kw = dict(m=m, prescreen_k=PK, prescreen_lt=PLT, prescreen_t=PT)
    engine.match_scores_batch_reranked(lats, gal, **kw)
    (idx, exact, _, _), serve_s = M.clock(
        lambda: engine.match_scores_batch_reranked(lats, gal, **kw), dev)
    return dict(dense=scores[:, :G].float().cpu().numpy(), idx=idx,
                exact=exact, dense_s=dense_s, serve_s=serve_s)


def run_shapes(cap: bool, G: int = 100000, NL: int = 4, NM: int = 50,
               block: int = 512, m: int = 256,
               prescreen: Sequence[int] = (256, 64, 1), device="cuda",
               shapes: Optional[Sequence[int]] = None):
    """One shape's record and the raw outputs of ``measure``."""
    shapes = tuple(shapes or M.shapes_of(cap))
    cb = M.codebook()
    engine = M.serving_engine(cb, cap, block, device)
    lats, packed, positions = make_inputs(cb, G, NL, NM, shapes)
    RM, RT, LM, LT = shapes
    print(f"[{'cap' if cap else '448'}] gallery G={G}...", flush=True)
    gal = device_synthetic_gallery(engine, G, n_minu=RM, n_tex=RT,
                                   codes_resident=cap, seed=3)
    plant_gallery_entries(gal, engine, packed, positions)
    out = measure(engine, gal, lats, G, m, prescreen)
    minu_noises = noise_grades(NM)[0]
    PK, PLT, PT = prescreen
    res = {"config": {
        "G": G, "latents": NL, "near_mates_per_latent": NM, "block": block,
        "rerank_m": m, "prescreen": {"k": PK, "lt": PLT, "t": PT},
        "shapes": {"Rm": RM, "Rt": RT, "Lm": LM, "Lt": LT},
        "minu_noise_grades": [round(float(x), 3) for x in minu_noises[:5]]
        + ["..."] + [round(float(minu_noises[-1]), 3)],
        "dense_seconds_steady": out["dense_s"],
        "serving_seconds_steady": out["serve_s"], **M.header(engine.device)},
        "latents": [], "summary": {}}
    M.emit(res["config"])
    for i in range(NL):
        ladder = positions[i * (NM + 1):(i + 1) * (NM + 1)]
        rec = latent_record(out["dense"][i], out["idx"][i], out["exact"][i],
                            ladder[0], set(ladder))
        res["latents"].append(rec)
        M.emit(rec)
    res["summary"] = summarize(res["latents"])
    M.emit({**res["summary"], **M.header(engine.device)})
    return res, out


def main(argv=None) -> int:
    p = M.parser(__doc__)
    p.add_argument("--shapes", default="both", choices=["448", "cap", "both"])
    args = p.parse_args(argv)
    dev = M.device_of(args.device)
    kw = dict(G=M.env_int("PARITY_GALLERY", 100000),
              NL=M.env_int("PARITY_LATENTS", 4),
              NM=M.env_int("PARITY_NEARMATES", 50),
              block=M.env_int("PARITY_BLOCK", 512),
              m=M.env_int("PARITY_RERANK", 256),
              prescreen=(M.env_int("PARITY_PRESCREEN", 256),
                         M.env_int("PARITY_PRESCREEN_LT", 64),
                         M.env_int("PARITY_PRESCREEN_T", 1)), device=dev)
    results = {}
    for name, cap in (("448", False), ("cap", True)):
        if args.shapes in (name, "both"):
            results[name] = run_shapes(cap, **kw)[0]
    if args.record:
        print("wrote", M.write_record("rank_parity_structured", results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
