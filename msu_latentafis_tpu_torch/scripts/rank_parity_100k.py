"""Serving against dense rank parity at 100,000 entries.

    python -m msu_latentafis_tpu_torch.scripts.rank_parity_100k \
        [--device cuda|cpu] [--record]

The port's counterpart of the JAX package's ``scripts/rank_parity_100k.py``:
NL latents against a synthetic gallery with a planted mate each, matched
on the same data dense (``match_scores_batch``, every entry exact) and
serving (``match_scores_batch_reranked``: the screens, the top m, the
exact rerank of those), in the JAX bench's modes: bf16 with int8
predecoded texture at the 448 shape, bf16 codes-resident with int8
minutiae at the cap shape. Per latent: the mate's rank in each, the
top-24 set overlap and order agreement, the score gap of the two sorted
top-24s, the containment margin. The serving time is steady state (a
warm-up call first); the dense time is the first call after the kernels'
build.

Environment (the JAX script's names and defaults): PARITY_GALLERY
(100000), PARITY_LATENTS (8), PARITY_BLOCK (512), PARITY_RERANK (256),
PARITY_SHAPES (448 | cap), PARITY_PRESCREEN / _LT / _T (256 / 64 / 1).
``--record`` writes ``results/torch/rank_parity_100k[_cap].json``.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ..templates.packing import pack_gallery
from ..utils.synthetic import (device_synthetic_gallery, make_latent_template,
                               make_rolled_template, plant_gallery_entries)
from . import measure as M

NOTE = ("dense ranks 2-24 are iid-noise impostors on this synthetic "
        "gallery; serving is equivalent when the mate parity holds and the "
        "sorted top-24 exact-score vectors match to noise level")


def mate_positions(G: int, NL: int) -> list:
    """Latent i's mate: spread over the gallery (the JAX script's :76)."""
    return [(i * G) // NL + (i * 977) % (G // NL) for i in range(NL)]


def make_inputs(cb, G: int, NL: int, shapes: Sequence[int]):
    """(packed latents, packed mates, mate positions), drawn from
    default_rng(23) in the JAX script's order: the latents, then their
    mates."""
    RM, RT, LM, LT = shapes
    rng = np.random.default_rng(23)
    lats_t = [make_latent_template(rng, n_minu=LM, n_tex=LT)
              for _ in range(NL)]
    mates = [make_rolled_template(rng, n_minu=RM, n_tex=RT,
                                  mated_latent=lats_t[i], codebook=cb)
             for i in range(NL)]
    packed = pack_gallery(mates, cb, names=[f"mate{i}" for i in range(NL)],
                          minu_cap=RM, tex_cap=RT)
    return ([M.pack(t, LM, LT) for t in lats_t], packed,
            mate_positions(G, NL))


def measure(engine, gal, lats, G: int, m: int,
            prescreen: Sequence[int]) -> dict:
    """Dense scores [NL, G], then serving (a warm-up call, then the timed
    one): idx, exact [NL, m_pad], margin [NL], and both seconds."""
    dev = engine.device
    scores, dense_s = M.clock(lambda: engine.match_scores_batch(lats, gal),
                              dev)
    PK, PLT, PT = prescreen
    kw = dict(m=m, prescreen_k=PK, prescreen_lt=PLT, prescreen_t=PT)
    engine.match_scores_batch_reranked(lats, gal, **kw)
    (idx, exact, margin, _), serve_s = M.clock(
        lambda: engine.match_scores_batch_reranked(lats, gal, **kw), dev)
    return dict(dense=scores[:, :G].float().cpu().numpy(), idx=idx,
                exact=exact, margin=margin, dense_s=dense_s,
                serve_s=serve_s)


def latent_record(dense, idx, exact, margin, mate_pos: int,
                  ndigits: Optional[int] = 3) -> dict:
    """One latent's record, as the JAX script's loop makes it (:116-150):
    dense [G] scores, idx / exact [m_pad] the serving candidates and their
    exact scores, margin the containment margin; scores rounded to
    ``ndigits`` (None keeps them)."""
    def r(v):
        return float(v) if ndigits is None else round(float(v), ndigits)
    dense, idx, exact = (np.asarray(a) for a in (dense, idx, exact))
    d_order = np.argsort(-dense, kind="stable")
    d_top24 = d_order[:24]
    srt = np.argsort(-exact, kind="stable")
    s_top24 = idx[srt[:24]]
    in_serve = np.where(idx[srt] == mate_pos)[0]
    d_scores24 = np.sort(dense[d_top24])[::-1]
    s_scores24 = np.sort(exact[srt[:24]])[::-1]
    return {
        "mate_rank_dense": int(np.where(d_order == mate_pos)[0][0]) + 1,
        "mate_rank_serving": int(in_serve[0]) + 1 if len(in_serve) else -1,
        "top24_set_overlap": len(set(d_top24) & set(s_top24)),
        "top24_order_agreement": int(np.sum(d_top24 == s_top24)),
        "top24_score_gap_max": r(np.max(np.abs(d_scores24 - s_scores24))),
        "dense_24th_score": r(d_scores24[-1]),
        "serving_24th_score": r(s_scores24[-1]),
        "mate_score": r(dense[mate_pos]),
        "best_impostor": r(np.max(np.delete(dense, mate_pos))),
        "containment_margin": r(margin)}


def summarize(records: Sequence[dict]) -> dict:
    """The JAX script's summary (:151-160)."""
    gaps = [r["top24_score_gap_max"] for r in records]
    return {
        "all_top24_sets_equal": all(r["top24_set_overlap"] == 24
                                    for r in records),
        "all_top24_orders_equal": all(r["top24_order_agreement"] == 24
                                      for r in records),
        "all_mates_rank1_both_modes": all(
            r["mate_rank_dense"] == 1 and r["mate_rank_serving"] == 1
            for r in records),
        "max_top24_score_gap": max(gaps) if gaps else None,
        "note": NOTE}


def run(cap: bool = False, G: int = 100000, NL: int = 8, block: int = 512,
        m: int = 256, prescreen: Sequence[int] = (256, 64, 1),
        device="cuda", shapes: Optional[Sequence[int]] = None):
    """The whole script at these sizes: (record, the raw outputs of
    ``measure``)."""
    shapes = tuple(shapes or M.shapes_of(cap))
    cb = M.codebook()
    engine = M.serving_engine(cb, cap, block, device)
    lats, packed_mates, mate_pos = make_inputs(cb, G, NL, shapes)
    print(f"gallery G={G} shapes Rm={shapes[0]},Rt={shapes[1]}...",
          flush=True)
    RM, RT, LM, LT = shapes
    gal = device_synthetic_gallery(engine, G, n_minu=RM, n_tex=RT,
                                   codes_resident=cap, seed=3)
    plant_gallery_entries(gal, engine, packed_mates, mate_pos)
    out = measure(engine, gal, lats, G, m, prescreen)
    PK, PLT, PT = prescreen
    results = {"config": {
        "G": G, "latents": NL, "block": block, "rerank_m": m,
        "prescreen": {"k": PK, "lt": PLT, "t": PT},
        "shapes": {"Rm": RM, "Rt": RT, "Lm": LM, "Lt": LT},
        "engine": ("bf16 + codes-resident + int8 minu" if cap
                   else "bf16 + int8 predecoded tex"),
        "dense_seconds": out["dense_s"],
        "serving_seconds": out["serve_s"], **M.header(engine.device)},
        "latents": []}
    M.emit(results["config"])
    for i in range(NL):
        rec = latent_record(out["dense"][i], out["idx"][i], out["exact"][i],
                            out["margin"][i], mate_pos[i])
        results["latents"].append(rec)
        M.emit(rec)
    results["summary"] = summarize(results["latents"])
    M.emit({**results["summary"], **M.header(engine.device)})
    return results, out


def main(argv=None) -> int:
    args = M.parser(__doc__).parse_args(argv)
    dev = M.device_of(args.device)
    shapes = os.environ.get("PARITY_SHAPES", "448")
    if shapes not in ("448", "cap"):
        raise ValueError(f"PARITY_SHAPES={shapes}: 448 or cap")
    cap = shapes == "cap"
    results, _ = run(
        cap, G=M.env_int("PARITY_GALLERY", 100000),
        NL=M.env_int("PARITY_LATENTS", 8),
        block=M.env_int("PARITY_BLOCK", 512),
        m=M.env_int("PARITY_RERANK", 256),
        prescreen=(M.env_int("PARITY_PRESCREEN", 256),
                   M.env_int("PARITY_PRESCREEN_LT", 64),
                   M.env_int("PARITY_PRESCREEN_T", 1)), device=dev)
    if args.record:
        print("wrote", M.write_record(
            "rank_parity_100k_cap" if cap else "rank_parity_100k", results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
