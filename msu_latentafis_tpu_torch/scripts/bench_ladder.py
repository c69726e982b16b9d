"""The configuration ladder: seven entries, one JSON line each.

    LADDER=spec100k,... python -m \
        msu_latentafis_tpu_torch.scripts.bench_ladder [--device cuda|cpu] \
        [--record]

The port's counterpart of the JAX package's ``scripts/bench_ladder.py``
(LADDER selects entries; default all, in this order):

  spec100k  - serving latents/s over a host-packed gallery at the cap
              shape (Lm = Rm = 128, Lt = Rt = 1000), codes-resident, int8
              minutiae (SPEC_RERANK=0: the dense path, as spec100k_dense).
  spec500k  - the screen alone over SPEC500K_GALLERY codes-resident
              entries at the 448 shape; the card's memory in use and at
              its peak, the gallery's bytes per entry.
  serve400k - full serving over the same gallery size with 4 planted
              mates; their serving ranks.
  rolled1k  - every rolled print as a query (its minutiae template,
              T = 1, and its decoded texture) against a 1,000-entry
              rolled gallery; self-match hits.
  mated1k   - impression B (descriptor noise, 3 px jitter, re-encoded
              texture) of 64 fingers against their A impressions among
              1,000: rank-1, CMC@5.
  mated_cmc - the same, dense, at MATED_CMC_GALLERIES sizes and
              MATED_CMC_NOISES strengths: rank-1, CMC@5, CMC@24.
  scale     - weak scaling of the sharded match (1,024 entries a rank) at
              world sizes 1, 2, 4 and 8: gloo processes on the CPU, one
              torch thread each. A CPU ratio, not a number of the card:
              on a host with one card NCCL puts no two ranks on it.

Environment (the JAX script's names and defaults): LADDER; SPEC_GALLERY
(100000), SPEC_LATENTS (4), SPEC_BLOCK (256), SPEC_RERANK (512),
SPEC_PRESCREEN (256); SPEC500K_GALLERY (400000); SERVE400K_GALLERY
(400000); ROLLED_GALLERY (1000); MATED_GALLERY (1000), MATED_QUERIES (64),
MATED_NOISE (0.35); MATED_CMC_GALLERIES (10000,100000), MATED_CMC_NOISES
(0.35,0.6,0.9,1.2), MATED_CMC_QUERIES (64). ``--record`` updates
``results/torch/bench_ladder.json`` after each entry (entries already
there and not rerun stay).
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Sequence

import numpy as np
import torch

from ..matcher.engine import MatchEngine
from ..ops.pq import pq_decode
from ..templates.packing import PackedLatent, pack_gallery
from ..utils.synthetic import (DES_NORM, device_synthetic_gallery,
                               make_latent_template, make_rolled_template,
                               plant_gallery_entries,
                               synthetic_packed_gallery)
from . import measure as M

LADDER = ("spec100k", "spec500k", "serve400k", "rolled1k", "mated1k",
          "mated_cmc", "scale")
BF16 = torch.bfloat16
SCALE_SIZES = (1, 2, 4, 8)
SCALE_PER_RANK = 1024


def _sync_sum(t: torch.Tensor) -> float:
    """A readback of the first scores (it waits for the device)."""
    return float(t[..., :4].float().sum())


def memory_record(device) -> dict:
    """The allocator's bytes in use now and at the peak, and the card's
    total; empty on the CPU."""
    if torch.device(device).type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {k: stats[k] for k in ("allocated_bytes.all.current",
                                  "allocated_bytes.all.peak")} | {
        "total_bytes": torch.cuda.get_device_properties(
            torch.device(device)).total_memory}


def bench_spec100k(results, cb, device, G=100000, NL=4, block=256,
                   rerank=512, prescreen=256, shapes=M.SHAPES_CAP):
    RM, RT, LM, LT = shapes
    engine = MatchEngine(cb, block_size=block, compute_dtype=BF16,
                         codes_resident=True, minu_int8=True, device=device)
    rng = np.random.default_rng(3)
    packed = synthetic_packed_gallery(rng, cb, G=G, n_minu=RM, n_tex=RT)
    gal = engine.load_gallery(packed)
    del packed
    lats = [M.pack(make_latent_template(rng, n_minu=LM, n_tex=LT), LM, LT)
            for _ in range(2 * NL)]

    def run(batch):
        if rerank:
            return float(engine.match_scores_batch_reranked(
                batch, gal, m=rerank, prescreen_k=prescreen,
                prescreen_lt=128, prescreen_t=1)[1][0, :4].sum())
        return _sync_sum(engine.match_scores_batch(batch, gal))

    run(lats[:NL])
    dt = M.clock(lambda: run(lats[NL:]), engine.device)[1]
    mode = f"rerank m={rerank}" if rerank else "dense exact"
    key = "spec100k" if rerank else "spec100k_dense"
    results[key] = {
        "metric": f"latents/s vs {G} gallery at cap shapes Lm={LM},Lt={LT},"
                  f"Rm={RM},Rt={RT} ({mode})",
        "latents_per_s": NL / dt, "seconds": dt, "n_latents": NL,
        "mode": mode, "block": block, **M.header(engine.device)}
    M.emit({key: results[key]})


def bench_spec500k(results, cb, device, G=400000, block=512,
                   shapes=M.SHAPES_448):
    RM, RT, LM, LT = shapes
    engine = MatchEngine(cb, block_size=block, compute_dtype=BF16,
                         codes_resident=True, minu_int8=True, device=device)
    if engine.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(engine.device)
    gal = device_synthetic_gallery(engine, G, n_minu=RM, n_tex=RT,
                                   codes_resident=True, seed=17, chunk=1024)
    rng = np.random.default_rng(19)
    lats = [M.pack(make_latent_template(rng, n_minu=LM, n_tex=LT), LM, LT)
            for _ in range(8)]

    def run(batch):
        return _sync_sum(engine.screen_scores_batch(batch, gal)[0])

    run(lats[:4])
    dt = M.clock(lambda: run(lats[4:]), engine.device)[1]
    per_entry = M.gallery_bytes_per_entry(gal)
    results["spec500k_codes"] = {
        "metric": f"screen-phase latents/s vs {G} codes-resident gallery "
                  f"(Rm={RM},Rt={RT}; u8 PQ codes on the card, decoded in "
                  f"the screen kernel)",
        "latents_per_s": 4 / dt, "seconds": dt,
        "memory": memory_record(engine.device),
        "gallery_bytes": per_entry * gal.size,
        "gallery_bytes_per_entry": per_entry,
        "capacity_note": (
            "bytes per entry from the tensors the gallery holds: int8 "
            "minutiae descriptors [Rm, 96], u8 codes [Rt, 16], f32 "
            "coordinate packs [R, 4] and texture norms [Rt], int32 counts"),
        **M.header(engine.device)}
    M.emit({"spec500k_codes": results["spec500k_codes"]})


def serving_ranks(idx, exact, positions) -> list:
    """Each planted entry's rank in its latent's serving list (-1: not
    kept)."""
    out = []
    for i, pos in enumerate(positions):
        srt = np.argsort(-np.asarray(exact[i]), kind="stable")
        hit = np.where(np.asarray(idx[i])[srt] == pos)[0]
        out.append(int(hit[0]) + 1 if len(hit) else -1)
    return out


def bench_serve400k(results, cb, device, G=400000, block=512,
                    shapes=M.SHAPES_448):
    RM, RT, LM, LT = shapes
    engine = MatchEngine(cb, block_size=block, compute_dtype=BF16,
                         codes_resident=True, minu_int8=True, device=device)
    gal = device_synthetic_gallery(engine, G, n_minu=RM, n_tex=RT,
                                   codes_resident=True, seed=17, chunk=1024)
    rng = np.random.default_rng(19)
    lats_t = [make_latent_template(rng, n_minu=LM, n_tex=LT)
              for _ in range(8)]
    lats = [M.pack(t, LM, LT) for t in lats_t]
    mates = [make_rolled_template(rng, n_minu=RM, n_tex=RT,
                                  mated_latent=lats_t[i], codebook=cb)
             for i in range(4)]
    mate_pos = [int(p) for p in
                np.random.default_rng(7).choice(G, 4, replace=False)]
    plant_gallery_entries(gal, engine, pack_gallery(
        mates, cb, names=[f"m{i}" for i in range(4)], minu_cap=RM,
        tex_cap=RT), mate_pos)
    kw = dict(m=256, prescreen_k=256, prescreen_lt=64, prescreen_t=1)
    engine.match_scores_batch_reranked(lats, gal, **kw)
    (idx, exact, _, _), dt = M.clock(
        lambda: engine.match_scores_batch_reranked(lats, gal, **kw),
        engine.device)
    results["serve400k"] = {
        "metric": f"FULL serving (screen+rerank m=256, truncated prescreen "
                  f"256/lt64/t1) latents/s vs {G} codes-resident gallery "
                  f"(Rm={RM},Rt={RT})",
        "latents_per_s": 8 / dt, "seconds": dt,
        "planted_mate_ranks_serving": serving_ranks(idx, exact, mate_pos),
        "memory": memory_record(engine.device), **M.header(engine.device)}
    M.emit({"serve400k": results["serve400k"]})


def mated_queries(packed, tdes0, noise: float, rng, NQ: int) -> list:
    """Impression B of the first NQ entries: minutiae descriptors with
    Gaussian noise renormalized to DES_NORM, coordinates jittered 3 px,
    the decoded texture ``tdes0[i]`` with noise renormalized the same way;
    drawn in the JAX script's order (:182-202, :335-356)."""
    queries = []
    for i in range(NQ):
        md = packed.minu_des[i] + noise * rng.standard_normal(
            packed.minu_des.shape[1:]).astype(np.float32)
        md /= np.linalg.norm(md, axis=1, keepdims=True) + 1e-7
        md *= DES_NORM
        mxy = packed.minu_xy[i] + rng.normal(0, 3.0,
                                             packed.minu_xy.shape[1:])
        tdes = tdes0[i] + noise * rng.standard_normal(
            tdes0[i].shape).astype(np.float32)
        tdes *= DES_NORM / (np.linalg.norm(tdes, axis=1, keepdims=True)
                            + 1e-7)
        queries.append(PackedLatent(
            minu_des=md[None].astype(np.float32),
            minu_xy=mxy[None].astype(np.float32),
            minu_ori=packed.minu_ori[i][None], minu_n=packed.minu_n[i][None],
            tex_des=tdes, tex_xy=packed.tex_xy[i],
            tex_ori=packed.tex_ori[i], tex_n=packed.tex_n[i]))
    return queries


def mated_ranks(engine, queries, gal, G: int) -> np.ndarray:
    """Query i's mate is entry i: its dense rank, batches of 8."""
    ranks = []
    for i0 in range(0, len(queries), 8):
        s = engine.match_scores_batch(queries[i0:i0 + 8], gal) \
            .float().cpu().numpy()
        for k in range(s.shape[0]):
            order = np.argsort(-s[k, :G], kind="stable")
            ranks.append(int(np.where(order == i0 + k)[0][0]) + 1)
    return np.asarray(ranks)


def decoded(packed, cb, NQ: int) -> list:
    return [pq_decode(packed.tex_codes[i], cb).astype(np.float32)
            for i in range(NQ)]


def bench_mated1k(results, cb, device, G=1000, NQ=64, noise=0.35,
                  block=256, shapes=M.SHAPES_448):
    RM, RT = shapes[:2]
    rng = np.random.default_rng(29)
    packed = synthetic_packed_gallery(rng, cb, G=G, n_minu=RM, n_tex=RT)
    engine = MatchEngine(cb, block_size=block, compute_dtype=BF16,
                         tex_int8=True, device=device)
    gal = engine.load_gallery(packed)
    queries = mated_queries(packed, decoded(packed, cb, NQ), noise, rng, NQ)
    ranks, dt = M.clock(lambda: mated_ranks(engine, queries, gal, G),
                        engine.device)
    results["mated1k"] = {
        "metric": f"mated-pair retrieval: impression B vs {G} A-enrolled "
                  f"gallery (descriptor noise {noise}, 3 px jitter)",
        "queries": NQ, "rank1": float((ranks == 1).mean()),
        "cmc5": float((ranks <= 5).mean()), "mean_rank": float(ranks.mean()),
        "queries_per_s": NQ / dt, **M.header(engine.device)}
    M.emit({"mated1k": results["mated1k"]})


def cmc_point(noise: float, ranks: np.ndarray, dt: float) -> dict:
    return {"noise": noise, "rank1": float((ranks == 1).mean()),
            "cmc5": float((ranks <= 5).mean()),
            "cmc24": float((ranks <= 24).mean()),
            "mean_rank": float(ranks.mean()), "queries_per_s": len(ranks) / dt}


def cmc_curve(engine, gal, packed, tdes0, G: int, noises, NQ: int) -> list:
    """(noise, ranks, seconds) per noise, queries from default_rng(101)."""
    out = []
    for noise in noises:
        queries = mated_queries(packed, tdes0, noise,
                                np.random.default_rng(101), NQ)
        ranks, dt = M.clock(lambda: mated_ranks(engine, queries, gal, G),
                            engine.device)
        out.append((noise, ranks, dt))
    return out


def bench_mated_cmc(results, cb, device, galleries=(10000, 100000),
                    noises=(0.35, 0.6, 0.9, 1.2), NQ=64, block=512,
                    shapes=M.SHAPES_448):
    RM, RT = shapes[:2]
    engine = MatchEngine(cb, block_size=block, compute_dtype=BF16,
                         tex_int8=True, device=device)
    for G in galleries:
        rng = np.random.default_rng(29)
        packed = synthetic_packed_gallery(rng, cb, G=NQ, n_minu=RM, n_tex=RT)
        gal = device_synthetic_gallery(engine, G, n_minu=RM, n_tex=RT,
                                       seed=31, chunk=1024)
        plant_gallery_entries(gal, engine, packed, list(range(NQ)))
        entry = {"metric": f"mated-pair dense-exact retrieval vs {G} "
                           f"A-enrolled gallery (impression-B queries, 3 px "
                           f"jitter, noise swept)",
                 "queries": NQ, "curve": [], **M.header(engine.device)}
        for noise, ranks, dt in cmc_curve(engine, gal, packed,
                                          decoded(packed, cb, NQ), G,
                                          noises, NQ):
            entry["curve"].append(cmc_point(noise, ranks, dt))
            M.emit({f"mated{G}": entry["curve"][-1]})
        results[f"mated{G}"] = entry
        del gal
        if engine.device.type == "cuda":
            torch.cuda.empty_cache()


def rolled_queries(engine, packed, n: int) -> list:
    """The first n rolled prints as queries: their minutiae template
    (T = 1) and their texture decoded as the engine stores it (int8
    predecoded texture dequantized by its scale)."""
    dec = engine.predecode(torch.as_tensor(
        packed.tex_codes[:n], device=engine.device)).float()
    if engine.tex_int8:
        dec = dec * engine.tex_scale
    dec = dec.cpu().numpy()
    return [PackedLatent(
        minu_des=packed.minu_des[i][None].astype(np.float32),
        minu_xy=packed.minu_xy[i][None], minu_ori=packed.minu_ori[i][None],
        minu_n=packed.minu_n[i][None], tex_des=dec[i],
        tex_xy=packed.tex_xy[i], tex_ori=packed.tex_ori[i],
        tex_n=packed.tex_n[i]) for i in range(n)]


def bench_rolled1k(results, cb, device, G=1000, block=256,
                   shapes=M.SHAPES_448):
    RM, RT = shapes[:2]
    engine = MatchEngine(cb, block_size=block, compute_dtype=BF16,
                         tex_int8=True, device=device)
    rng = np.random.default_rng(5)
    packed = synthetic_packed_gallery(rng, cb, G=G, n_minu=RM, n_tex=RT)
    gal = engine.load_gallery(packed)
    queries = rolled_queries(engine, packed, 8)
    _sync_sum(engine.match_scores_batch(queries[:4], gal))
    s, dt = M.clock(lambda: engine.match_scores_batch(queries[4:], gal)
                    .float().cpu().numpy(), engine.device)
    hits = sum(int(np.argmax(s[k, :G])) == 4 + k for k in range(4))
    results["rolled1k"] = {
        "metric": f"rolled queries/s vs {G} rolled gallery (symmetric N:N)",
        "queries_per_s": 4 / dt, "pairs_per_s": 4 * G / dt,
        "self_rank1_hits": f"{hits}/4", **M.header(engine.device)}
    M.emit({"rolled1k": results["rolled1k"]})


def scale_inputs(cb, G: int):
    """The weak-scaling gallery (G entries, 32 / 64 rows) and latent,
    drawn from default_rng(9) as the JAX entry draws them."""
    rng = np.random.default_rng(9)
    packed = synthetic_packed_gallery(rng, cb, G=G, n_minu=32, n_tex=64)
    lat = M.pack(make_latent_template(rng, n_minu=24, n_tex=48), 32, 64)
    return packed, lat


def _scale_rank(rank: int, cb, sizes, per_rank: int, root: str) -> None:
    """One process of the weak-scaling spawn: for each world size n it
    belongs to (rank < n), join that size's gloo group, shard n x per_rank
    entries, match once to warm up and 3 times timed. Rank 0 writes its
    seconds per match and the scores of the first shard."""
    import dataclasses

    import torch.distributed as dist

    from ..parallel import make_mesh, match_sharded, shard_gallery
    torch.set_num_threads(1)
    packed_full, lat = scale_inputs(cb, max(sizes) * per_rank)
    out = {}
    for n in sizes:
        if rank >= n:
            continue
        G = n * per_rank
        packed = dataclasses.replace(
            packed_full, names=packed_full.names[:G],
            **{f.name: getattr(packed_full, f.name)[:G]
               for f in dataclasses.fields(packed_full) if f.name != "names"})
        dist.init_process_group("gloo", store=dist.FileStore(
            os.path.join(root, f"store{n}"), n), rank=rank, world_size=n)
        try:
            mesh = make_mesh(device_type="cpu")
            engine = MatchEngine(cb, block_size=32, device="cpu")
            gal = shard_gallery(engine, packed, mesh)
            s = match_sharded(engine, lat, gal, mesh)
            t0 = time.perf_counter()
            for _ in range(3):
                s = match_sharded(engine, lat, gal, mesh)
            out[f"seconds/{n}"] = (time.perf_counter() - t0) / 3
            out[f"scores/{n}"] = s[:per_rank].numpy()
        finally:
            dist.destroy_process_group()
    if rank == 0:
        np.savez(os.path.join(root, "rank0.npz"), **out)


def bench_scale(results, cb, device=None, sizes: Sequence[int] = SCALE_SIZES,
                per_rank: int = SCALE_PER_RANK):
    """Weak scaling of the sharded match on the CPU: one spawn of
    max(sizes) gloo processes (``device`` is not used: the entry asks for
    the CPU)."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as root:
        mp.start_processes(_scale_rank, args=(cb, tuple(sizes), per_rank,
                                              root),
                           nprocs=max(sizes), join=True,
                           start_method="spawn")
        data = dict(np.load(os.path.join(root, "rank0.npz")))
    times = {n: float(data[f"seconds/{n}"]) for n in sizes}
    first = data[f"scores/{sizes[0]}"]
    results["scale_gloo_cpu"] = {
        "metric": f"sharded-match WEAK-scaling efficiency ({per_rank}-entry "
                  f"shard per rank), gloo processes on the CPU",
        "seconds_per_match": {str(n): t for n, t in times.items()},
        "weak_efficiency_vs_1": {str(n): times[sizes[0]] / times[n]
                                 for n in sizes},
        "first_shard_scores_equal": all(
            np.array_equal(first, data[f"scores/{n}"]) for n in sizes),
        "host_cpus": os.cpu_count(),
        "caveat": (
            "a CPU ratio, not a number of the card: one process per rank "
            "with one torch thread, on the host's cores, over gloo; on a "
            "host with one card NCCL puts no two ranks on it"),
        **M.header("cpu" if device is None else device),
        "measured_on": "cpu (gloo)"}
    M.emit({"scale_gloo_cpu": results["scale_gloo_cpu"]})


ENTRIES = {"spec100k": bench_spec100k, "spec500k": bench_spec500k,
           "serve400k": bench_serve400k, "rolled1k": bench_rolled1k,
           "mated1k": bench_mated1k, "mated_cmc": bench_mated_cmc,
           "scale": bench_scale}


def env_sizes(name: str) -> dict:
    """An entry's sizes from the environment (the JAX script's names and
    defaults)."""
    e, env = M.env_int, os.environ.get
    return {
        "spec100k": lambda: dict(
            G=e("SPEC_GALLERY", 100000), NL=e("SPEC_LATENTS", 4),
            block=e("SPEC_BLOCK", 256), rerank=e("SPEC_RERANK", 512),
            prescreen=e("SPEC_PRESCREEN", 256)),
        "spec500k": lambda: dict(G=e("SPEC500K_GALLERY", 400000)),
        "serve400k": lambda: dict(G=e("SERVE400K_GALLERY", 400000)),
        "rolled1k": lambda: dict(G=e("ROLLED_GALLERY", 1000)),
        "mated1k": lambda: dict(G=e("MATED_GALLERY", 1000),
                                NQ=e("MATED_QUERIES", 64),
                                noise=float(env("MATED_NOISE", "0.35"))),
        "mated_cmc": lambda: dict(
            galleries=[int(x) for x in env("MATED_CMC_GALLERIES",
                                           "10000,100000").split(",")],
            noises=[float(x) for x in env("MATED_CMC_NOISES",
                                          "0.35,0.6,0.9,1.2").split(",")],
            NQ=e("MATED_CMC_QUERIES", 64)),
        "scale": dict,
    }[name]()


def main(argv=None) -> int:
    args = M.parser(__doc__).parse_args(argv)
    dev = M.device_of(args.device)
    which = os.environ.get("LADDER", ",".join(LADDER)).split(",")
    unknown = set(which) - set(ENTRIES)
    if unknown:
        raise ValueError(f"LADDER: unknown entries {sorted(unknown)}")
    cb = M.codebook()
    path = M.RESULTS / "bench_ladder.json"
    results = json.loads(path.read_text()) \
        if args.record and path.exists() else {}
    for name in which:
        ENTRIES[name](results, cb, dev, **env_sizes(name))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if args.record:
            M.write_record("bench_ladder", results)
    if args.record:
        print("wrote", path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
