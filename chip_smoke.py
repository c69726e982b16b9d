#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the matcher on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero; there is no CPU fallback):
  0. setup: card name and power limit, a faulthandler watchdog, the kernel
     build (one nvcc per source, started together, and a link) and its
     seconds;
  1. each of the seven kernels against its plain PyTorch version on the
     card, on one 64-entry gallery block with 2 latents at full widths
     (Lm 64, Rm 96, Lt 448, Rt 448, D 96, T 3): maximum difference against
     the stated tolerance, kernel / plain / library times, bound; the
     codes kernels must equal their predecoded twins bit for bit;
  2. the CLI: a 64-file synthetic .dat gallery with one planted mate,
     ``cli.main(["match", ...])`` dense and with ``--rerank 16``, the mate
     must be rank 1 in the CSV;
  3. the dense engine on a 16,384-entry gallery built on the card from a
     seed, 4 latents with planted mates through ``match_scores_batch``:
     every mate at rank 1, every dense kernel launched; then the three
     dense kernels held and timed as this path launches them (4 latents x
     64 entries), on a block without a mate and on a mate's block;
  4. serving on phase 3's gallery and latents: ``match_scores_batch_reranked``
     with m 512, without and with prescreen 256 / 64 / 1: mates at rank 1,
     exact scores equal to phase 3's dense scores at the kept indices, the
     screen above the exact score (no prescreen), NaN margins (prescreen);
  5. serving at the JAX bench's configuration: 100,000 entries built on the
     card from one seed in both layouts (predecoded f32 and codes-resident
     uint8, from the same codes), 8 latents with planted mates, m 512,
     prescreen 256 / 64 / 1: mates at rank 1, the two layouts' results
     equal, first-call and steady seconds, a profiler breakdown; then the
     serving kernels held and timed as this path launches them: the screens
     on its 16,384-entry chunks and its tail chunk with the truncated
     latents (plain versions a slice of entries at a time), the codes ADC
     row max on one latent's first rerank block.
The kernels' JSON record takes each kernel's launches from the path that
runs it (phase 3, or phase 5 in its layout) and its numbers from the same
path's shapes and data: means per launch over one call's chunks (the
screens) or over its blocks with and without a mate (the dense kernels),
so that ms x launches is the call's time in that kernel. The last two lines
of standard output are that record and {"ok": true, "device": {...}}. The
script imports no JAX.
"""
from __future__ import annotations

import faulthandler
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

WATCHDOG_S = 300             # a hang ends as a traceback and a nonzero exit
GALLERY_G = 16384            # the profile gallery size (docs/PERF.md:5-8)
N_LATENTS = 4
SERVE_G = 100000             # the JAX bench's serving configuration
SERVE_LATENTS = 8            # (bench.py:10-13,120-132)
SERVE = dict(m=512, prescreen_k=256, prescreen_lt=64, prescreen_t=1)
PEAK_F32_FLOPS = 67e12       # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
TOL = dict(rtol=1e-5, atol=1e-4)
HERE = os.path.dirname(os.path.abspath(__file__))
# kernel -> (source in csrc/, line of the TPU kernel in pallas_kernels.py)
KERNEL_META = {
    "adc_rowmax": ("adc_rowmax.cu", 1489),
    "texture_match": ("texture_match.cu", 1031),
    "minutiae_match": ("minutiae_match.cu", 878),
    "minu_screen": ("minu_screen.cu", 1312),
    "adc_screen": ("adc_screen.cu", 1106),
    "adc_screen_codes": ("adc_screen.cu", 1213),
    "adc_rowmax_codes": ("adc_rowmax.cu", 1434),
}
DENSE_KERNELS = ("adc_rowmax", "texture_match", "minutiae_match")


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def filter_ops(k_valid, n_stage1, dist_iters: int) -> float:
    """Operations the graph filter needs on this data, whatever the kernel
    recomputes: per pair of valid slots ~20 flops to build H1 once, a
    multiply-add per power iteration and ~6 for the blocker test; per pair
    of stage-1 survivors ~40 for the angle test, 10 for its 5 power
    iterations and ~6 for the blocker test."""
    k = k_valid.double()
    n = n_stage1.double()
    return float((k * k * (20.0 + 2.0 * dist_iters + 6.0)
                  + n * n * (40.0 + 10.0 + 6.0)).sum())


def bound(ops: float, nbytes: float):
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def make_latents(rng, n: int, cb):
    from msu_latentafis_tpu_torch.templates import pack_gallery, pack_latent
    from msu_latentafis_tpu_torch.utils.synthetic import (
        make_latent_template, make_rolled_template)
    lats = [make_latent_template(rng, n_minu=64, n_tex=448) for _ in range(n)]
    mates = [make_rolled_template(rng, n_minu=96, n_tex=448,
                                  mated_latent=l, codebook=cb) for l in lats]
    packed = [pack_latent(l, minu_cap=64, tex_cap=448, quantize_tex_xy=False)
              for l in lats]
    pmates = pack_gallery(mates, cb, names=[f"mate{i}" for i in range(n)],
                          minu_cap=96, tex_cap=448)
    return packed, pmates


ENTRY_KEYS = ("rdes", "rvalid", "rsq", "dec", "codes")   # gallery-entry axis


def tensor_bytes(args: dict) -> int:
    import torch
    return nbytes(*(v for v in args.values() if isinstance(v, torch.Tensor)))


def by_entries(fn, args: dict, step: int):
    """fn(**args) computed ``step`` gallery entries at a time (every entry
    is independent), the [.., B] outputs joined again."""
    import torch
    B = args["rvalid"].shape[0]

    def run():
        return torch.cat([fn(**{k: v[a:a + step] if k in ENTRY_KEYS else v
                                for k, v in args.items()})
                          for a in range(0, B, step)], dim=-1)
    return run


def minu_library(ldes, lvalid, rdes, rvalid):
    import torch
    g = torch.matmul((ldes * lvalid[..., None])[:, None],
                     (rdes * rvalid[..., None]).transpose(1, 2)[None])
    return torch.minimum(g.amax(-1).clamp(min=0.0).sum(-1),
                         g.amax(-2).clamp(min=0.0).sum(-1))


def screen_library(x, lsq, lvalid, rsq, rvalid, dec=None, codes=None,
                   codebook=None):
    import torch
    from msu_latentafis_tpu_torch.matcher.kernels import ops
    from msu_latentafis_tpu_torch.matcher.texture_match import decode_pq
    if dec is None:
        dec = decode_pq(codes, codebook)
    mask = torch.where(rvalid > 0, 0.0, ops.SCREEN_SENT)
    v = torch.matmul(x[:, None], dec.transpose(1, 2)[None]) \
        + (-(0.5 * rsq) + mask)[None, :, None, :]
    return ((2.0 * v.amax(-1) + (6.0 - lsq)[:, None, :]).clamp(min=0.0)
            * lvalid[:, None, :]).sum(-1)


def rowmax_library(x, lsq, rsq, rvalid, dec=None, codes=None, codebook=None):
    import torch
    from msu_latentafis_tpu_torch.matcher.texture_match import decode_pq
    if dec is None:
        dec = decode_pq(codes, codebook)
    simi = 2.0 * torch.matmul(x[:, None], dec.transpose(1, 2)[None]) + (
        (6.0 - lsq)[:, None, :, None] - rsq[None, :, None, :])
    return (simi + (rvalid[None, :, None, :] - 1.0) * 1e30).max(-1)


def hold(fn, plain, library, reps: int, twin=None) -> dict:
    """One kernel launch held against its plain version on the same inputs
    (first output within TOL, the others equal) and, for a codes kernel,
    against its predecoded twin bit for bit; kernel, plain and library
    times. The caller adds the bound."""
    import torch
    got = fn()
    want = plain()
    torch.cuda.synchronize()
    outs = got if isinstance(got, tuple) else (got,)
    wants = want if isinstance(want, tuple) else (want,)
    ok = torch.allclose(outs[0], wants[0], **TOL) and all(
        torch.equal(a, b) for a, b in zip(outs[1:], wants[1:]))
    if twin is not None:
        tw = twin()
        tw = tw if isinstance(tw, tuple) else (tw,)
        ok = ok and all(torch.equal(a, b) for a, b in zip(outs, tw))
    return dict(max_abs_err=float((outs[0] - wants[0]).abs().max()),
                ok=bool(ok), out_bytes=nbytes(*outs), ms=cuda_ms(fn, reps),
                plain_ms=cuda_ms(plain, 1, warm=False),
                library_ms=None if library is None else cuda_ms(library, reps))


def dense_records(minu, adc, tex, reps: int) -> dict:
    """The dense path's three kernels on one block's inputs."""
    from msu_latentafis_tpu_torch.matcher.kernels import ops
    NL, Lt, D = adc["x"].shape
    B, Rt, _ = adc["dec"].shape
    r = hold(lambda: ops.adc_rowmax(**adc),
             lambda: ops.adc_rowmax_plain(**adc),
             lambda: rowmax_library(**adc), reps)
    r["library_err"] = float((rowmax_library(**adc).values
                              - ops.adc_rowmax_plain(**adc)[0]).abs().max())
    r["bound"] = bound(2.0 * NL * B * Lt * Rt * D,
                       tensor_bytes(adc) + r["out_bytes"])
    rec = {"adc_rowmax": r}
    best, bestj = ops.adc_rowmax(**adc)

    stats = {}
    r = rec["texture_match"] = hold(
        lambda: ops.texture_match(best, bestj, **tex),
        lambda: ops.texture_match_plain(best, bestj, stats=stats, **tex),
        None, reps)
    r["bound"] = bound(
        30.0 * best.numel() + filter_ops(stats["k_valid"], stats["n_stage1"],
                                         tex["dist_iters"]),
        nbytes(best, bestj) + tensor_bytes(tex) + r["out_bytes"])

    NT, P, _ = minu["ldes"].shape
    R = minu["rdes"].shape[1]
    r = rec["minutiae_match"] = hold(
        lambda: ops.minutiae_match(**minu),
        lambda: ops.minutiae_match_plain(stats=stats, **minu), None, reps)
    pre_ops = NT * B * (2.0 * P * R * D + 5.0 * P * R
                        + 2.0 * minu["row_cap"] * P * R
                        + 26.0 * minu["row_cap"] * P)
    r["bound"] = bound(pre_ops + filter_ops(stats["k_valid"],
                                            stats["n_stage1"],
                                            minu["dist_iters"]),
                       tensor_bytes(minu) + r["out_bytes"])
    return rec


def screen_records(mscr, adc, adc_codes, step: int, reps: int) -> dict:
    """The three screen kernels on one launch's inputs (``engine.screen_args``
    in both layouts); plain versions and library calls ``step`` entries at
    a time; adc_screen_codes equal to adc_screen bit for bit."""
    from msu_latentafis_tpu_torch.matcher.kernels import ops
    NT, P, D = mscr["ldes"].shape
    B, R, _ = mscr["rdes"].shape
    r = hold(lambda: ops.minu_screen(**mscr),
             by_entries(ops.minu_screen_plain, mscr, step),
             by_entries(minu_library, mscr, step), reps)
    r["bound"] = bound(2.0 * NT * B * P * R * D,
                       tensor_bytes(mscr) + r["out_bytes"])
    rec = {"minu_screen": r}
    NL, Lt, _ = adc["x"].shape
    Rt = adc["rsq"].shape[1]
    for name, args, twin in (
            ("adc_screen", adc, None),
            ("adc_screen_codes", adc_codes, lambda: ops.adc_screen(**adc))):
        r = rec[name] = hold(
            lambda: getattr(ops, name)(**args),
            by_entries(getattr(ops, name + "_plain"), args, step),
            by_entries(screen_library, args, step), reps, twin)
        r["bound"] = bound(2.0 * NL * B * Lt * Rt * D,
                           tensor_bytes(args) + r["out_bytes"])
    return rec


def rowmax_codes_record(adc_codes, adc, reps: int) -> dict:
    """adc_rowmax_codes on one block, equal to adc_rowmax bit for bit."""
    from msu_latentafis_tpu_torch.matcher.kernels import ops
    NL, Lt, D = adc["x"].shape
    B, Rt, _ = adc["dec"].shape
    r = hold(lambda: ops.adc_rowmax_codes(**adc_codes),
             lambda: ops.adc_rowmax_codes_plain(**adc_codes),
             lambda: rowmax_library(**adc_codes), reps,
             twin=lambda: ops.adc_rowmax(**adc))
    r["bound"] = bound(2.0 * NL * B * Lt * Rt * D,
                       tensor_bytes(adc_codes) + r["out_bytes"])
    return r


def per_launch(parts) -> dict:
    """Per-launch means of records [(record, launches of that shape)] over
    the launches of one pass, so ms x launches is the pass's time."""
    n = sum(w for _, w in parts)

    def mean(key):
        if parts[0][0][key] is None:
            return None
        return sum(r[key] * w for r, w in parts) / n
    return dict(max_abs_err=max(r["max_abs_err"] for r, _ in parts),
                ok=all(r["ok"] for r, _ in parts), ms=mean("ms"),
                plain_ms=mean("plain_ms"), library_ms=mean("library_ms"),
                bound=(sum(r["bound"][0] * w for r, w in parts) / n,
                       max(parts, key=lambda p: p[1])[0]["bound"][1]))


def check_records(label: str, rec: dict) -> None:
    for name, r in rec.items():
        log(f"[{label}] {name}: max_abs_err {r['max_abs_err']:.3e} "
            f"(tol rtol {TOL['rtol']} atol {TOL['atol']}) ok={r['ok']} "
            f"kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.2f} "
            f"library_ms {r['library_ms']} bound_ms {r['bound'][0]:.4f} "
            f"({r['bound'][1]})")
    bad = [n for n, r in rec.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"{label}: kernels disagree with their plain "
                             f"versions or twins: {bad}")


def phase_kernels(engine, cb, rng):
    """Each kernel vs its plain version on one 64-entry block, 2 latents,
    full widths; the codes kernels vs their predecoded twins."""
    from msu_latentafis_tpu_torch.utils.synthetic import (
        device_synthetic_gallery, plant_gallery_entries)
    lats, mates = make_latents(rng, 2, cb)
    pre, codes = device_synthetic_gallery(engine, 64, seed=1,
                                          both_layouts=True)
    for g in (pre, codes):
        plant_gallery_entries(g, engine, mates, [0, 1])
    L = engine.latent_side(engine.latent_batch(lats))
    minu, adc, tex = engine.block_args(L, pre, 0)
    rec = dense_records(minu, adc, tex, reps=20)
    rows = slice(0, 64)
    mscr, sadc = engine.screen_args(L, pre, rows)
    sadc_codes = engine.screen_args(L, codes, rows)[1]
    rec.update(screen_records(mscr, sadc, sadc_codes, step=64, reps=20))
    rec["adc_rowmax_codes"] = rowmax_codes_record(
        engine.block_args(L, codes, 0)[1], adc, reps=20)
    check_records("kernels, one block", rec)
    log(f"[kernels] adc library (matmul + max) vs plain max diff "
        f"{rec['adc_rowmax']['library_err']:.3e}")


def phase_cli(cb, rng, workdir):
    """64 rolled .dat files (one planted mate) through cli.main."""
    import numpy as np
    from msu_latentafis_tpu_torch import cli
    from msu_latentafis_tpu_torch.matcher.kernels import ops
    from msu_latentafis_tpu_torch.templates import (
        write_codebook, write_final_latent_template,
        write_final_rolled_pq_template)
    from msu_latentafis_tpu_torch.utils.synthetic import (
        make_latent_template, make_rolled_template)

    def to_pixels(t):           # writers quantize texture coords (x-24)/16
        for tt in t.texture_template:
            m = np.asarray(tt.minutiae, np.float64)
            m[:, :2] = m[:, :2] * 16.0 + 24.0
            tt.minutiae = m
        return t

    gdir = os.path.join(workdir, "gallery")
    os.makedirs(gdir)
    cbf = os.path.join(workdir, "codebook.dat")
    write_codebook(cbf, cb)
    lat = make_latent_template(rng, n_minu=48, n_tex=300)
    latf = os.path.join(workdir, "latent0.dat")
    mate_idx = 37
    for j in range(64):
        mated = j == mate_idx
        r = make_rolled_template(
            rng, n_minu=int(rng.integers(50, 97)),
            n_tex=int(rng.integers(300, 449)),
            mated_latent=lat if mated else None,
            codebook=cb if mated else None)
        write_final_rolled_pq_template(os.path.join(gdir, f"r{j:03d}.dat"),
                                       to_pixels(r))
    write_final_latent_template(latf, to_pixels(lat))
    for label, extra, kernels in (
            ("dense", [], ("minutiae_match", "adc_rowmax", "texture_match")),
            ("rerank 16", ["--rerank", "16"],
             ("minu_screen", "adc_screen", "minutiae_match", "adc_rowmax",
              "texture_match"))):
        sdir = os.path.join(workdir, "scores_" + label.replace(" ", "_"))
        ops.reset_launch_counts()
        rc = cli.main(["match", "-l", latf, "-g", gdir, "-c", cbf, "-s", sdir,
                       *extra])
        counts = ops.launch_counts()
        if rc != 0:
            raise AssertionError(f"cli ({label}) returned {rc}")
        with open(os.path.join(sdir, "latent0.csv")) as f:
            lines = f.read().splitlines()
        if lines[0] != "filename,score" or not lines[1].startswith(
                f"1r{mate_idx:03d},"):
            raise AssertionError(f"CLI ({label}) rank list wrong: {lines[:3]}")
        if min(counts[k] for k in kernels) <= 0:
            raise AssertionError(f"CLI ({label}) skipped a kernel: {counts}")
        log(f"[cli] {label}: mate r{mate_idx:03d} at rank 1 ({lines[1]}), "
            f"{len(lines) - 1} ranks written, launches {counts}")


def phase_engine(engine, cb, rng, card):
    """Dense engine on a 16,384-entry gallery, 4 latents, planted mates;
    the three dense kernels held and timed at this path's block (4 latents,
    64 entries)."""
    import torch
    from msu_latentafis_tpu_torch.matcher.kernels import ops
    from msu_latentafis_tpu_torch.utils.synthetic import (
        device_synthetic_gallery, plant_gallery_entries)
    t0 = time.perf_counter()
    gal, codes = device_synthetic_gallery(engine, GALLERY_G, seed=2,
                                          both_layouts=True)
    lats, mates = make_latents(rng, N_LATENTS, cb)
    positions = [int(GALLERY_G * f) for f in (0.075, 0.35, 0.61, 0.98)]
    for g in (gal, codes):
        plant_gallery_entries(g, engine, mates, positions)
    torch.cuda.synchronize()
    log(f"[engine] gallery {GALLERY_G} x (Rm 96, Rt 448, D 96) built on the "
        f"card in {time.perf_counter() - t0:.2f} s "
        f"(tex_dec {gal.tex_dec.numel() * 4 / 1e9:.2f} GB)")

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    scores = engine.match_scores_batch(lats, gal)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    t0 = time.perf_counter()
    scores2 = engine.match_scores_batch(lats, gal)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0

    s = scores[:, :gal.n_real].cpu()
    if not torch.isfinite(s).all() or not torch.equal(scores, scores2):
        raise AssertionError("scores not finite or not repeatable")
    for i, p in enumerate(positions):
        top = int(torch.argmax(s[i]))
        srt = torch.sort(s[i], descending=True).values
        log(f"[engine] latent {i}: mate at {p} scores {float(s[i, p]):.3f}, "
            f"rank-1 entry {top}, best impostor {float(srt[1]):.3f}")
        if top != p or not float(s[i, p]) > float(srt[1]):
            raise AssertionError(f"latent {i}: mate not at rank 1")
    if min(counts[k] for k in DENSE_KERNELS) <= 0:
        raise AssertionError(f"dense path skipped a kernel: {counts}")
    log(f"[engine] {N_LATENTS} latents x {GALLERY_G} entries: first "
        f"{first_s:.3f} s, steady {steady_s:.3f} s, "
        f"{N_LATENTS / steady_s:.2f} latents/s on {card}; launches {counts}")
    profile_call("dense", lambda: engine.match_scores_batch(lats, gal))
    # as _match_all launches them: the filter kernels' work depends on the
    # data, so one block without a mate and the first mate's block, each
    # weighted by how many blocks of the gallery are like it
    L = engine.latent_side(engine.latent_batch(lats))
    B = engine.block_size
    mated = {p // B for p in positions}
    unmated = next(b for b in range(gal.size // B) if b not in mated)
    parts = {}
    for b, n in ((unmated, gal.size // B - len(mated)),
                 (positions[0] // B, len(mated))):
        rec = dense_records(*engine.block_args(L, gal, b * B), reps=10)
        check_records(f"kernels, dense path ({N_LATENTS} latents x {B} "
                      f"entries at {b * B}, x{n} per call)", rec)
        for name, r in rec.items():
            parts.setdefault(name, []).append((r, n))
    rec = {name: per_launch(p) for name, p in parts.items()}
    check_records("kernels, dense path (per launch over one call)", rec)
    return counts, rec, (gal, codes), lats, positions, scores


def mate_at_rank1(idx, exact, positions, label):
    """Every latent's best exact score is its planted mate's, strictly."""
    import numpy as np
    for i, p in enumerate(positions):
        order = np.argsort(-exact[i], kind="stable")
        log(f"[{label}] latent {i}: mate at {p} exact "
            f"{float(exact[i, order[0]]):.3f} (entry {int(idx[i, order[0]])}), "
            f"best impostor {float(exact[i, order[1]]):.3f}")
        if int(idx[i, order[0]]) != p or not exact[i, order[0]] > \
                exact[i, order[1]]:
            raise AssertionError(f"{label}: latent {i}'s mate not at rank 1")


def serving_launched(label, counts, gal):
    """Serving launched every kernel of its gallery layout."""
    names = ("minu_screen", "adc_screen_codes", "adc_rowmax_codes",
             "minutiae_match", "texture_match") if gal.codes_resident else (
        "minu_screen", "adc_screen", "adc_rowmax", "minutiae_match",
        "texture_match")
    if min(counts[k] for k in names) <= 0:
        raise AssertionError(f"{label} skipped a kernel: {counts}")


def phase_serving(engine, layouts, lats, positions, dense):
    """Screen-then-rerank on phase 3's gallery: the kept candidates' exact
    scores are the dense scores at those indices, bit for bit; the same
    gallery codes-resident gives the same results."""
    import numpy as np
    import torch
    from msu_latentafis_tpu_torch.matcher.kernels import ops
    pre, codes = layouts
    screen = engine.screen_scores_batch(lats, pre).cpu()
    dense = dense.cpu()
    counts, out = {}, {}
    for label, kw, g in (
            ("serve 16k", dict(m=SERVE["m"]), pre),
            ("serve 16k prescreen", SERVE, pre),
            ("serve 16k prescreen codes-resident", SERVE, codes)):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out[label] = idx, exact, margin, thr = \
            engine.match_scores_batch_reranked(lats, g, **kw)
        sec = time.perf_counter() - t0
        counts[label] = ops.launch_counts()
        serving_launched(label, counts[label], g)
        mate_at_rank1(idx, exact, positions, label)
        for i in range(len(lats)):
            rows = torch.as_tensor(idx[i])
            if not torch.equal(torch.as_tensor(exact[i]), dense[i, rows]):
                raise AssertionError(f"{label}: exact != dense, latent {i}")
            if "prescreen_k" not in kw and not bool(
                    (screen[i, rows] + 1e-3 >= torch.as_tensor(exact[i]))
                    .all()):
                raise AssertionError(f"{label}: screen below exact, "
                                     f"latent {i}")
        nan = np.isnan(margin).all() and np.isnan(thr).all()
        finite = np.isfinite(margin).all() and np.isfinite(thr).all()
        if ("prescreen_k" in kw and not nan) or (
                "prescreen_k" not in kw and not finite):
            raise AssertionError(f"{label}: margin {margin} threshold {thr}")
        log(f"[{label}] {len(lats)} latents x {g.size} entries, m_pad "
            f"{idx.shape[1]}: {sec:.3f} s; exact == dense at the kept "
            f"indices; margin {np.round(margin, 3).tolist()} threshold "
            f"{np.round(thr, 3).tolist()}; launches {counts[label]}")
    if not all(np.array_equal(a, b, equal_nan=True) for a, b in zip(
            out["serve 16k prescreen"],
            out["serve 16k prescreen codes-resident"])):
        raise AssertionError("16k: codes-resident serving != predecoded")
    return counts


def phase_scale(engine, cb, rng, card):
    """Serving at 100,000 entries, predecoded and codes-resident from the
    same codes, at the JAX bench's configuration; then each serving kernel
    held and timed at the shapes this path launched it with."""
    import numpy as np
    import torch
    from msu_latentafis_tpu_torch.matcher.engine import SCREEN_CHUNK
    from msu_latentafis_tpu_torch.matcher.kernels import ops
    from msu_latentafis_tpu_torch.utils.synthetic import (
        device_synthetic_gallery, plant_gallery_entries)
    Gp = -(-SERVE_G // engine.block_size) * engine.block_size
    free = torch.cuda.mem_get_info()[0]
    default = "predecoded" if engine.should_predecode(Gp, 448) \
        else "codes-resident"
    log(f"[scale] codes_resident=None: {Gp} entries of f32 texture "
        f"({Gp * 448 * 96 * 4 / 1e9:.2f} GB) against {free / 1e9:.2f} GB "
        f"free -> {default}")
    t0 = time.perf_counter()
    pre, codes = device_synthetic_gallery(engine, SERVE_G, seed=3,
                                          both_layouts=True)
    lats, mates = make_latents(rng, SERVE_LATENTS, cb)
    positions = [int(SERVE_G * (i + 0.5) / SERVE_LATENTS) + 7 * i
                 for i in range(SERVE_LATENTS)]
    for g in (pre, codes):
        plant_gallery_entries(g, engine, mates, positions)
    torch.cuda.synchronize()
    log(f"[scale] gallery {SERVE_G} x (Rm 96, Rt 448, D 96) built on the card "
        f"in {time.perf_counter() - t0:.2f} s: tex_dec "
        f"{nbytes(pre.tex_dec) / 1e9:.2f} GB, tex_codes "
        f"{nbytes(codes.tex_codes) / 1e9:.2f} GB, the rest "
        f"{nbytes(pre.minu_des, pre.minu_pack, pre.tex_sqnorm,
                  pre.tex_pack) / 1e9:.2f} GB")
    layouts = {"predecoded": pre, "codes-resident": codes}
    out, counts = {}, {}
    for label, g in layouts.items():
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        first = engine.match_scores_batch_reranked(lats, g, **SERVE)
        first_s = time.perf_counter() - t0
        counts[label] = ops.launch_counts()
        serving_launched(label, counts[label], g)
        t0 = time.perf_counter()
        out[label] = engine.match_scores_batch_reranked(lats, g, **SERVE)
        steady_s = time.perf_counter() - t0
        if not all(np.array_equal(a, b, equal_nan=True)
                   for a, b in zip(first, out[label])):
            raise AssertionError(f"{label}: serving not repeatable")
        mate_at_rank1(out[label][0], out[label][1], positions, label)
        log(f"[scale] {label}: {SERVE_LATENTS} latents x {g.size} entries "
            f"(m {SERVE['m']}, prescreen {SERVE['prescreen_k']}/"
            f"{SERVE['prescreen_lt']}/{SERVE['prescreen_t']}): first "
            f"{first_s:.3f} s, steady {steady_s:.3f} s, "
            f"{SERVE_LATENTS / steady_s:.2f} latents/s on {card}; launches "
            f"{counts[label]}")
        profile_call(f"serve 100k {label}",
                     lambda: engine.match_scores_batch_reranked(lats, g,
                                                                **SERVE))
    if not all(np.array_equal(a, b, equal_nan=True) for a, b in
               zip(out["predecoded"], out["codes-resident"])):
        raise AssertionError("codes-resident serving != predecoded serving")
    log("[scale] codes-resident idx and exact equal the predecoded ones")

    # The screens as _screen_all launched them: the truncated latents over
    # every full SCREEN_CHUNK of entries and the tail chunk.
    lat = engine.latent_batch(lats)
    L = engine.screen_side(lat, SERVE["prescreen_lt"], SERVE["prescreen_t"])
    G = pre.size
    shapes = ([(0, G // SCREEN_CHUNK)] if G >= SCREEN_CHUNK else []) + (
        [(G - G % SCREEN_CHUNK, 1)] if G % SCREEN_CHUNK else [])
    parts = {}
    for a, n in shapes:
        rows = slice(a, a + SCREEN_CHUNK)
        mscr, sadc = engine.screen_args(L, pre, rows)
        rec = screen_records(mscr, sadc, engine.screen_args(L, codes, rows)[1],
                             step=2048, reps=3)
        check_records(f"kernels, serving screen ({SERVE_LATENTS} latents x "
                      f"{mscr['rdes'].shape[0]} entries, x{n} per call)", rec)
        for name, r in rec.items():
            parts.setdefault(name, []).append((r, n))
    n_launch = sum(n for _, n in shapes)
    for name, layout in (("minu_screen", "predecoded"),
                         ("adc_screen", "predecoded"),
                         ("adc_screen_codes", "codes-resident")):
        if counts[layout][name] != n_launch:
            raise AssertionError(f"{name}: {counts[layout][name]} launches, "
                                 f"expected {n_launch} chunks")
    rec = {name: per_launch(p) for name, p in parts.items()}
    # adc_rowmax_codes as the rerank launched it: one latent, the first
    # block of its gathered sub-gallery
    B = engine.block_size
    sub = torch.as_tensor(out["codes-resident"][0][0, :B], device=pre.
                          minu_des.device)
    L1 = engine.latent_side({k: v[:1] for k, v in lat.items()})
    rec["adc_rowmax_codes"] = rowmax_codes_record(
        engine.block_args(L1, codes.take(sub), 0)[1],
        engine.block_args(L1, pre.take(sub), 0)[1], reps=10)
    check_records("kernels, serving (screens per launch over one call)", rec)
    return counts, rec


def profile_call(label, fn):
    """Device time by kernel and the device's idle share over one call
    (torch.profiler; kernels are named by their CUDA symbol)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with warnings.catch_warnings(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        warnings.simplefilter("ignore")
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = {}
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        dev[e.key] = (us / 1e3, e.count)
    busy = sum(ms for ms, _ in dev.values())
    if busy <= 0.0:
        log(f"[profile {label}] device time not measured (no CUDA events "
            f"traced)")
        return
    log(f"[profile {label}] wall {wall_ms:.2f} ms, device busy {busy:.2f} "
        f"ms, idle share {max(0.0, 1.0 - busy / wall_ms):.3f}")
    for name, (ms, n) in sorted(dev.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"[profile {label}] {ms:9.3f} ms {100 * ms / busy:5.1f}% "
            f"x{n:<5d} {name[:90]}")


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import msu_latentafis_tpu_torch
    except ImportError:
        print("chip_smoke: the port is not beside this script", file=sys.stderr)
        return 3
    if not os.path.abspath(msu_latentafis_tpu_torch.__file__).startswith(
            HERE + os.sep):
        print("chip_smoke: the port is not beside this script", file=sys.stderr)
        return 3
    import numpy as np
    from msu_latentafis_tpu_torch.matcher.engine import MatchEngine
    from msu_latentafis_tpu_torch.matcher.kernels import _build
    from msu_latentafis_tpu_torch.utils.synthetic import random_codebook

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    log(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    name = "?"
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:                    # mangled: <name>_kernel[I<loader>...]
            name = re.search(r"([a-z_]+_kernel)", m.group(1)).group(1) + (
                "<codes>" if "CodeCols" in m.group(1) else "")
        elif "Used" in line or "spill" in line:
            log(f"[build] {name}: {line.split(':', 1)[-1].strip()}")

    rng = np.random.default_rng(20261017)
    cb = random_codebook(rng)
    engine = MatchEngine(cb, block_size=64, device="cuda")
    t0 = time.perf_counter()
    phase_kernels(engine, cb, rng)
    log(f"[phase 1] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out_root = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_root) as work:
        phase_cli(cb, rng, work)
    log(f"[phase 2] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts, rec, layouts, lats, positions, dense = phase_engine(
        engine, cb, rng, card)
    log(f"[phase 3] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_serving(engine, layouts, lats, positions, dense)
    log(f"[phase 4] {time.perf_counter() - t0:.1f} s")
    del layouts, dense
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    scale, serve_rec = phase_scale(engine, cb, rng, card)
    log(f"[phase 5] {time.perf_counter() - t0:.1f} s")
    # each kernel's launches and numbers on the main path that runs it: the
    # dense match (phase 3) and 100,000-entry serving in its layout (phase 5)
    rec.update(serve_rec)
    for k in ("minu_screen", "adc_screen"):
        counts[k] = scale["predecoded"][k]
    for k in ("adc_screen_codes", "adc_rowmax_codes"):
        counts[k] = scale["codes-resident"][k]

    kernels = []
    for name, (src, line) in KERNEL_META.items():
        r = rec[name]
        kernels.append(dict(
            name=name, route="cuda",
            source=f"msu_latentafis_tpu_torch/matcher/kernels/csrc/{src}",
            replaces=f"msu_latentafis_tpu/matcher/pallas_kernels.py:{line}",
            launches=counts[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=r["library_ms"]))
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
