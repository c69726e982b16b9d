#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the dense matcher on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero; there is no CPU fallback):
  0. setup: card name and power limit, a faulthandler watchdog, the kernel
     build (one nvcc call) and its seconds;
  1. each kernel against its plain PyTorch version on the card, on one
     64-entry gallery block with 2 latents at the main path's widths
     (Lm 64, Rm 96, Lt 448, Rt 448, D 96, T 3): maximum difference against
     the stated tolerance, kernel / plain / library times, op-count bound;
  2. the CLI: a 64-file synthetic .dat gallery with one planted mate,
     ``cli.main(["match", ...])``, the mate must be rank 1 in the CSV;
  3. the dense engine on a 16,384-entry gallery built on the card from a
     seed, 4 latents with planted mates through ``match_scores_batch``:
     every mate at rank 1, every kernel launched.
The last two lines of standard output are the kernels' JSON record and
{"ok": true, "device": {...}}. The script imports no JAX.
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
PEAK_F32_FLOPS = 67e12       # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
TOL = dict(rtol=1e-5, atol=1e-4)
HERE = os.path.dirname(os.path.abspath(__file__))
# kernel -> (source in csrc/, line of the TPU kernel in pallas_kernels.py)
KERNEL_META = {
    "adc_rowmax": ("adc_rowmax.cu", 1489),
    "texture_match": ("texture_match.cu", 1031),
    "minutiae_match": ("minutiae_match.cu", 878),
}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int) -> float:
    import torch
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


def phase_kernels(engine, cb, rng):
    """Each kernel vs its plain version on one 64-entry block, 2 latents."""
    import torch
    from msu_latentafis_tpu_torch.matcher.kernels import ops
    from msu_latentafis_tpu_torch.utils.synthetic import (
        device_synthetic_gallery, plant_gallery_entries)
    lats, mates = make_latents(rng, 2, cb)
    gal = device_synthetic_gallery(engine, 64, seed=1)
    plant_gallery_entries(gal, engine, mates, [0, 1])
    L = engine.latent_side(engine.latent_batch(lats))
    minu, adc, tex = engine.block_args(L, gal, 0)
    rec = {}

    best, bestj = ops.adc_rowmax(**adc)
    pbest, pbestj = ops.adc_rowmax_plain(**adc)
    torch.cuda.synchronize()
    err = float((best - pbest).abs().max())
    ok = torch.allclose(best, pbest, **TOL) and bool((bestj == pbestj).all())
    x, dec = adc["x"], adc["dec"]
    NL, Lt, D = x.shape
    B, Rt, _ = dec.shape
    dect = dec.transpose(1, 2)

    def library():
        simi = 2.0 * torch.matmul(x[:, None], dect[None]) + (
            (6.0 - adc["lsq"])[:, None, :, None] - adc["rsq"][None, :, None, :])
        return (simi + (adc["rvalid"][None, :, None, :] - 1.0) * 1e30).max(-1)
    lbest = library().values
    rec["adc_rowmax"] = dict(
        max_abs_err=err, ok=ok, library_err=float((lbest - pbest).abs().max()),
        ms=cuda_ms(lambda: ops.adc_rowmax(**adc), 20),
        plain_ms=cuda_ms(lambda: ops.adc_rowmax_plain(**adc), 2),
        library_ms=cuda_ms(library, 20),
        bound=bound(2.0 * NL * B * Lt * Rt * D,
                    nbytes(*adc.values()) + nbytes(best, bestj)))

    got = ops.texture_match(best, bestj, **tex)
    stats = {}
    want = ops.texture_match_plain(best, bestj, stats=stats, **tex)
    torch.cuda.synchronize()
    sel_ops = 30.0 * best.numel()
    rec["texture_match"] = dict(
        max_abs_err=float((got - want).abs().max()),
        ok=torch.allclose(got, want, **TOL),
        ms=cuda_ms(lambda: ops.texture_match(best, bestj, **tex), 10),
        plain_ms=cuda_ms(lambda: ops.texture_match_plain(best, bestj, **tex),
                         1),
        library_ms=None,
        bound=bound(sel_ops + filter_ops(stats["k_valid"], stats["n_stage1"],
                                         tex["dist_iters"]),
                    nbytes(best, bestj, tex["lvalid"], tex["lpack"],
                           tex["rpack"], got)))

    got = ops.minutiae_match(**minu)
    stats = {}
    want = ops.minutiae_match_plain(stats=stats, **minu)
    torch.cuda.synchronize()
    NT, P, _ = minu["ldes"].shape
    R = minu["rdes"].shape[1]
    pre_ops = NT * B * (2.0 * P * R * D + 5.0 * P * R
                        + 2.0 * minu["row_cap"] * P * R
                        + 26.0 * minu["row_cap"] * P)
    rec["minutiae_match"] = dict(
        max_abs_err=float((got - want).abs().max()),
        ok=torch.allclose(got, want, **TOL),
        ms=cuda_ms(lambda: ops.minutiae_match(**minu), 10),
        plain_ms=cuda_ms(lambda: ops.minutiae_match_plain(**minu), 1),
        library_ms=None,
        bound=bound(pre_ops + filter_ops(stats["k_valid"], stats["n_stage1"],
                                         minu["dist_iters"]),
                    nbytes(*(v for v in minu.values()
                             if isinstance(v, torch.Tensor)), got)))
    for name, r in rec.items():
        log(f"[kernels] {name}: max_abs_err {r['max_abs_err']:.3e} "
            f"(tol rtol {TOL['rtol']} atol {TOL['atol']}) ok={r['ok']} "
            f"kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.2f} "
            f"library_ms {r['library_ms']} bound_ms {r['bound'][0]:.4f} "
            f"({r['bound'][1]})")
    log(f"[kernels] adc library (matmul + max) vs plain max diff "
        f"{rec['adc_rowmax']['library_err']:.3e}")
    bad = [n for n, r in rec.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    return rec


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
    sdir = os.path.join(workdir, "scores")
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
    ops.reset_launch_counts()
    rc = cli.main(["match", "-l", latf, "-g", gdir, "-c", cbf, "-s", sdir])
    counts = ops.launch_counts()
    if rc != 0:
        raise AssertionError(f"cli returned {rc}")
    with open(os.path.join(sdir, "latent0.csv")) as f:
        lines = f.read().splitlines()
    if lines[0] != "filename,score" or not lines[1].startswith(
            f"1r{mate_idx:03d},"):
        raise AssertionError(f"CLI rank list wrong: {lines[:3]}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"CLI path skipped a kernel: {counts}")
    log(f"[cli] mate r{mate_idx:03d} at rank 1 ({lines[1]}), "
        f"{len(lines) - 1} ranks written, launches {counts}")


def phase_engine(engine, cb, rng, card):
    """Dense engine on a 16,384-entry gallery, 4 latents, planted mates."""
    import torch
    from msu_latentafis_tpu_torch.matcher.kernels import ops
    from msu_latentafis_tpu_torch.utils.synthetic import (
        device_synthetic_gallery, plant_gallery_entries)
    t0 = time.perf_counter()
    gal = device_synthetic_gallery(engine, GALLERY_G, seed=2)
    lats, mates = make_latents(rng, N_LATENTS, cb)
    positions = [int(GALLERY_G * f) for f in (0.075, 0.35, 0.61, 0.98)]
    plant_gallery_entries(gal, engine, mates, positions)
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
    if min(counts.values()) <= 0:
        raise AssertionError(f"dense path skipped a kernel: {counts}")
    log(f"[engine] {N_LATENTS} latents x {GALLERY_G} entries: first "
        f"{first_s:.3f} s, steady {steady_s:.3f} s, "
        f"{N_LATENTS / steady_s:.2f} latents/s on {card}; launches {counts}")
    profile_dense(engine, lats, gal)
    return counts


def profile_dense(engine, lats, gal):
    """Device time by kernel and the device's idle share over one dense
    match (torch.profiler; kernels are named by their CUDA symbol)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with warnings.catch_warnings(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        warnings.simplefilter("ignore")
        t0 = time.perf_counter()
        engine.match_scores_batch(lats, gal)
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
        log("[profile] device time not measured (no CUDA events traced)")
        return
    log(f"[profile] wall {wall_ms:.2f} ms, device busy {busy:.2f} ms, idle "
        f"share {max(0.0, 1.0 - busy / wall_ms):.3f}")
    for name, (ms, n) in sorted(dev.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"[profile] {ms:9.3f} ms {100 * ms / busy:5.1f}% x{n:<5d} "
            f"{name[:90]}")


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
        m = re.search(r"Compiling entry function '.*?(\w+_kernel)", line)
        if m:
            name = m.group(1)
        elif "Used" in line or "spill" in line:
            log(f"[build] {name}: {line.split(':', 1)[-1].strip()}")

    rng = np.random.default_rng(20261017)
    cb = random_codebook(rng)
    engine = MatchEngine(cb, block_size=64, device="cuda")
    t0 = time.perf_counter()
    rec = phase_kernels(engine, cb, rng)
    log(f"[phase 1] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out_root = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_root) as work:
        phase_cli(cb, rng, work)
    log(f"[phase 2] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts = phase_engine(engine, cb, rng, card)
    log(f"[phase 3] {time.perf_counter() - t0:.1f} s")

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
