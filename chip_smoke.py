#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the matcher on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero; there is no CPU fallback):
  0. setup: card name and power limit, a faulthandler watchdog, the kernel
     build (one nvcc per source, started together, and a link) and its
     seconds;
  1. each kernel against its plain PyTorch version on the card, on one
     64-entry gallery block with 2 latents at full widths (Lm 64, Rm 96,
     Lt 448, Rt 448, D 96, T 3): maximum difference against the stated
     tolerance (rtol 1e-5 / atol 1e-4, ops.KERNEL_TOL; the ADC screens with
     a bf16 latent side, which sum on the tensor cores and round their row
     maxima to bf16, within ops.screen_slack), kernel / plain / library
     times, bound; the codes kernels must equal their predecoded twins bit
     for bit. The normalized screen
     on the same block; the packed graph filter at stages 0-6 and with a
     stage2_cap below the survivor count, the xy / ori filter, and the
     infuse filter with val and with simi, on sets of that block's width;
     the large-print block: minutiae_match and both screens at P 128 /
     R 1000 (the reference's largest rolled print) and P 256 / R 96;
  2. the CLI: a 64-file synthetic .dat gallery with one planted mate and
     one rolled print of 1,000 minutiae, ``cli.main(["match", ...])`` dense,
     with ``--rerank 16``, and through ``--config`` with ComputeDtype
     "bfloat16" (the codebook and score paths from the config), the mate
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
     then the same with ``normalize=True`` (kept exact scores equal to the
     dense ones; the mates' ranks printed, not asserted: the normalized
     screen is a heuristic);
  5. serving at the JAX bench's gallery size: 100,000 entries built on the
     card from one seed in both layouts (predecoded f32 and codes-resident
     uint8, from the same codes), 8 latents with planted mates, m 512,
     prescreen 256 / 64 / 1: mates at rank 1, the two layouts' results
     equal, first-call and steady seconds, a profiler breakdown; then the
     serving kernels held and timed as this path launches them: the screens
     on its 16,384-entry chunks and its tail chunk with the truncated
     latents (plain versions a slice of entries at a time), the codes ADC
     row max on one latent's first rerank block. Then ``normalize=True``
     serving on the predecoded gallery with the same prescreen, and the
     normalized screen held and timed on that path's chunks;
  6. the standalone graph filter at the shapes of the two ported microbench
     scripts (``msu_latentafis_tpu_torch/scripts/``): the packed kernel at
     stages 0-6 over 24 x 512 sets of K 120 and 8 x 512 of K 200, the
     minutiae and texture kernels at the same sets, the xy / ori filter,
     and the infuse filter at NT 24 x B 512 x P 64 x R 96 with val and with
     simi; each held against its plain version (stages 0-5 on a slice of
     sets); then infuse after the port's exact selection against
     minutiae_match at row_cap = R on one block;
  7. the throughput modes, dense: phase 3's gallery (the same seed, so the
     same f32 values) and latents in bf16, bf16 + tex_int8 and bf16 +
     minu_int8: mates at rank 1 in every mode, the mates' scores within
     tests/test_int8_mode.py's tolerances of bf16 and f32, minu_int8's
     impostors under a tenth of the mate; the scores outside rtol 0.05 /
     atol 0.3 of the reference counted and printed; then the typed dense
     kernels held and timed as this path launches them;
  8. the throughput modes, serving: bf16 + tex_int8 predecoded on phase 5's
     100,000-entry gallery and latents at the JAX bench's code defaults
     (m 256, prescreen 256 / 64 / 1): mates at rank 1, kept exact scores
     equal to the mode's dense scores, steady latents/s, a profiler
     breakdown; the typed screens held per chunk, and the entries whose
     membership in the chunk's screen top-k1 and top-m sets differs between
     the kernels and the plain versions counted and printed; normalize=True
     serving in the same mode and its screen held; then the two other typed
     pairs of the predecoded screen, bf16 without tex_int8 and f32 with
     tex_int8, each serving one 16,384-entry chunk of its own gallery
     (mates at rank 1, launches counted) and held and timed on that chunk;
  9. the reference-cap shape (Lm = Rm = 128, Lt = Rt = 1000) codes-resident
     with minu_int8 in bf16, the JAX bench's headline mode, serving 8
     latents at m 256 / prescreen 256 / 64 / 1 over 16,384 entries (not
     100,000: the cap shape has about 5x the 448 shape's screen work):
     mates at rank 1, latents/s, profile; the typed codes kernels held and
     the screen's top-k1 / top-m set differences counted as in phase 8;
  10. the ported scripts' kernels: exp_screen_mfu's five variants at its
     shapes (NL 8, Lt 448, Rt 448, D 96, B 4096), the H1 probe's three
     variants (matmul must equal bcast), the launch-legality canary (a
     legal plan copies, a plan above the card's shared memory or thread
     limit must raise); each kernel held against its plain version
     (screen_t_bf16, on the tensor cores, within ops.screen_t_tol).
The kernels' JSON record takes each kernel's launches from the path that
runs it (phase 3, phase 5 in its layout or with normalize=True, or phase
6) and its numbers from the same path's shapes and data: means per launch
over one call's chunks (the screens) or over its blocks with and without a
mate (the dense kernels), so that ms x launches is the call's time in that
kernel; the filter kernels at the first microbench shape. The last two lines
of standard output are that record and {"ok": true, "device": {...}}; the
kernels redesigned for Hopper in the last slice (the predecoded ADC
screen in every operand pair, the experiment's transposed bf16 screen)
also print their earlier times beside this run's. The script imports no
JAX.
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

WATCHDOG_S = 600             # a hang ends as a traceback and a nonzero exit
GALLERY_G = 16384            # the profile gallery size (docs/PERF.md:5-8)
N_LATENTS = 4
SERVE_G = 100000             # the JAX bench's gallery, latents and
SERVE_LATENTS = 8            # prescreen (bench.py:10,120-126); m 512 is
# its docstring's rerank size (:12), while its code defaults BENCH_RERANK
# to 256 (:188); m 512 keeps these numbers comparable with earlier runs
SERVE = dict(m=512, prescreen_k=256, prescreen_lt=64, prescreen_t=1)
# the JAX bench's code defaults: BENCH_RERANK 256, prescreen 256 / 64 / 1
# (bench.py:188,137-139)
SERVE_BENCH = dict(m=256, prescreen_k=256, prescreen_lt=64, prescreen_t=1)
CAP = dict(Lm=128, Rm=128, Lt=1000, Rt=1000)   # matcher.h:31-32 capacities
CAP_G = 16384
PEAK_F32_FLOPS = 67e12       # H100 SXM f32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12     # H100 SXM bf16 tensor cores, dense
PEAK_INT8_OPS = 1979e12      # H100 SXM int8 tensor cores, dense
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
TOL = dict(rtol=1e-5, atol=1e-4)
HERE = os.path.dirname(os.path.abspath(__file__))
PALLAS = "msu_latentafis_tpu/matcher/pallas_kernels.py"
# kernel -> (source in csrc/, the TPU kernel it replaces as file:line); a
# typed entry "name[types]" shares its kernel's row
KERNEL_META = {
    "adc_rowmax": ("adc_rowmax.cu", f"{PALLAS}:1489"),
    "texture_match": ("texture_match.cu", f"{PALLAS}:1031"),
    "minutiae_match": ("minutiae_match.cu", f"{PALLAS}:878"),
    "minu_screen": ("minu_screen.cu", f"{PALLAS}:1312"),
    "adc_screen": ("adc_screen.cu", f"{PALLAS}:1106"),
    "adc_screen_codes": ("adc_screen_codes.cu", f"{PALLAS}:1213"),
    "adc_rowmax_codes": ("adc_rowmax.cu", f"{PALLAS}:1434"),
    "minu_screen_norm": ("minu_screen_norm.cu", f"{PALLAS}:1370"),
    "graph_filter_packed": ("graph_filter.cu", f"{PALLAS}:456"),
    "graph_filter": ("graph_filter.cu", f"{PALLAS}:410"),
    "graph_filter_infuse": ("graph_filter_infuse.cu", f"{PALLAS}:551"),
    "screen_t_bf16": ("screen_t.cu", "scripts/exp_screen_mfu.py:154"),
    "screen_t_int8": ("screen_t.cu", "scripts/exp_screen_mfu.py:124"),
    "h1_probe": ("h1_probe.cu", "scripts/microbench_h1_probe.py:98"),
    "legality_canary": ("legality_canary.cu",
                        "tests/test_mosaic_legality.py:44"),
}
# graph_filter launches graph_filter_packed's kernel after building the
# cos / sin packs, as fused_graph_filter wraps the same Pallas body
SHARED_SOURCE = {"graph_filter": "graph_filter_packed"}
# ms per launch of the kernels last redesigned for Hopper, before the
# redesign, on their main paths' shapes (PERF.md section 6: NVIDIA H100
# 80GB HBM3, 700.00 W, chip_smoke.py); printed beside this run's
BEFORE_MS = {"adc_screen": 46.7465,
             "adc_screen[bf16,int8]": 46.9275,
             "screen_t_bf16": 80.6312}
SERVE_NORM = dict(SERVE, normalize=True)
LARGE_PRINTS = ((128, 1000), (256, 96))   # (P, R) of the large-print block
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


def bound(ops: float, nbytes: float, peak: float = PEAK_F32_FLOPS):
    """The least time (ms) for ``ops`` operations at ``peak`` and ``nbytes``
    at the memory rate, and which of the two bounds it."""
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def peak_of(t) -> float:
    """The card's peak rate for a kernel whose latent operand is ``t``:
    the bf16 tensor-core peak for a bf16 operand, else the f32 rate."""
    import torch
    return PEAK_BF16_FLOPS if t.dtype == torch.bfloat16 else PEAK_F32_FLOPS


def tag(name: str, *ts) -> str:
    """``name[types]`` of a typed kernel's launch, e.g. adc_rowmax[bf16,int8];
    the f32 kernels keep their plain names."""
    import torch
    short = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}
    types = [short[t.dtype] for t in ts]
    return name if set(types) == {"f32"} else f"{name}[{','.join(types)}]"


def lib_cast(a, b):
    """Library operands: b in a's type (an int8 gallery side cast to the
    latent's bf16 or f32, as the TPU kernels cast it)."""
    return a, b.to(a.dtype)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def make_latents(rng, n: int, cb, Lm=64, Lt=448, Rm=96, Rt=448):
    """n latents with planted mates at one shape (the 448 shape unless
    told): packed latents and the packed mates."""
    from msu_latentafis_tpu_torch.templates import pack_gallery, pack_latent
    from msu_latentafis_tpu_torch.utils.synthetic import (
        make_latent_template, make_rolled_template)
    lats = [make_latent_template(rng, n_minu=Lm, n_tex=Lt) for _ in range(n)]
    mates = [make_rolled_template(rng, n_minu=Rm, n_tex=Rt,
                                  mated_latent=l, codebook=cb) for l in lats]
    packed = [pack_latent(l, minu_cap=Lm, tex_cap=Lt, quantize_tex_xy=False)
              for l in lats]
    pmates = pack_gallery(mates, cb, names=[f"mate{i}" for i in range(n)],
                          minu_cap=Rm, tex_cap=Rt)
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
    ldes, rdes = lib_cast(ldes, rdes)
    g = torch.matmul((ldes * lvalid[..., None].to(ldes.dtype))[:, None],
                     (rdes * rvalid[..., None].to(rdes.dtype))
                     .transpose(1, 2)[None]).float()
    return torch.minimum(g.amax(-1).clamp(min=0.0).sum(-1),
                         g.amax(-2).clamp(min=0.0).sum(-1))


def screen_library(x, lsq, lvalid, rsq, rvalid, dec=None, codes=None,
                   codebook=None, block=0):
    import torch
    from msu_latentafis_tpu_torch.matcher.kernels import ops
    from msu_latentafis_tpu_torch.matcher.texture_match import decode_pq
    if dec is None:
        dec = decode_pq(codes, codebook)
    x, dec = lib_cast(x, dec)
    mask = torch.where(rvalid > 0, 0.0, ops.SCREEN_SENT)
    v = torch.matmul(x[:, None], dec.transpose(1, 2)[None]).float() \
        + (-(0.5 * rsq) + mask)[None, :, None, :]
    return ((2.0 * v.amax(-1) + (6.0 - lsq)[:, None, :]).clamp(min=0.0)
            * lvalid[:, None, :]).sum(-1)


def rowmax_library(x, lsq, rsq, rvalid, dec=None, codes=None, codebook=None):
    import torch
    from msu_latentafis_tpu_torch.matcher.texture_match import decode_pq
    if dec is None:
        dec = decode_pq(codes, codebook)
    x, dec = lib_cast(x, dec)
    simi = 2.0 * torch.matmul(x[:, None], dec.transpose(1, 2)[None]).float() \
        + ((6.0 - lsq)[:, None, :, None] - rsq[None, :, None, :])
    return (simi + (rvalid[None, :, None, :] - 1.0) * 1e30).max(-1)


def norm_library(ldes, lvalid, rdes, rvalid):
    import torch
    ldes, rdes = lib_cast(ldes, rdes)
    lv, rv = lvalid[:, None, :, None], rvalid[None, :, None, :]
    g = torch.matmul(ldes[:, None], rdes.transpose(1, 2)[None]).float() \
        .clamp(min=0.0) * lv * rv
    n = g / (g.sum(-1, keepdim=True) + g.sum(-2, keepdim=True) - g
             + 1e-6) * lv * rv
    return torch.minimum(n.amax(-1).sum(-1), n.amax(-2).sum(-1))


def by_slices(fn, args: dict, step: int, n: int, dims: dict, out_dim: int):
    """fn(**args) on ``step``-long slices of one axis of length n (axis
    ``dims[k]`` of each argument k in ``dims``), outputs joined on
    ``out_dim``: the plain versions a bounded slice at a time."""
    import torch

    def run():
        return torch.cat([fn(**{
            k: v.narrow(dims[k], a, min(step, n - a))
            if k in dims and v is not None else v for k, v in args.items()})
            for a in range(0, n, step)], dim=out_dim)
    return run


def with_stats(plain, sink: list):
    """``plain`` that appends each call's filter statistics to ``sink``."""
    def run(**kw):
        st = {}
        out = plain(stats=st, **kw)
        sink.append(st)
        return out
    return run


def within(got, want, atol) -> bool:
    """|got - want| <= atol + TOL's rtol |want| everywhere; atol a number or
    a tensor of got's shape."""
    import torch
    d = (got.double() - want.double()).abs()
    return bool((d <= torch.as_tensor(atol, dtype=torch.float64,
                                      device=d.device)
                 + TOL["rtol"] * want.double().abs()).all())


def hold(fn, plain, library, reps: int, twin=None, atol=None,
         keep: bool = False) -> dict:
    """One kernel launch held against its plain version on the same inputs
    (first output within TOL, or within rtol and the elementwise ``atol``
    of a tensor-core screen: ops.screen_slack, ops.screen_t_tol; the other
    outputs equal) and, for a codes kernel, against its predecoded twin
    (bit for bit); kernel, plain and library times; with ``keep`` the
    kernel's and the plain version's first outputs ("got", "want"). The
    caller adds the bound."""
    import torch
    got = fn()
    want = plain()
    torch.cuda.synchronize()
    outs = got if isinstance(got, tuple) else (got,)
    wants = want if isinstance(want, tuple) else (want,)
    tol = TOL["atol"] if atol is None else atol
    ok = within(outs[0], wants[0], tol) and all(
        torch.equal(a, b) for a, b in zip(outs[1:], wants[1:]))
    if twin is not None:
        tw = twin()
        tw = tw if isinstance(tw, tuple) else (tw,)
        ok = ok and all(torch.equal(a, b) for a, b in zip(outs, tw))
    r = dict(max_abs_err=float((outs[0].double()
                                - wants[0].double()).abs().max()),
             ok=bool(ok), out_bytes=nbytes(*outs), ms=cuda_ms(fn, reps),
             plain_ms=cuda_ms(plain, 1, warm=False),
             library_ms=None if library is None else cuda_ms(library, reps),
             atol=TOL["atol"] if atol is None else float(atol.max()))
    if keep:
        r.update(got=outs[0], want=wants[0])
    return r


def dense_records(minu, adc, tex, reps: int) -> dict:
    """The dense path's three kernels on one block's inputs, keyed by
    ``tag`` (the typed kernels by their operand types)."""
    from msu_latentafis_tpu_torch.matcher.kernels import ops
    NL, Lt, D = adc["x"].shape
    B, Rt, _ = adc["dec"].shape
    r = hold(lambda: ops.adc_rowmax(**adc),
             lambda: ops.adc_rowmax_plain(**adc),
             lambda: rowmax_library(**adc), reps)
    r["library_err"] = float((rowmax_library(**adc).values
                              - ops.adc_rowmax_plain(**adc)[0]).abs().max())
    r["bound"] = bound(2.0 * NL * B * Lt * Rt * D,
                       tensor_bytes(adc) + r["out_bytes"], peak_of(adc["x"]))
    rec = {tag("adc_rowmax", adc["x"], adc["dec"]): r}
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
    r = rec[tag("minutiae_match", minu["ldes"], minu["rdes"])] = hold(
        lambda: ops.minutiae_match(**minu),
        lambda: ops.minutiae_match_plain(stats=stats, **minu), None, reps)
    pre_ops = NT * B * (2.0 * P * R * D + 5.0 * P * R
                        + 2.0 * minu["row_cap"] * P * R
                        + 26.0 * minu["row_cap"] * P)
    r["bound"] = bound(pre_ops + filter_ops(stats["k_valid"],
                                            stats["n_stage1"],
                                            minu["dist_iters"]),
                       tensor_bytes(minu) + r["out_bytes"],
                       peak_of(minu["ldes"]))
    return rec


def screen_slack(args: dict, step: int):
    """ops.screen_slack [NL, B] of an ADC screen (predecoded or codes) on
    ``args``, the row maxima from the plain version ``step`` entries at a
    time (a multiple of an int8 gallery's scale block)."""
    import torch
    from msu_latentafis_tpu_torch.matcher.kernels import ops
    from msu_latentafis_tpu_torch.matcher.texture_match import decode_pq
    B = args["rsq"].shape[0]
    raw = torch.cat([ops.screen_rowmax_plain(
        args["x"], args["dec"][a:a + step] if "dec" in args
        else decode_pq(args["codes"][a:a + step], args["codebook"]),
        args["rsq"][a:a + step], args["rvalid"][a:a + step],
        args.get("block", 0)) for a in range(0, B, step)], dim=1)
    return ops.screen_slack(args["x"], args["lvalid"], raw)


def screen_records(mscr, adc, adc_codes, step: int, reps: int) -> dict:
    """The screen kernels on one launch's inputs (``engine.screen_args``;
    either layout may be None); plain versions and library calls ``step``
    entries at a time; adc_screen_codes equal to adc_screen bit for bit
    when both are given; the ADC screens with a bf16 latent side (tensor
    cores) within ops.screen_slack of their plain versions. Keyed by
    ``tag``."""
    import torch
    from msu_latentafis_tpu_torch.matcher.kernels import ops
    rec = {}
    if mscr is not None:
        NT, P, D = mscr["ldes"].shape
        B, R, _ = mscr["rdes"].shape
        r = hold(lambda: ops.minu_screen(**mscr),
                 by_entries(ops.minu_screen_plain, mscr, step),
                 by_entries(minu_library, mscr, step), reps, keep=True)
        r["bound"] = bound(2.0 * NT * B * P * R * D,
                           tensor_bytes(mscr) + r["out_bytes"],
                           peak_of(mscr["ldes"]))
        rec[tag("minu_screen", mscr["ldes"], mscr["rdes"])] = r
    for name, args, twin in (
            ("adc_screen", adc, None),
            ("adc_screen_codes", adc_codes,
             None if adc is None else lambda: ops.adc_screen(**adc))):
        if args is None:
            continue
        NL, Lt, D = args["x"].shape
        B, Rt = args["rsq"].shape
        slack = screen_slack(args, step) \
            if args["x"].dtype == torch.bfloat16 else None
        r = hold(
            lambda: getattr(ops, name)(**args),
            by_entries(getattr(ops, name + "_plain"), args, step),
            by_entries(screen_library, args, step), reps, twin, slack,
            keep=True)
        r["bound"] = bound(2.0 * NL * B * Lt * Rt * D,
                           tensor_bytes(args) + r["out_bytes"],
                           peak_of(args["x"]))
        rec[tag(name, args["x"], *([args["dec"]] if "dec" in args
                                   else []))] = r
    return rec


def topk_set_diffs(label: str, engine, gal, L, rows: slice, rec: dict):
    """Logs the entries of one screen chunk whose membership in the top-k1
    (prescreen) and top-m sets of serving at SERVE_BENCH differs between
    the kernels' outputs and the plain versions', summed over the latents:
    the screen is the minutiae screen summed over templates plus 0.3 times
    the texture screen, empty entries -1, as the engine's _screen_all
    combines them, cut by a stable descending sort, as the engine takes
    its top-k. Takes the outputs that ``screen_records`` kept."""
    import torch
    from msu_latentafis_tpu_torch.matcher.engine import _skip_empty
    from msu_latentafis_tpu_torch.templates.data_model import \
        MatcherConstants as MC
    minu = next(k for k in rec if k.startswith("minu_screen"))
    tex = next(k for k in rec if k.startswith("adc_screen"))
    screens = [_skip_empty(
        rec[minu].pop(key).reshape(L["NL"], L["T"], -1).sum(dim=1)
        + MC.TEXTURE_SCORE_WEIGHT * rec[tex].pop(key), gal, rows)
        for key in ("got", "want")]
    B = engine.block_size
    k1 = max(B, (SERVE_BENCH["prescreen_k"] // B) * B)
    m_pad = min(-(-min(SERVE_BENCH["m"], gal.size) // B) * B, gal.size)
    diffs = []
    for k in (k1, m_pad):
        k = min(k, screens[0].shape[1])
        top = [torch.sort(s, dim=1, descending=True, stable=True)
               .indices[:, :k].cpu().tolist() for s in screens]
        diffs.append(sum(k - len(set(a) & set(b)) for a, b in zip(*top)))
    log(f"[{label}] screen chunk at {rows.start} ({screens[0].shape[1]} "
        f"entries, {L['NL']} latents), kernels vs plain versions: "
        f"{diffs[0]} entries differ in the top-{k1} (prescreen) sets, "
        f"{diffs[1]} in the top-{m_pad} sets")


def norm_record(mscr, step: int, reps: int) -> dict:
    """The normalized minutiae screen on one launch's inputs; plain version
    and library call ``step`` entries at a time."""
    from msu_latentafis_tpu_torch.matcher.kernels import ops
    NT, P, D = mscr["ldes"].shape
    B, R, _ = mscr["rdes"].shape
    r = hold(lambda: ops.minu_screen_norm(**mscr),
             by_entries(ops.minu_screen_norm_plain, mscr, step),
             by_entries(norm_library, mscr, step), reps)
    r["bound"] = bound(2.0 * NT * B * P * R * D,
                       tensor_bytes(mscr) + r["out_bytes"],
                       peak_of(mscr["ldes"]))
    return r


SET_DIMS = {k: 0 for k in ("val", "gl", "gr", "li", "ri", "valid", "lxy",
                           "lori", "rxy", "rori")}
INFUSE_DIMS = dict(val=1, li=1, ri=1, valid=1, rpackT=0, simi=1)


def filter_record(kernel, plain, args: dict, reps: int, step: int,
                  dims: dict, out_dim: int, full: bool = True) -> dict:
    """A graph-filter kernel held against its plain version; the plain
    version runs ``step`` sets (or entries) at a time. The bound counts
    the filter operations this data needs (``full``: the whole filter; else
    a stage hook, bounded by its bytes alone)."""
    n = args["li"].shape[out_dim]
    sink = []
    kw = {k: v for k, v in args.items() if k not in ("lookup", "dist_iters")}

    def run(**a):
        return plain(lookup=args["lookup"], dist_iters=args["dist_iters"],
                     **a)
    r = hold(lambda: kernel(**args),
             by_slices(with_stats(run, sink) if full else run, kw, step, n,
                       dims, out_dim), None, reps)
    n_slices = -(-n // step)
    fops = sum(filter_ops(st["k_valid"], st["n_stage1"], args["dist_iters"])
               for st in sink[:n_slices]) if full else 0.0
    r["bound"] = bound(fops, tensor_bytes(kw) + r["out_bytes"])
    return r


def filter_sets(rng, N: int, K: int, lookup: bool, device):
    """N random correspondence sets of K slots, as the microbench scripts
    draw them (coordinates below 30 with the lookup distance, else 480)."""
    from msu_latentafis_tpu_torch.scripts.microbench_body_stages import (
        make_sets)
    val, gl, gr, li, ri, valid = make_sets(rng, N, K, 0, 30 if lookup else 480,
                                           device)
    return dict(val=val, gl=gl, gr=gr, li=li, ri=ri, valid=valid)


def infuse_args(rng, NT, B, P, R, K, device, simi: bool):
    """Correspondence sets over an [NT, B] grid and the coordinate planes
    (float distance range), with val or with simi [NT, B, P, R]."""
    import torch

    def put(a, dtype=torch.float32):
        return torch.as_tensor(a).to(device=device, dtype=dtype).contiguous()
    args = dict(li=put(rng.integers(0, P, (NT, B, K)), torch.int32),
                ri=put(rng.integers(0, R, (NT, B, K)), torch.int32),
                valid=put(rng.random((NT, B, K)) > 0.15, torch.bool),
                lpackT=put(rng.uniform(0, 480, (NT, 4, P))),
                rpackT=put(rng.uniform(0, 480, (B, 4, R))))
    if simi:
        g = torch.Generator(device=device)
        g.manual_seed(int(rng.integers(1 << 30)))
        args.update(val=None, simi=3.0 * torch.rand(
            (NT, B, P, R), generator=g, device=device))
    else:
        args.update(val=put(rng.uniform(0.5, 3.0, (NT, B, K))), simi=None)
    return args


def filter_block_records(rng, device, NP: int, reps: int) -> dict:
    """The three standalone filter kernels on NP sets of the minutiae
    width (K 120, float distance, 5 iterations) and the texture width
    (K 200, lookup, 3): packed at stages 0-6 and with a stage2_cap below
    the most stage-1 survivors, xy / ori, infuse with val and simi."""
    import torch
    from msu_latentafis_tpu_torch.matcher.kernels import ops
    rec = {}
    for tag, K, lookup, iters in (("minu", 120, False, 5),
                                  ("tex", 200, True, 3)):
        sets = filter_sets(rng, NP, K, lookup, device)
        st = {}
        ops.graph_filter_packed_plain(**sets, lookup=lookup,
                                      dist_iters=iters, stats=st)
        n1 = st["n_stage1"]
        cap = max(1, int(n1.max()) - 1)
        log(f"[kernels] {tag} sets: stage-1 survivors {int(n1.min())}-"
            f"{int(n1.max())}, stage2_cap {cap} truncates "
            f"{int((n1 > cap).sum())} of {NP} sets")
        for stages, c in [(k, 0) for k in range(7)] + [(4, cap), (6, cap)]:
            a = dict(sets, lookup=lookup, dist_iters=iters, stages=stages,
                     stage2_cap=c)
            rec[f"graph_filter_packed {tag} st{stages} cap{c}"] = \
                filter_record(ops.graph_filter_packed,
                              ops.graph_filter_packed_plain, a, reps, NP,
                              SET_DIMS, 0, full=stages == 6 and c == 0)
        xy = dict(val=sets["val"], lxy=sets["gl"][..., :2].contiguous(),
                  rxy=sets["gr"][..., :2].contiguous(),
                  lori=sets["gl"][..., 2].contiguous(),
                  rori=sets["gr"][..., 2].contiguous(), li=sets["li"],
                  ri=sets["ri"], valid=sets["valid"], lookup=lookup,
                  dist_iters=iters)
        rec[f"graph_filter {tag}"] = filter_record(
            ops.graph_filter, ops.graph_filter_plain, xy, reps, NP, SET_DIMS,
            0)
    for simi in (False, True):
        a = dict(infuse_args(rng, 6, 64, 64, 96, 120, device, simi),
                 lookup=False, dist_iters=5)
        rec[f"graph_filter_infuse {'simi' if simi else 'val'}"] = \
            filter_record(ops.graph_filter_infuse,
                          ops.graph_filter_infuse_plain, a, reps, 64,
                          INFUSE_DIMS, 1)
    torch.cuda.synchronize()
    return rec


def large_print_records(rng, device, reps: int) -> dict:
    """minutiae_match (row_cap 8) and both screens on 3 templates x 16
    entries of a large print: P 128 / R 1000 and P 256 / R 96."""
    import numpy as np
    import torch
    from msu_latentafis_tpu_torch.matcher.kernels import ops
    rec = {}
    for P, R in LARGE_PRINTS:
        NT, B, D = 3, 16, 96
        ld = rng.standard_normal((NT, P, D)).astype(np.float32)
        rd = rng.standard_normal((B, R, D)).astype(np.float32)
        n = min(P, R)
        rd[0, :n] = ld[0, :n] + 0.2 * rng.standard_normal((n, D))
        ld /= np.linalg.norm(ld, axis=-1, keepdims=True)
        rd /= np.linalg.norm(rd, axis=-1, keepdims=True)

        def pack(m, k):
            xy = rng.uniform(0, 480, (m, k, 2))
            o = rng.uniform(-np.pi, np.pi, (m, k))
            return np.concatenate([xy, np.cos(o)[..., None],
                                   np.sin(o)[..., None]], -1)
        lp, rp = pack(NT, P), pack(B, R)
        rp[0, :n] = lp[0, :n]
        put = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                        device=device)
        mscr = dict(ldes=put(ld), lvalid=put(rng.random((NT, P)) > 0.1),
                    rdes=put(rd), rvalid=put(rng.random((B, R)) > 0.1))
        minu = dict(mscr, lpack=put(lp), rpack=put(rp), top_n=120,
                    row_cap=8, lookup=False, dist_iters=5)
        tag = f"P {P} R {R}"
        stats = {}
        r = rec[f"minutiae_match {tag}"] = hold(
            lambda: ops.minutiae_match(**minu),
            lambda: ops.minutiae_match_plain(stats=stats, **minu), None,
            reps)
        pre_ops = NT * B * (2.0 * P * R * D + 5.0 * P * R + 2.0 * 8 * P * R
                            + 26.0 * 8 * P)
        r["bound"] = bound(pre_ops + filter_ops(stats["k_valid"],
                                                stats["n_stage1"], 5),
                           tensor_bytes(minu) + r["out_bytes"])
        r = rec[f"minu_screen {tag}"] = hold(
            lambda: ops.minu_screen(**mscr),
            lambda: ops.minu_screen_plain(**mscr),
            lambda: minu_library(**mscr), reps)
        r["bound"] = bound(2.0 * NT * B * P * R * D,
                           tensor_bytes(mscr) + r["out_bytes"])
        rec[f"minu_screen_norm {tag}"] = norm_record(mscr, B, reps)
    return rec


def rowmax_codes_record(adc_codes, adc, reps: int) -> dict:
    """adc_rowmax_codes on one block, equal to adc_rowmax bit for bit (when
    the predecoded twin ``adc`` is given)."""
    from msu_latentafis_tpu_torch.matcher.kernels import ops
    NL, Lt, D = adc_codes["x"].shape
    B, Rt = adc_codes["rsq"].shape
    r = hold(lambda: ops.adc_rowmax_codes(**adc_codes),
             lambda: ops.adc_rowmax_codes_plain(**adc_codes),
             lambda: rowmax_library(**adc_codes), reps,
             twin=None if adc is None else lambda: ops.adc_rowmax(**adc))
    r["bound"] = bound(2.0 * NL * B * Lt * Rt * D,
                       tensor_bytes(adc_codes) + r["out_bytes"],
                       peak_of(adc_codes["x"]))
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
                atol=max(r.get("atol", TOL["atol"]) for r, _ in parts),
                ok=all(r["ok"] for r, _ in parts), ms=mean("ms"),
                plain_ms=mean("plain_ms"), library_ms=mean("library_ms"),
                bound=(sum(r["bound"][0] * w for r, w in parts) / n,
                       max(parts, key=lambda p: p[1])[0]["bound"][1]))


def chunk_shapes(engine, G: int) -> list:
    """(first entry, how many such launches) of _screen_all's launches over
    G entries: its full chunks and its tail chunk."""
    C = engine.screen_chunk
    return ([(0, G // C)] if G >= C else []) + (
        [(G - G % C, 1)] if G % C else [])


def check_records(label: str, rec: dict) -> None:
    for name, r in rec.items():
        atol = r.get("atol", TOL["atol"])
        kind = "" if atol == TOL["atol"] else " (tensor-core slack, max)"
        log(f"[{label}] {name}: max_abs_err {r['max_abs_err']:.3e} "
            f"(tol rtol {TOL['rtol']} atol {atol:.3e}{kind}) ok={r['ok']} "
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
    L = engine.latent_side(engine.latent_batch(lats), pre)
    minu, adc, tex = engine.block_args(L, pre, 0)
    rec = dense_records(minu, adc, tex, reps=20)
    rows = slice(0, 64)
    mscr, sadc = engine.screen_args(L, pre, rows)
    sadc_codes = engine.screen_args(L, codes, rows)[1]
    rec.update(screen_records(mscr, sadc, sadc_codes, step=64, reps=20))
    rec["adc_rowmax_codes"] = rowmax_codes_record(
        engine.block_args(L, codes, 0)[1], adc, reps=20)
    rec["minu_screen_norm"] = norm_record(mscr, 64, reps=20)
    check_records("kernels, one block", rec)
    log(f"[kernels] adc library (matmul + max) vs plain max diff "
        f"{rec['adc_rowmax']['library_err']:.3e}")
    check_records("kernels, standalone filter (one block: 384 sets; infuse "
                  "6 templates x 64 entries)",
                  filter_block_records(rng, engine.device, 384, reps=10))
    check_records("kernels, large prints (3 templates x 16 entries)",
                  large_print_records(rng, engine.device, reps=5))


def phase_cli(cb, rng, workdir):
    """64 rolled .dat files (one planted mate, one impostor of 1,000
    minutiae, the reference's largest rolled print) through cli.main."""
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
    mate_idx, big_idx = 37, 12
    for j in range(64):
        mated = j == mate_idx
        r = make_rolled_template(
            rng, n_minu=1000 if j == big_idx else int(rng.integers(50, 97)),
            n_tex=int(rng.integers(300, 449)),
            mated_latent=lat if mated else None,
            codebook=cb if mated else None)
        write_final_rolled_pq_template(os.path.join(gdir, f"r{j:03d}.dat"),
                                       to_pixels(r))
    write_final_latent_template(latf, to_pixels(lat))
    cfg = os.path.join(workdir, "afis.config")
    with open(cfg, "w") as f:
        json.dump({"CodebookPath": cbf, "ScorePath": os.path.join(
            workdir, "scores_config_bf16"), "MatchBlockSize": 64,
            "ComputeDtype": "bfloat16"}, f)
    for label, extra, kernels in (
            ("dense", [], ("minutiae_match", "adc_rowmax", "texture_match")),
            ("rerank 16", ["--rerank", "16"],
             ("minu_screen", "adc_screen", "minutiae_match", "adc_rowmax",
              "texture_match")),
            ("config bf16", ["--config", cfg],
             ("minutiae_match", "adc_rowmax", "texture_match"))):
        sdir = os.path.join(workdir, "scores_" + label.replace(" ", "_"))
        paths = [] if label == "config bf16" else ["-c", cbf, "-s", sdir]
        ops.reset_launch_counts()
        rc = cli.main(["match", "-l", latf, "-g", gdir, *paths, *extra])
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
        big = next((l for l in lines[1:] if f"r{big_idx:03d}," in l),
                   "no rank of the 24 written")
        log(f"[cli] {label}: mate r{mate_idx:03d} at rank 1 ({lines[1]}), "
            f"the 1,000-minutiae print r{big_idx:03d} at {big}, "
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
    L = engine.latent_side(engine.latent_batch(lats), gal)
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
    return counts, rec, (gal, codes), lats, mates, positions, scores


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


def serving_launched(label, counts, gal, normalize=False):
    """Serving launched every kernel of its gallery layout and screen."""
    minu = "minu_screen_norm" if normalize else "minu_screen"
    names = (minu, "adc_screen_codes", "adc_rowmax_codes",
             "minutiae_match", "texture_match") if gal.codes_resident else (
        minu, "adc_screen", "adc_rowmax", "minutiae_match", "texture_match")
    if min(counts[k] for k in names) <= 0:
        raise AssertionError(f"{label} skipped a kernel: {counts}")


def mate_ranks(idx, exact, positions) -> list:
    """Each latent's mate's rank among its kept exact scores (None when the
    screen dropped it)."""
    import numpy as np
    ranks = []
    for i, p in enumerate(positions):
        order = idx[i][np.argsort(-exact[i], kind="stable")]
        hit = np.nonzero(order == p)[0]
        ranks.append(int(hit[0]) + 1 if hit.size else None)
    return ranks


def phase_serving(engine, layouts, lats, positions, dense):
    """Screen-then-rerank on phase 3's gallery: the kept candidates' exact
    scores are the dense scores at those indices, bit for bit; the same
    gallery codes-resident gives the same results; normalize=True keeps
    exact scores equal to the dense ones too (its mates' ranks printed)."""
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
            ("serve 16k prescreen codes-resident", SERVE, codes),
            ("serve 16k normalize", dict(m=SERVE["m"], normalize=True), pre),
            ("serve 16k normalize prescreen", SERVE_NORM, pre)):
        norm = kw.get("normalize", False)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out[label] = idx, exact, margin, thr = \
            engine.match_scores_batch_reranked(lats, g, **kw)
        sec = time.perf_counter() - t0
        counts[label] = ops.launch_counts()
        serving_launched(label, counts[label], g, norm)
        if norm:
            log(f"[{label}] mates' ranks {mate_ranks(idx, exact, positions)} "
                f"(a heuristic screen: printed, not asserted)")
        else:
            mate_at_rank1(idx, exact, positions, label)
        for i in range(len(lats)):
            rows = torch.as_tensor(idx[i])
            if not torch.equal(torch.as_tensor(exact[i]), dense[i, rows]):
                raise AssertionError(f"{label}: exact != dense, latent {i}")
            if "prescreen_k" not in kw and not norm and not bool(
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
    L = engine.screen_side(lat, pre, SERVE["prescreen_lt"],
                           SERVE["prescreen_t"])
    G = pre.size
    shapes = chunk_shapes(engine, G)
    parts = {}
    for a, n in shapes:
        rows = slice(a, a + engine.screen_chunk)
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
    L1 = engine.latent_side({k: v[:1] for k, v in lat.items()}, codes)
    rec["adc_rowmax_codes"] = rowmax_codes_record(
        engine.block_args(L1, codes.take(sub), 0)[1],
        engine.block_args(L1, pre.take(sub), 0)[1], reps=10)
    check_records("kernels, serving (screens per launch over one call)", rec)

    # normalize=True serving on the predecoded gallery, same prescreen
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    first = engine.match_scores_batch_reranked(lats, pre, **SERVE_NORM)
    first_s = time.perf_counter() - t0
    counts["normalize"] = ops.launch_counts()
    serving_launched("normalize", counts["normalize"], pre, True)
    t0 = time.perf_counter()
    again = engine.match_scores_batch_reranked(lats, pre, **SERVE_NORM)
    steady_s = time.perf_counter() - t0
    if not all(np.array_equal(a, b, equal_nan=True)
               for a, b in zip(first, again)):
        raise AssertionError("normalize serving not repeatable")
    log(f"[scale] normalize=True predecoded: {SERVE_LATENTS} latents x "
        f"{pre.size} entries (m {SERVE['m']}, prescreen "
        f"{SERVE['prescreen_k']}/{SERVE['prescreen_lt']}/"
        f"{SERVE['prescreen_t']}): first {first_s:.3f} s, steady "
        f"{steady_s:.3f} s, {SERVE_LATENTS / steady_s:.2f} latents/s on "
        f"{card}; mates' ranks {mate_ranks(again[0], again[1], positions)} "
        f"(printed, not asserted); launches {counts['normalize']}")
    if counts["normalize"]["minu_screen_norm"] != n_launch:
        raise AssertionError(f"minu_screen_norm: "
                             f"{counts['normalize']['minu_screen_norm']} "
                             f"launches, expected {n_launch} chunks")
    parts = []
    for a, n in shapes:
        mscr = engine.screen_args(L, pre,
                                  slice(a, a + engine.screen_chunk))[0]
        r = norm_record(mscr, step=2048, reps=3)
        check_records(f"kernels, normalize serving screen ({SERVE_LATENTS} "
                      f"latents x {mscr['rdes'].shape[0]} entries, x{n} per "
                      f"call)", {"minu_screen_norm": r})
        parts.append((r, n))
    rec["minu_screen_norm"] = per_launch(parts)
    check_records("kernels, normalize serving (per launch over one call)",
                  {"minu_screen_norm": rec["minu_screen_norm"]})
    return counts, rec, lats, mates, positions


def phase_filters(engine, cb, rng, card):
    """The standalone graph filter at the two microbench scripts' shapes.
    The path: both scripts' runs (the packed kernel at stages 0-6 over
    24 x 512 sets of K 120 and 8 x 512 of K 200, the minutiae and texture
    kernels at the same sets), the xy / ori filter on the first shape's
    sets, and the infuse filter at NT 24 x B 512 x P 64 x R 96 with val and
    with simi. Then each held against its plain version (stages 0-5 on a
    slice of sets), and infuse after the port's exact selection against
    minutiae_match at row_cap = R on one block."""
    import numpy as np
    import torch
    from msu_latentafis_tpu_torch.matcher.kernels import ops
    from msu_latentafis_tpu_torch.matcher.minutiae_match import (
        minutiae_correspondence_indices, minutiae_similarity)
    from msu_latentafis_tpu_torch.scripts import microbench_body_stages as mbs
    from msu_latentafis_tpu_torch.scripts import microbench_filter as mbf
    from msu_latentafis_tpu_torch.utils.synthetic import (
        device_synthetic_gallery, plant_gallery_entries)
    dev = engine.device
    rng0 = np.random.default_rng(0)        # the stage script's sets
    shapes = {name: (dict(zip(("val", "gl", "gr", "li", "ri", "valid"),
                              mbs.make_sets(rng0, NP, K, lo, hi, dev))),
                     lookup, iters)
              for name, NP, K, lookup, iters, lo, hi in mbs.SHAPES}
    minu_sets = shapes["minu"][0]
    xy = dict(val=minu_sets["val"],
              lxy=minu_sets["gl"][..., :2].contiguous(),
              rxy=minu_sets["gr"][..., :2].contiguous(),
              lori=minu_sets["gl"][..., 2].contiguous(),
              rori=minu_sets["gr"][..., 2].contiguous(),
              li=minu_sets["li"], ri=minu_sets["ri"],
              valid=minu_sets["valid"], lookup=False, dist_iters=5)
    infuse = {k: dict(infuse_args(rng, 24, 512, 64, 96, 120, dev, k == "simi"),
                      lookup=False, dist_iters=5) for k in ("val", "simi")}
    torch.cuda.synchronize()

    emit = lambda line: log(f"[filters] {line}")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    stage_ms = mbs.run(emit, dev)
    mbf.run(emit, dev)
    emit(json.dumps({"variant": "graph_filter[NP=12288,K=120]", "ms": round(
        mbs.cuda_ms(lambda: ops.graph_filter(**xy)), 2)}))
    for k, a in infuse.items():
        emit(json.dumps({"variant": f"infuse/{k}[NT=24,B=512,K=120]",
                         "ms": round(mbs.cuda_ms(
                             lambda a=a: ops.graph_filter_infuse(**a)), 2)}))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"[filters] path {time.perf_counter() - t0:.1f} s on {card}; "
        f"launches {counts}")
    if min(counts[k] for k in ("graph_filter_packed", "graph_filter",
                               "graph_filter_infuse", "minutiae_match",
                               "texture_match")) <= 0:
        raise AssertionError(f"filter path skipped a kernel: {counts}")

    # every stage of both shapes on a slice of 512 sets
    worst = 0.0
    for name, (sets, lookup, iters) in shapes.items():
        part = {k: v[:512] for k, v in sets.items()}
        for st in mbs.STAGES:
            got = ops.graph_filter_packed(**part, lookup=lookup,
                                          dist_iters=iters, stages=st)
            want = ops.graph_filter_packed_plain(**part, lookup=lookup,
                                                 dist_iters=iters, stages=st)
            err = float((got - want).abs().max())
            worst = max(worst, err)
            if not torch.allclose(got, want, **TOL):
                raise AssertionError(f"packed {name} stage {st}: {err}")
        log(f"[filters] {name}: stages 0-6 on 512 sets equal their plain "
            f"versions; kernel ms per stage {[round(stage_ms[(name, st)], 4) for st in mbs.STAGES]}")
    log(f"[filters] stage holds: max_abs_err {worst:.3e}")
    rec = {"graph_filter_packed": filter_record(
        ops.graph_filter_packed, ops.graph_filter_packed_plain,
        dict(minu_sets, lookup=False, dist_iters=5), 4, 2048, SET_DIMS, 0),
        "graph_filter": filter_record(ops.graph_filter,
                                      ops.graph_filter_plain, xy, 4, 2048,
                                      SET_DIMS, 0)}
    for k, a in infuse.items():
        name = "graph_filter_infuse" + ("" if k == "val" else " simi")
        rec[name] = filter_record(ops.graph_filter_infuse,
                                  ops.graph_filter_infuse_plain, a, 4, 64,
                                  INFUSE_DIMS, 1)
    check_records("kernels, filter path (24 x 512 sets of K 120; infuse "
                  "24 x 512 x 64 x 96)", rec)

    # infuse after the port's exact selection == minutiae_match, row_cap R
    lats, mates = make_latents(rng, 2, cb)
    gal = device_synthetic_gallery(engine, 64, seed=4)
    plant_gallery_entries(gal, engine, mates, [0, 1])
    L = engine.latent_side(engine.latent_batch(lats), gal)
    minu = engine.block_args(L, gal, 0)[0]
    R = minu["rdes"].shape[1]
    simi = minutiae_similarity(minu["ldes"], minu["lvalid"], minu["rdes"],
                               minu["rvalid"])
    li, ri, valid = minutiae_correspondence_indices(
        simi, minu["lvalid"] > 0.5, minu["rvalid"] > 0.5,
        top_n=minu["top_n"])
    got = ops.graph_filter_infuse(
        None, li, ri, valid, minu["lpack"].transpose(1, 2).contiguous(),
        minu["rpack"].transpose(1, 2).contiguous(), False, 5, simi=simi)
    want = ops.minutiae_match(**dict(minu, row_cap=R))
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    log(f"[filters] infuse after exact selection vs minutiae_match at "
        f"row_cap {R} ({tuple(got.shape)} pairs): max_abs_err {err:.3e} "
        f"(rtol 1e-4 atol 1e-4); mates' best templates "
        f"{got[:3, 0].max().item():.3f} / {got[3:, 1].max().item():.3f}")
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"infuse after selection != minutiae_match: "
                             f"{err}")
    return counts, rec


def typed_engine(cb, **kw):
    """The port's engine in a throughput mode on the card, block 64."""
    import torch
    from msu_latentafis_tpu_torch.matcher.engine import MatchEngine
    return MatchEngine(cb, block_size=64, compute_dtype=torch.bfloat16,
                       device="cuda", **kw)


def timed(fn):
    """The main path fn() with the launch counts set to 0 just before it:
    (result, seconds, the counts just after it, steady seconds of a second
    call, which must give the same result)."""
    import numpy as np
    import torch
    from msu_latentafis_tpu_torch.matcher.kernels import ops
    out = []
    for _ in range(2):
        if not out:
            ops.reset_launch_counts()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out.append((r, time.perf_counter() - t0, ops.launch_counts()))
    a, b = out[0][0], out[1][0]
    same = torch.equal(a, b) if isinstance(a, torch.Tensor) else all(
        np.array_equal(x, y, equal_nan=True) for x, y in zip(a, b))
    if not same:
        raise AssertionError("results not repeatable")
    return a, out[0][1], out[0][2], out[1][1]


def phase_modes_dense(cb, card, lats, mates, positions, dense32):
    """Phase 3's gallery (seed 2: the same f32 values) and latents in bf16,
    bf16 + tex_int8 and bf16 + minu_int8, dense; the typed dense kernels
    held and timed as this path launches them."""
    import torch
    from msu_latentafis_tpu_torch.utils.synthetic import (
        device_synthetic_gallery, plant_gallery_entries)
    n_real = GALLERY_G
    ref32 = dense32[:, :n_real].cpu()
    scores, counts, parts = {}, {}, {}
    for label, kw in (("bf16", {}), ("bf16+tex_int8", dict(tex_int8=True)),
                      ("bf16+minu_int8", dict(minu_int8=True))):
        e = typed_engine(cb, **kw)
        gal = device_synthetic_gallery(e, GALLERY_G, seed=2)
        plant_gallery_entries(gal, e, mates, positions)
        s, first_s, counts[label], steady_s = timed(
            lambda: e.match_scores_batch(lats, gal))
        if min(counts[label][k] for k in DENSE_KERNELS) <= 0 or any(
                counts[label][k] for k in counts[label]
                if k not in DENSE_KERNELS):
            raise AssertionError(f"{label}: launches {counts[label]}")
        s = s[:, :n_real].cpu()
        scores[label] = s
        if not torch.isfinite(s).all():
            raise AssertionError(f"{label}: scores not finite")
        for i, p in enumerate(positions):
            srt = torch.sort(s[i], descending=True).values
            if int(torch.argmax(s[i])) != p or not float(s[i, p]) > float(
                    srt[1]):
                raise AssertionError(f"{label}: latent {i}'s mate not at "
                                     f"rank 1")
        log(f"[modes dense] {label}: {len(lats)} latents x {gal.size} "
            f"entries (minu_des {gal.minu_des.dtype}, tex_dec "
            f"{gal.tex_dec.dtype}): first {first_s:.3f} s, steady "
            f"{steady_s:.3f} s, {len(lats) / steady_s:.2f} latents/s on "
            f"{card}; mates at rank 1, scores "
            f"{[round(float(s[i, p]), 3) for i, p in enumerate(positions)]}; "
            f"launches {counts[label]}")
        if label == "bf16":
            continue
        profile_call(f"dense {label}",
                     lambda: e.match_scores_batch(lats, gal))
        L = e.latent_side(e.latent_batch(lats), gal)
        B = e.block_size
        mated = {p // B for p in positions}
        unmated = next(b for b in range(gal.size // B) if b not in mated)
        for b, n in ((unmated, gal.size // B - len(mated)),
                     (positions[0] // B, len(mated))):
            rec = dense_records(*e.block_args(L, gal, b * B), reps=10)
            check_records(f"kernels, {label} dense ({len(lats)} latents x "
                          f"{B} entries at {b * B}, x{n} per call)", rec)
            for name, r in rec.items():
                if name != "texture_match":
                    parts.setdefault(name, []).append((r, n))
                    counts.setdefault("typed", {})[name] = \
                        counts[label][name.split("[")[0]]
        del gal
        torch.cuda.empty_cache()

    # Each mode against its reference as tests/test_int8_mode.py judges it
    # (tex_int8: rtol 0.05 / atol 0.3, reference bf16; minu_int8 and bf16:
    # f32): on 6 entries there every score holds; at 65,536 pairs the
    # modes' rounding flips some impostors' correspondence selections, in
    # the JAX engine as in the port (PERF.md, ROADMAP Queue 3), so the
    # counts outside are printed and what holds at scale is held: the
    # rank-1 entries and the mates' scores, and minu_int8's impostors under
    # a tenth of the mate.
    t8, b16, m8 = (scores[k] for k in ("bf16+tex_int8", "bf16",
                                       "bf16+minu_int8"))
    for label, s, ref, ref_label in (("bf16+tex_int8", t8, b16, "bf16"),
                                     ("bf16", b16, ref32, "f32"),
                                     ("bf16+tex_int8", t8, ref32, "f32"),
                                     ("bf16+minu_int8", m8, ref32, "f32")):
        d = (s - ref).abs()
        over = d > 0.3 + 0.05 * ref.abs()
        worst = torch.topk(d.flatten(), 3)
        log(f"[modes dense] {label} vs {ref_label}: max |diff| "
            f"{float(d.max()):.4f}, {int(over.sum())} of {d.numel()} scores "
            f"outside rtol 0.05 / atol 0.3; largest diffs "
            f"{[round(float(v), 3) for v in worst.values]} at scores "
            f"{[round(float(ref.flatten()[i]), 3) for i in worst.indices]}")
    for i, p in enumerate(positions):
        if not (torch.allclose(t8[i, p], b16[i, p], rtol=0.05)
                and torch.allclose(t8[i, p], ref32[i, p], rtol=0.05)
                and torch.allclose(m8[i, p], ref32[i, p], rtol=0.02)):
            raise AssertionError(f"latent {i}: a mode's mate score leaves "
                                 f"its reference's")
        others = torch.cat([m8[i, :p], m8[i, p + 1:]])
        if not bool((others < 0.1 * m8[i, p]).all()):
            raise AssertionError(f"minu_int8 latent {i}: an impostor above "
                                 f"a tenth of the mate")
    log("[modes dense] every mode's rank 1 is f32's (the mates); tex_int8 "
        "mates within rtol 0.05 of bf16 and f32, minu_int8 mates within "
        "rtol 0.02 of f32, its impostors under a tenth of the mate")
    rec = {name: per_launch(p) for name, p in parts.items()}
    check_records("kernels, modes dense (per launch over one call)", rec)
    return counts.get("typed", {}), rec


def phase_modes_serving(cb, card, lats, mates, positions):
    """bf16 + tex_int8 predecoded serving on phase 5's gallery (seed 3) and
    latents at the JAX bench's code defaults; the typed screens held per
    chunk; normalize=True serving in the same mode."""
    import numpy as np
    import torch
    from msu_latentafis_tpu_torch.utils.synthetic import (
        device_synthetic_gallery, plant_gallery_entries)
    e = typed_engine(cb, tex_int8=True)
    t0 = time.perf_counter()
    pre = device_synthetic_gallery(e, SERVE_G, seed=3)
    plant_gallery_entries(pre, e, mates, positions)
    torch.cuda.synchronize()
    log(f"[modes serving] gallery {SERVE_G} (bf16 minutiae, int8 texture) "
        f"built in {time.perf_counter() - t0:.2f} s: tex_dec "
        f"{nbytes(pre.tex_dec) / 1e9:.2f} GB, minu_des "
        f"{nbytes(pre.minu_des) / 1e9:.2f} GB")
    counts = {}
    for label, kw in (("bf16+tex_int8", SERVE_BENCH),
                      ("bf16+tex_int8 normalize",
                       dict(SERVE_BENCH, normalize=True))):
        out, first_s, counts[label], steady_s = timed(
            lambda: e.match_scores_batch_reranked(lats, pre, **kw))
        serving_launched(label, counts[label], pre, "normalize" in kw)
        idx, exact = out[0], out[1]
        if "normalize" in kw:
            log(f"[modes serving] {label}: mates' ranks "
                f"{mate_ranks(idx, exact, positions)} (printed, not "
                f"asserted)")
        else:
            mate_at_rank1(idx, exact, positions, f"modes serving {label}")
        log(f"[modes serving] {label}: {len(lats)} latents x {pre.size} "
            f"entries (m {kw['m']}, prescreen {kw['prescreen_k']}/"
            f"{kw['prescreen_lt']}/{kw['prescreen_t']}): first "
            f"{first_s:.3f} s, steady {steady_s:.3f} s, "
            f"{len(lats) / steady_s:.2f} latents/s on {card}; launches "
            f"{counts[label]}")
        if "normalize" not in kw:
            profile_call(f"serve 100k {label}",
                         lambda: e.match_scores_batch_reranked(lats, pre,
                                                               **kw))
            dense = e.match_scores_batch(lats, pre).cpu()
            for i in range(len(lats)):
                if not torch.equal(torch.as_tensor(exact[i]),
                                   dense[i, torch.as_tensor(idx[i])]):
                    raise AssertionError(f"{label}: exact != dense, latent "
                                         f"{i}")
            log(f"[modes serving] {label}: kept exact scores equal the "
                f"mode's dense scores at the kept indices")
            if not np.isnan(out[2]).all():
                raise AssertionError("prescreen margins must be NaN")

    lat = e.latent_batch(lats)
    L = e.screen_side(lat, pre, SERVE_BENCH["prescreen_lt"],
                      SERVE_BENCH["prescreen_t"])
    shapes = chunk_shapes(e, pre.size)
    parts = {}
    for a, n in shapes:
        rows = slice(a, a + e.screen_chunk)
        mscr, sadc = e.screen_args(L, pre, rows)
        rec = screen_records(mscr, sadc, None, step=2048, reps=3)
        topk_set_diffs("modes serving", e, pre, L, rows, rec)
        rec[tag("minu_screen_norm", mscr["ldes"], mscr["rdes"])] = \
            norm_record(mscr, 2048, 3)
        check_records(f"kernels, modes serving screens ({len(lats)} latents "
                      f"x {mscr['rdes'].shape[0]} entries, x{n} per call)",
                      rec)
        for name, r in rec.items():
            parts.setdefault(name, []).append((r, n))
    rec = {name: per_launch(p) for name, p in parts.items()}
    check_records("kernels, modes serving (per launch over one call)", rec)
    n_launch = sum(n for _, n in shapes)
    launches = {}
    for name in rec:
        base = name.split("[")[0]
        src = "bf16+tex_int8 normalize" if base == "minu_screen_norm" \
            else "bf16+tex_int8"
        launches[name] = counts[src][base]
        if launches[name] != n_launch:
            raise AssertionError(f"{name}: {launches[name]} launches, "
                                 f"expected {n_launch} chunks")

    # the predecoded screen's two other typed pairs on their serving paths
    # (bf16 compute without tex_int8, f32 with tex_int8), each over one
    # screen chunk of its own gallery with the mates planted
    from msu_latentafis_tpu_torch.matcher.engine import MatchEngine
    del pre
    torch.cuda.empty_cache()
    for label, kw in (("bf16", dict(compute_dtype=torch.bfloat16)),
                      ("f32+tex_int8", dict(tex_int8=True))):
        e2 = MatchEngine(cb, block_size=64, device="cuda", **kw)
        G2 = e2.screen_chunk
        pos2 = [int(G2 * (i + 0.5) / len(lats)) + 7 * i
                for i in range(len(lats))]
        g2 = device_synthetic_gallery(e2, G2, seed=3)
        plant_gallery_entries(g2, e2, mates, pos2)
        out, first_s, c, steady_s = timed(
            lambda: e2.match_scores_batch_reranked(lats, g2, **SERVE_BENCH))
        serving_launched(label, c, g2)
        mate_at_rank1(out[0], out[1], pos2, f"modes serving {label}")
        log(f"[modes serving] {label}: {len(lats)} latents x {g2.size} "
            f"entries (m {SERVE_BENCH['m']}, prescreen "
            f"{SERVE_BENCH['prescreen_k']}/{SERVE_BENCH['prescreen_lt']}/"
            f"{SERVE_BENCH['prescreen_t']}): first {first_s:.3f} s, steady "
            f"{steady_s:.3f} s, {len(lats) / steady_s:.2f} latents/s on "
            f"{card}; launches {c}")
        L2 = e2.screen_side(e2.latent_batch(lats), g2,
                            SERVE_BENCH["prescreen_lt"],
                            SERVE_BENCH["prescreen_t"])
        r = screen_records(None, e2.screen_args(L2, g2, slice(0, G2))[1],
                           None, step=2048, reps=3)
        check_records(f"kernels, {label} serving screen ({len(lats)} "
                      f"latents x {G2} entries, x1 per call)", r)
        for name, rr in r.items():
            rec[name] = rr
            launches[name] = c["adc_screen"]
        if c["adc_screen"] != 1:
            raise AssertionError(f"{label}: {c['adc_screen']} adc_screen "
                                 f"launches, expected 1 chunk")
        del g2
        torch.cuda.empty_cache()
    return launches, rec


def phase_cap(cb, rng, card):
    """The reference-cap shape, codes-resident, minu_int8, bf16: serving 8
    latents over 16,384 entries at the JAX bench's code defaults; the typed
    codes kernels held."""
    import torch
    from msu_latentafis_tpu_torch.matcher.kernels import ops
    from msu_latentafis_tpu_torch.utils.synthetic import (
        device_synthetic_gallery, plant_gallery_entries)
    e = typed_engine(cb, minu_int8=True, codes_resident=True)
    t0 = time.perf_counter()
    gal = device_synthetic_gallery(e, CAP_G, n_minu=CAP["Rm"],
                                   n_tex=CAP["Rt"], seed=5,
                                   both_layouts=True)[1]
    lats, mates = make_latents(rng, SERVE_LATENTS, cb, CAP["Lm"], CAP["Lt"],
                               CAP["Rm"], CAP["Rt"])
    positions = [int(CAP_G * (i + 0.5) / SERVE_LATENTS) + 5 * i
                 for i in range(SERVE_LATENTS)]
    plant_gallery_entries(gal, e, mates, positions)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    log(f"[cap] gallery {CAP_G} x (Rm {CAP['Rm']}, Rt {CAP['Rt']}, D 96) "
        f"codes-resident, int8 minutiae, built in "
        f"{time.perf_counter() - t0:.2f} s: tex_codes "
        f"{nbytes(gal.tex_codes) / 1e9:.2f} GB, minu_des "
        f"{nbytes(gal.minu_des) / 1e9:.2f} GB ({CAP_G} entries, not the "
        f"bench's 100,000)")
    out, first_s, counts, steady_s = timed(
        lambda: e.match_scores_batch_reranked(lats, gal, **SERVE_BENCH))
    serving_launched("cap", counts, gal)
    mate_at_rank1(out[0], out[1], positions, "cap")
    log(f"[cap] {SERVE_LATENTS} latents x {gal.size} entries (Lm {CAP['Lm']} "
        f"Lt {CAP['Lt']}; m {SERVE_BENCH['m']}, prescreen "
        f"{SERVE_BENCH['prescreen_k']}/{SERVE_BENCH['prescreen_lt']}/"
        f"{SERVE_BENCH['prescreen_t']}): first {first_s:.3f} s, steady "
        f"{steady_s:.3f} s, {SERVE_LATENTS / steady_s:.2f} latents/s on "
        f"{card}; mates' ranks {mate_ranks(out[0], out[1], positions)}; "
        f"launches {counts}")
    profile_call("serve cap 16k",
                 lambda: e.match_scores_batch_reranked(lats, gal,
                                                       **SERVE_BENCH))
    lat = e.latent_batch(lats)
    L = e.screen_side(lat, gal, SERVE_BENCH["prescreen_lt"],
                      SERVE_BENCH["prescreen_t"])
    rows = slice(0, e.screen_chunk)
    mscr, cadc = e.screen_args(L, gal, rows)
    rec = screen_records(mscr, None, cadc, step=1024, reps=3)
    topk_set_diffs("cap", e, gal, L, rows, rec)
    sub = torch.as_tensor(out[0][0, :e.block_size], device=e.device)
    L1 = e.latent_side({k: v[:1] for k, v in lat.items()}, gal)
    minu, cadc1, _ = e.block_args(L1, gal.take(sub), 0)
    rec[tag("adc_rowmax_codes", cadc1["x"])] = \
        rowmax_codes_record(cadc1, None, reps=5)
    check_records(f"kernels, cap serving (screens on {gal.size} entries; "
                  f"rerank 1 latent x {e.block_size} entries)", rec)
    stats = {}
    r = hold(lambda: ops.minutiae_match(**minu),
             lambda: ops.minutiae_match_plain(stats=stats, **minu), None, 5)
    check_records("kernels, cap rerank (1 latent x 64 entries; not in the "
                  "kernels line: the 448 path holds this type pair)",
                  {tag("minutiae_match", minu["ldes"], minu["rdes"]):
                   dict(r, bound=(0.0, "not computed"))})
    launches = {name: counts[name.split("[")[0]] for name in rec}
    return launches, rec


def phase_scripts(engine, card):
    """The ported experiment and probe scripts and the launch canary, as
    their main paths; then each kernel held against its plain version at
    those shapes."""
    import numpy as np
    import torch
    from msu_latentafis_tpu_torch.matcher.kernels import ops
    from msu_latentafis_tpu_torch.scripts import exp_screen_mfu as esm
    from msu_latentafis_tpu_torch.scripts import microbench_h1_probe as h1p
    dev = engine.device
    emit = lambda line: log(f"[scripts] {line}")
    x = torch.randn((8, 128, 448), device=dev)
    limit = ops.max_smem_optin()
    ops.reset_launch_counts()
    esm.run(emit, dev)
    probe = h1p.run(emit, dev)
    legal = (dict(threads=256, smem_bytes=0),
             dict(threads=256, smem_bytes=limit))
    for plan in legal:
        if not torch.equal(ops.legality_canary(x, **plan), x):
            raise AssertionError(f"canary: legal plan {plan} did not copy")
    for plan in (dict(threads=256, smem_bytes=limit + 4),
                 dict(threads=2048, smem_bytes=0)):
        try:
            ops.legality_canary(x, **plan)
        except RuntimeError as err:
            emit(f"canary: plan {plan} refused as it must be: {err}")
        else:
            raise AssertionError(f"canary: plan {plan} above the card's "
                                 f"limits (shared memory opt-in {limit} "
                                 f"bytes) did not raise")
    if not torch.equal(ops.legality_canary(x, 128, 4096), x):
        raise AssertionError("canary: the launch after a refused one failed")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    emit(f"canary: legal plans copy bit for bit (opt-in limit {limit} "
         f"bytes); launches {counts}")
    if not probe["matmul_exact"]:
        raise AssertionError("h1 probe: matmul != bcast")
    if min(counts[k] for k in ("screen_t_bf16", "screen_t_int8", "h1_probe",
                               "legality_canary", "adc_screen")) <= 0:
        raise AssertionError(f"scripts skipped a kernel: {counts}")

    a = esm.make_inputs(np.random.default_rng(0), dev)
    B = a["dec"].shape[0]
    M = esm.NL * esm.Lt
    rec = {}
    xt, dect = ops.screen_t_operands(a["x"], a["dec"], a["rsq"], a["rvalid"])
    step = 256

    def by_dect(fn, xt_, *ts):
        """fn over ``step`` entries of dect (and corr) at a time."""
        return lambda: torch.cat([fn(xt_, *(t[s:s + step] for t in ts))
                                  for s in range(0, B, step)])

    def lib_bf16(xt_, d):
        return torch.matmul(d, xt_).float().amax(dim=1)
    r = hold(lambda: ops.screen_t_bf16(xt, dect),
             by_dect(ops.screen_t_bf16_plain, xt, dect),
             by_dect(lib_bf16, xt, dect), 3,
             atol=ops.screen_t_tol(xt, dect, step))
    r["bound"] = bound(2.0 * B * dect.shape[1] * M * dect.shape[2],
                       nbytes(xt, dect) + r["out_bytes"], PEAK_BF16_FLOPS)
    rec["screen_t_bf16"] = r
    xq, dq, corr, _ = ops.screen_t_operands(a["x"], a["dec"], a["rsq"],
                                            a["rvalid"], int8=True)

    def lib_int8(xt_, d, c):
        S, Rt, D = d.shape
        dots = torch._int_mm(d.reshape(S * Rt, D), xt_)
        return (dots.reshape(S, Rt, -1) + c[:, :, None]).amax(dim=1)
    lib = by_dect(lib_int8, xq, dq, corr)
    try:
        lib()
    except (RuntimeError, AttributeError) as err:
        emit(f"screen_t_int8: no library int8 GEMM here ({err})")
        lib = None
    r = hold(lambda: ops.screen_t_int8(xq, dq, corr),
             by_dect(ops.screen_t_int8_plain, xq, dq, corr), lib, 3)
    r["bound"] = bound(2.0 * B * dq.shape[1] * M * dq.shape[2],
                       nbytes(xq, dq, corr) + r["out_bytes"], PEAK_INT8_OPS)
    rec["screen_t_int8"] = r

    p = h1p.make_inputs(np.random.default_rng(0), dev)
    NP, K = p["lx"].shape
    parts = []
    for v in ops.H1_VARIANTS:
        r = hold(lambda v=v: ops.h1_probe(**p, variant=v),
                 by_slices(ops.h1_probe_plain, dict(p, variant=v), 512, NP,
                           {k: 0 for k in p}, 0), None, 5)
        r["bound"] = bound(30.0 * float((p["vf"].sum(1) ** 2).sum()),
                           nbytes(*p.values()) + r["out_bytes"])
        check_records(f"kernels, h1 probe {v} ({NP} sets of K {K})",
                      {f"h1_probe {v}": r})
        parts.append((r, 1))
    rec["h1_probe"] = per_launch(parts)
    y = torch.empty_like(x)
    r = hold(lambda: ops.legality_canary(x, 256, limit),
             lambda: ops.legality_canary_plain(x), lambda: y.copy_(x), 10)
    r["bound"] = bound(0.0, 2.0 * nbytes(x))
    rec["legality_canary"] = r
    check_records("kernels, scripts (exp_screen_mfu at B 4096; h1 probe "
                  "mean over its 3 variants; canary copy)", rec)
    return {k: counts[k] for k in rec}, rec


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
        if m:                    # mangled: <name>_kernel[I<types>...]
            sym = m.group(1)
            k = re.search(r"(minu_screen_tc|screen_tc|screen_f32|adc_rowmax|"
                          r"adc_screen|"
                          r"minu_screen_norm|"
                          r"minu_screen|minutiae_match|texture_match|"
                          r"graph_filter_infuse|graph_filter|screen_t_bf16|"
                          r"screen_t_int8|h1_probe|canary_copy)_kernel",
                          sym)
            name = sym[:80] if k is None else \
                k.group(0) + sym[k.end():k.end() + 48]
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
    counts, rec, layouts, lats, mates, positions, dense = phase_engine(
        engine, cb, rng, card)
    log(f"[phase 3] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_serving(engine, layouts, lats, positions, dense)
    log(f"[phase 4] {time.perf_counter() - t0:.1f} s")
    del layouts
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    scale, serve_rec, s_lats, s_mates, s_positions = phase_scale(
        engine, cb, rng, card)
    log(f"[phase 5] {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    filt, filt_rec = phase_filters(engine, cb, rng, card)
    log(f"[phase 6] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    modes_counts, modes_rec = phase_modes_dense(cb, card, lats, mates,
                                                positions, dense)
    log(f"[phase 7] {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mserve_counts, mserve_rec = phase_modes_serving(cb, card, s_lats,
                                                    s_mates, s_positions)
    log(f"[phase 8] {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cap_counts, cap_rec = phase_cap(cb, rng, card)
    log(f"[phase 9] {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    script_counts, script_rec = phase_scripts(engine, card)
    log(f"[phase 10] {time.perf_counter() - t0:.1f} s")
    # each kernel's launches and numbers on the main path that runs it: the
    # dense match (phase 3), 100,000-entry serving in its layout or with
    # normalize=True (phase 5), the standalone filter path (phase 6), the
    # modes' dense match (phase 7), serving (phase 8) and cap serving
    # (phase 9), the scripts (phase 10)
    rec.update(serve_rec)
    rec.update(filt_rec)
    for k in ("minu_screen", "adc_screen"):
        counts[k] = scale["predecoded"][k]
    for k in ("adc_screen_codes", "adc_rowmax_codes"):
        counts[k] = scale["codes-resident"][k]
    counts["minu_screen_norm"] = scale["normalize"]["minu_screen_norm"]
    for k in ("graph_filter_packed", "graph_filter", "graph_filter_infuse"):
        counts[k] = filt[k]
    for c, r in ((modes_counts, modes_rec), (mserve_counts, mserve_rec),
                 (cap_counts, cap_rec), (script_counts, script_rec)):
        counts.update(c)
        rec.update(r)

    kernels = []
    line = [n for n in rec if n.split("[")[0] in KERNEL_META]
    for name in sorted(line, key=lambda n: (
            list(KERNEL_META).index(n.split("[")[0]), n)):
        src, replaces = KERNEL_META[name.split("[")[0]]
        r = rec[name]
        kernels.append(dict(
            name=name, route="cuda",
            source=f"msu_latentafis_tpu_torch/matcher/kernels/csrc/{src}",
            replaces=replaces, launches=counts[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=r["library_ms"]))
        if name in SHARED_SOURCE:
            kernels[-1]["shares_source_with"] = SHARED_SOURCE[name]
    for k in kernels:
        if k["name"] in BEFORE_MS:
            log(f"[redesigned] {k['name']}: {k['ms']:.4f} ms per launch "
                f"(before: {BEFORE_MS[k['name']]} ms), bound "
                f"{k['bound_ms']:.4f} ms ({k['bound_by']}), library "
                f"{k['library_ms']} ms, plain {k['plain_ms']:.2f} ms, "
                f"max_abs_err {k['max_abs_err']:.3e}, {k['launches']} "
                f"launches, on {card}")
    missing = set(KERNEL_META) - {k["name"].split("[")[0] for k in kernels}
    if missing or min(k["launches"] for k in kernels) <= 0:
        raise AssertionError(f"kernels line incomplete: missing {missing}, "
                             f"launches {counts}")
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
