"""Command-line interface of the port: 1:N and N:N matching.

    python -m msu_latentafis_tpu_torch.cli match (-l LATENT.dat | -ldir DIR) \
        -g GALLERY_DIR [-c CODEBOOK.dat] [-s SCORE_DIR] [--config FILE] \
        [--device cpu] [--trace DIR] \
        [--rerank M [--prescreen K --prescreen-lt 64 --prescreen-t 1]]

The reference's matching entry point (matching/main.cpp:35-87), as the
JAX package's ``match`` runs it. The gallery is every rolled ``.dat`` in
``-g``, read by the native C++ loader (``templates/native_io``, built with
g++ at first use) or, where it cannot be built, by the Python packer; the
CLI prints which loader ran.

- ``-l`` (One2List): scores one final latent ``.dat`` against the
  gallery, writes ``SCORE_DIR/<latent>.csv`` (the ranked top-24), prints
  the top-24 table and writes ``SCORE_DIR/corr<latent>_<name>_<i>.csv``
  for each of the top-24 candidates and selected latent minutiae template
  i (rows ``lx,ly,rx,ry``, the reference's save_corr files). Without
  ``--rerank`` every entry gets the exact dense score; with it,
  screen-then-rerank serving gives exact scores to the top M screened
  entries only, and ``--prescreen`` makes the screen two-stage.
- ``-ldir`` (List2List, used when ``-l`` is not given): every ``.dat`` in
  the directory against the gallery through ``MatchEngine.list_to_list``
  (latents padded to shape buckets, batches of 8), one
  ``SCORE_DIR/<latent>.csv`` per latent with every entry's
  ``<name>,<score>``.

A latent with no template writes ``0`` to its CSV. The CLI prints the
seconds of each phase (load gallery, read latents, match, correspondence
files) and logs JSON event lines on stderr: each latent's score
statistics, then the phases and the run's counters. ``--trace DIR``
writes a ``torch.profiler`` trace of the matching to ``DIR/trace.json``.
``-c`` and ``-s``
default to the config's ``CodebookPath`` and ``ScorePath``; the config
(``--config``, else an ``afis.config`` found from the working directory
up) also gives ``MatchBlockSize`` and ``ComputeDtype``: "bfloat16" runs
every kernel on bf16 operands, as the JAX CLI does.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import List, Optional

import torch

from .config import load_config
from .matcher.engine import (MatchEngine, write_corr_files, write_rank_csv,
                             write_score_csv)
from .templates import (pack_gallery, pack_latent, read_codebook,
                        read_final_template)
from .templates.native_io import pack_gallery_native
from .utils.logging import count, counters, event, score_stats
from .utils.timing import PhaseTimer, device_trace


def load_gallery_dir(engine: MatchEngine, gallery_dir: str):
    """-> (DeviceGallery, {name: file}, loader): the native loader where
    it builds, else the Python packer."""
    files = sorted(glob.glob(os.path.join(gallery_dir, "*.dat")))
    if not files:
        raise FileNotFoundError(f"no .dat files in {gallery_dir}")
    names = [os.path.splitext(os.path.basename(f))[0] for f in files]
    packed, loader = pack_gallery_native(gallery_dir, engine.codebook), \
        "native"
    if packed is None:
        templates = [read_final_template(f, kind="rolled") for f in files]
        packed, loader = pack_gallery(templates, engine.codebook,
                                      names=names), "python"
    return engine.load_gallery(packed), dict(zip(names, files)), loader


def cmd_match(args) -> int:
    cfg = load_config(args.config)
    codebook = args.codebook or cfg.CodebookPath
    scores = args.scores or cfg.ScorePath
    if not codebook or not scores:
        raise SystemExit("match: give -c and -s, or a config with "
                         "CodebookPath and ScorePath")
    os.makedirs(scores, exist_ok=True)
    engine = MatchEngine(read_codebook(codebook),
                         block_size=cfg.MatchBlockSize,
                         compute_dtype=torch.bfloat16
                         if cfg.ComputeDtype == "bfloat16" else torch.float32,
                         device=args.device)
    timer = PhaseTimer()
    with timer.phase("load gallery"):
        gallery, gallery_files, loader = load_gallery_dir(engine,
                                                          args.gallery)
    print(f"Gallery size: {gallery.n_real} (loaded in "
          f"{timer.buckets['load gallery']:.2f}s, {loader} loader)")

    latent_files = [args.latent] if args.latent else \
        sorted(glob.glob(os.path.join(args.ldir, "*.dat")))
    todo = []                       # (name, template, packed)
    with timer.phase("read latents"):
        for lf in latent_files:
            name = os.path.splitext(os.path.basename(lf))[0]
            t = read_final_template(lf, kind="latent")
            if not t.minu_template and not t.texture_template:
                with open(os.path.join(scores, name + ".csv"), "w") as f:
                    f.write("0\n")
                count("empty latents")
                continue
            todo.append((name, t, pack_latent(t, quantize_tex_xy=False)))
    count("latents", len(todo))

    results = []
    if todo:
        with device_trace(args.trace), timer.phase("match"):
            if args.latent:
                kw = dict(m=args.rerank, prescreen_k=args.prescreen,
                          prescreen_lt=args.prescreen_lt,
                          prescreen_t=args.prescreen_t)
                results = [engine.one_to_list_reranked(todo[0][2], gallery,
                                                       **kw)
                           if args.rerank else
                           engine.one_to_list(todo[0][2], gallery)]
            else:
                results = engine.list_to_list([p for _, _, p in todo],
                                              gallery)
    if args.latent and todo:
        (name, t, _), result = todo[0], results[0]
        print(f"{name}: matched {gallery.n_real} in "
              f"{timer.buckets['match'] * 1000:.1f} ms")
        write_rank_csv(os.path.join(scores, name + ".csv"), result)
        print("Rank     Filename      Score")
        for r, (n, s) in enumerate(result.ranked(24), 1):
            print(f"{r:<8} {n:<12} {s:.3f}")
        # correspondence files of the top-24 candidates
        # (matcher.cpp:305-330)
        with timer.phase("correspondence files"):
            for n, _ in result.ranked(24):
                rolled = read_final_template(gallery_files[n], kind="rolled")
                write_corr_files(t, rolled, engine.codebook,
                                 os.path.join(scores, f"corr{name}_{n}"))
    elif todo:
        print(f"Matched {len(todo)} latents x {gallery.n_real} gallery "
              f"in {timer.buckets['match']:.2f}s")
        for (name, _, _), result in zip(todo, results):
            write_score_csv(os.path.join(scores, name + ".csv"), result)
    for (name, _, _), result in zip(todo, results):
        event("scores", latent=name, **score_stats(result.scores))
    event("match", loader=loader, gallery=gallery.n_real,
          phases=timer.report(), counters=dict(counters))
    print(timer.pretty())
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="afis-torch",
                                description="latent AFIS on PyTorch/CUDA")
    sub = p.add_subparsers(dest="cmd", required=True)
    pm = sub.add_parser("match", help="match one latent (-l) or a "
                                      "directory of latents (-ldir)")
    pm.add_argument("-l", "--latent", help="latent .dat (One2List)")
    pm.add_argument("-ldir", "--ldir", help="directory of latent .dat files "
                                            "(List2List; used without -l)")
    pm.add_argument("-g", "--gallery", required=True,
                    help="directory of rolled .dat files")
    pm.add_argument("-c", "--codebook",
                    help="PQ codebook (default: the config's CodebookPath)")
    pm.add_argument("-s", "--scores",
                    help="score directory (default: the config's ScorePath)")
    pm.add_argument("--config", help="afis.config path (default: the first "
                                     "afis.config from the working directory "
                                     "up)")
    pm.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    pm.add_argument("--rerank", type=int, default=0, metavar="M",
                    help="screen-then-rerank serving (-l): exact scores for "
                         "the top-M screened candidates only (0 = dense "
                         "exact, the default)")
    pm.add_argument("--prescreen", type=int, default=0, metavar="K",
                    help="two-stage screen (requires --rerank): a truncated "
                         "screen with --prescreen-lt texture minutiae and "
                         "--prescreen-t minutiae templates keeps the top K "
                         "(<= M reranks them directly)")
    pm.add_argument("--prescreen-lt", type=int, default=64,
                    help="latent texture minutiae of the truncated screen "
                         "(default 64)")
    pm.add_argument("--prescreen-t", type=int, default=1,
                    help="latent minutiae templates of the truncated screen "
                         "(default 1)")
    pm.add_argument("--trace", metavar="DIR",
                    help="write a torch.profiler trace of the matching to "
                         "DIR/trace.json")
    pm.set_defaults(fn=cmd_match)
    args = p.parse_args(argv)
    if args.cmd == "match" and not args.latent and not args.ldir:
        p.error("match: give -l LATENT.dat or -ldir DIR")
    if args.cmd == "match" and args.prescreen and not args.rerank:
        p.error("--prescreen requires --rerank > 0 (it is a first stage "
                "of screen-then-rerank serving)")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
