"""Command-line interface of the port: 1:N matching.

    python -m msu_latentafis_tpu_torch.cli match -l LATENT.dat \
        -g GALLERY_DIR [-c CODEBOOK.dat] [-s SCORE_DIR] [--config FILE] \
        [--device cpu] \
        [--rerank M [--prescreen K --prescreen-lt 64 --prescreen-t 1]]

Scores one final latent ``.dat`` against every rolled ``.dat`` in the
gallery directory (the reference's One2List mode, matching/main.cpp:35-87),
writes ``SCORE_DIR/<latent>.csv`` (the ranked top-24) and prints the top-24
table. Without ``--rerank`` every entry gets the exact dense score; with
it, screen-then-rerank serving gives exact scores to the top M screened
entries only, and ``--prescreen`` makes the screen two-stage. ``-c`` and
``-s`` default to the config's ``CodebookPath`` and ``ScorePath``; the
config (``--config``, else an ``afis.config`` found from the working
directory up) also gives ``MatchBlockSize`` and ``ComputeDtype``:
"bfloat16" runs every kernel on bf16 operands, as the JAX CLI does.
``-ldir`` batches and correspondence files are not ported.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys
import time
from typing import List, Optional

import torch

from .config import load_config
from .matcher.engine import MatchEngine, write_rank_csv
from .templates import (pack_gallery, pack_latent, read_codebook,
                        read_final_template)


def load_gallery_dir(engine: MatchEngine, gallery_dir: str):
    files = sorted(glob.glob(os.path.join(gallery_dir, "*.dat")))
    if not files:
        raise FileNotFoundError(f"no .dat files in {gallery_dir}")
    names = [os.path.splitext(os.path.basename(f))[0] for f in files]
    templates = [read_final_template(f, kind="rolled") for f in files]
    return engine.load_gallery(pack_gallery(templates, engine.codebook,
                                            names=names))


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
    t0 = time.perf_counter()
    gallery = load_gallery_dir(engine, args.gallery)
    print(f"Gallery size: {gallery.n_real} "
          f"(loaded in {time.perf_counter() - t0:.2f}s)")

    name = os.path.splitext(os.path.basename(args.latent))[0]
    out = os.path.join(scores, name + ".csv")
    t = read_final_template(args.latent, kind="latent")
    if not t.minu_template and not t.texture_template:
        with open(out, "w") as f:
            f.write("0\n")
        return 0
    t0 = time.perf_counter()
    packed = pack_latent(t, quantize_tex_xy=False)
    if args.rerank:
        result = engine.one_to_list_reranked(
            packed, gallery, m=args.rerank, prescreen_k=args.prescreen,
            prescreen_lt=args.prescreen_lt, prescreen_t=args.prescreen_t)
    else:
        result = engine.one_to_list(packed, gallery)
    dt = (time.perf_counter() - t0) * 1000
    print(f"{name}: matched {gallery.n_real} in {dt:.1f} ms")
    write_rank_csv(out, result)
    print("Rank     Filename      Score")
    for r, (n, s) in enumerate(result.ranked(24), 1):
        print(f"{r:<8} {n:<12} {s:.3f}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="afis-torch",
                                description="latent AFIS on PyTorch/CUDA")
    sub = p.add_subparsers(dest="cmd", required=True)
    pm = sub.add_parser("match", help="1:N match of one latent")
    pm.add_argument("-l", "--latent", required=True, help="latent .dat")
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
                    help="screen-then-rerank serving: exact scores for the "
                         "top-M screened candidates only (0 = dense exact, "
                         "the default)")
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
    pm.set_defaults(fn=cmd_match)
    args = p.parse_args(argv)
    if args.cmd == "match" and args.prescreen and not args.rerank:
        p.error("--prescreen requires --rerank > 0 (it is a first stage "
                "of screen-then-rerank serving)")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
