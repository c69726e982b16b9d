"""Command-line interface of the port: extraction and matching.

    python -m msu_latentafis_tpu_torch.cli extract-latent (--i IMG | --idir DIR) \
        [--tdir DIR] [--config FILE] [--device cpu]
    python -m msu_latentafis_tpu_torch.cli extract-rolled --idir DIR \
        [--tdir DIR] [--N1 N] [--N2 N] [--layout flat|longitudinal|msp|n2n] \
        [--config FILE] [--device cpu]
    python -m msu_latentafis_tpu_torch.cli match (-l LATENT.dat | -ldir DIR) \
        -g GALLERY_DIR [-c CODEBOOK.dat] [-s SCORE_DIR] [--config FILE] \
        [--device cpu] [--trace DIR] \
        [--rerank M [--prescreen K --prescreen-lt 64 --prescreen-t 1]]

``extract-latent`` is the reference's latent extraction
(extraction_latent.py:321-330) as the JAX package's runs it: the image
``--i``, or each ``*.bmp`` and ``*.png`` of ``--idir`` (sorted) whose
``TDIR/<stem>.dat`` does not exist yet, goes through the
``LatentFeatureExtractor``, is written as TF_C, read back, reduced by the
CompNet and written as the final latent ``.dat`` (28 minutiae templates
and a texture template, float descriptors); an image larger than 1,000 px
both ways gives an empty ``.dat``. ``--tdir`` defaults to the config's
``LatentTemplateDirectory``.

``extract-rolled`` is the reference's rolled extraction
(extraction_rolled.py:278-286) as the JAX package's runs it: each image of
the layout (``pipeline.rolled.enumerate_rolled_dataset``) whose
``TDIR/<stem>.dat`` does not exist yet goes through the
``RolledFeatureExtractor`` (nets from the config's ``.npz`` model paths,
else the seeded init), is written as TF_C, read back, reduced by the
CompNet and, where the config names a ``CodebookPath``, PQ-encoded, and
written as the final rolled ``.dat``. A file that fails prints
``extraction FAILED`` and the run goes on. ``--tdir`` defaults to the
config's ``GalleryTemplateDirectory``.

``match`` is the reference's matching entry point (matching/main.cpp:35-87), as the
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


def _extract_and_write(extractor, f: str, out: str, finish,
                       ppi: int = 500) -> bool:
    """Extract one image, print its seconds and stage seconds, then
    ``finish(template)`` writes it; an image that fails prints
    ``extraction FAILED`` and the run goes on, as the reference's does."""
    timer = PhaseTimer()
    try:
        with timer.phase("extract"):
            template = extractor.extract_file(f, ppi=ppi)
    except Exception as e:
        print(f"{f}: extraction FAILED ({type(e).__name__}: {e}); skipping")
        count("extraction failures")
        return False
    print(f"{f}: extracted in {timer.buckets['extract']:.2f}s "
          f"({ {k: round(v, 4) for k, v in extractor.timings.items()} })")
    with timer.phase("postprocess"):
        finish(template)
    count("extracted")
    event("extract", image=f, template=out, **extractor.timings,
          postprocess=timer.buckets["postprocess"])
    return True


def cmd_extract_latent(args) -> int:
    from .pipeline import LatentFeatureExtractor, ModelBundle
    from .pipeline.postprocess import compress_template
    from .templates import (read_template, write_final_latent_template,
                            write_template)
    cfg = load_config(args.config)
    tdir = args.tdir or cfg.LatentTemplateDirectory
    if not tdir:
        raise SystemExit("extract-latent: give --tdir, or a config with "
                         "LatentTemplateDirectory")
    os.makedirs(tdir, exist_ok=True)
    models = ModelBundle.initialize(cfg, device=args.device)
    extractor = LatentFeatureExtractor(models=models)
    files = [args.i] if args.i else sorted(
        glob.glob(os.path.join(args.idir, "*.bmp"))
        + glob.glob(os.path.join(args.idir, "*.png")))
    for f in files:
        out = os.path.join(tdir,
                           os.path.splitext(os.path.basename(f))[0] + ".dat")
        if not args.i and os.path.exists(out):     # resume by skipping
            continue

        def finish(template, out=out):
            write_template(out, template, is_latent=True)
            t = read_template(out, is_latent=True)
            if t is not None:     # None: larger than max_size both ways
                compress_template(models, t)
            write_final_latent_template(out, t)
        _extract_and_write(extractor, f, out, finish)
    return 0


def cmd_extract_rolled(args) -> int:
    from .ops.pq import pq_encode
    from .pipeline import ModelBundle, RolledFeatureExtractor
    from .pipeline.postprocess import compress_template
    from .pipeline.rolled import enumerate_rolled_dataset
    from .templates import (read_template, write_final_rolled_pq_template,
                            write_template)
    cfg = load_config(args.config)
    tdir = args.tdir or cfg.GalleryTemplateDirectory
    if not tdir:
        raise SystemExit("extract-rolled: give --tdir, or a config with "
                         "GalleryTemplateDirectory")
    os.makedirs(tdir, exist_ok=True)
    models = ModelBundle.initialize(cfg, device=args.device)
    extractor = RolledFeatureExtractor(models=models)
    codebook = read_codebook(cfg.CodebookPath) if cfg.CodebookPath else None
    for f, name, ppi in enumerate_rolled_dataset(
            args.idir, layout=args.layout, N1=args.N1, N2=args.N2):
        out = os.path.join(tdir, name + ".dat")
        if os.path.exists(out):
            continue

        def finish(template, out=out):
            write_template(out, template, is_latent=False)
            t = read_template(out, is_latent=False)
            compress_template(models, t)
            if codebook is not None and t.texture_template and \
                    t.texture_template[0].des is not None:
                t.texture_template[0].des = pq_encode(
                    t.texture_template[0].des, codebook, device=args.device)
            write_final_rolled_pq_template(out, t)
        _extract_and_write(extractor, f, out, finish, ppi=ppi)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="afis-torch",
                                description="latent AFIS on PyTorch/CUDA")
    sub = p.add_subparsers(dest="cmd", required=True)
    pl = sub.add_parser("extract-latent", help="extract latent images to "
                                               "final .dat files")
    src = pl.add_mutually_exclusive_group(required=True)
    src.add_argument("--i", help="one image")
    src.add_argument("--idir", help="image directory (*.bmp, *.png)")
    pl.add_argument("--tdir", help="template directory (default: the "
                                   "config's LatentTemplateDirectory)")
    pl.add_argument("--config", help="afis.config path (default: the first "
                                     "afis.config from the working directory "
                                     "up)")
    pl.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    pl.set_defaults(fn=cmd_extract_latent)
    pr = sub.add_parser("extract-rolled", help="enroll a directory of rolled "
                                               "prints as final .dat files")
    pr.add_argument("--idir", required=True, help="image directory")
    pr.add_argument("--tdir", help="template directory (default: the "
                                   "config's GalleryTemplateDirectory)")
    pr.add_argument("--N1", type=int, default=0)
    pr.add_argument("--N2", type=int, default=10 ** 9)
    pr.add_argument("--layout", default="flat",
                    choices=["flat", "longitudinal", "msp", "n2n"],
                    help="dataset layout (the reference's batch modes)")
    pr.add_argument("--config", help="afis.config path (default: the first "
                                     "afis.config from the working directory "
                                     "up)")
    pr.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    pr.set_defaults(fn=cmd_extract_rolled)
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
