"""Extraction seconds per image on the card: the latent and rolled
extractors on synthetic images of NIST SD27's size (768 x 800).

    python -m msu_latentafis_tpu_torch.scripts.bench_extraction \
        [--images 3] [--seed 0] [--device cuda]

Seeded full-width weights in the Flax layout (written as ``.npz`` to a
temporary directory and read back, as the CLI reads them); the latent
extractor's enhancement net is ``PassThroughEnhancement`` (seeded
autoencoder weights leave the latent mask empty). Per extractor: the first
call (cuDNN and cuFFT plans), then the steady seconds per image (the
minimum and mean of ``--images`` calls; each returns its template on the
host, so the clock covers the device's work), then the same calls with
``EXTRACT_SYNC_TIMINGS=1`` for each stage's own seconds (from the fastest
of them). Prints one JSON line with the card's name and power limit; writes
no file.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch


def run(extractor, imgs, sync_imgs) -> dict:
    t0 = time.perf_counter()
    extractor.extract(imgs[0])
    first = time.perf_counter() - t0
    steady = []
    for img in imgs[1:]:
        t0 = time.perf_counter()
        extractor.extract(img)
        steady.append(time.perf_counter() - t0)
    os.environ["EXTRACT_SYNC_TIMINGS"] = "1"
    synced, stages = [], {}
    try:
        for img in sync_imgs:
            t0 = time.perf_counter()
            extractor.extract(img)
            synced.append(time.perf_counter() - t0)
            if synced[-1] == min(synced):
                stages = dict(extractor.timings)
    finally:
        os.environ.pop("EXTRACT_SYNC_TIMINGS")
    return {"seconds_per_image": min(steady),
            "seconds_per_image_mean": sum(steady) / len(steady),
            "seconds_per_image_synced": min(synced),
            "first_call_s": first, "stages_synced": stages}


def main(argv=None) -> int:
    from ..config import AfisConfig
    from ..pipeline import (LatentFeatureExtractor, ModelBundle,
                            RolledFeatureExtractor)
    from ..utils.timing import card_line
    from ..utils.synthetic import (PassThroughEnhancement, latent_image,
                                   random_bundle_variables,
                                   render_ridge_image, write_bundle_npz)
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--images", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(args.seed)
    h, w = 768, 800
    n = args.images + 1
    prints = [render_ridge_image(rng, h, w)[0] for _ in range(n)]
    latents = [latent_image(rng, np.round(im).astype(np.uint8), h, w)
               .astype(np.float32) for im in prints]
    with tempfile.TemporaryDirectory() as d:
        paths = write_bundle_npz(d, random_bundle_variables(args.seed))
        models = ModelBundle.initialize(AfisConfig(**paths),
                                        device=args.device)
    rolled = run(RolledFeatureExtractor(models=models), prints[:n],
                 prints[1:n])
    models.enhancement = PassThroughEnhancement().to(models.device)
    latent = run(LatentFeatureExtractor(models=models), latents[:n],
                 latents[1:n])
    print(json.dumps({"card": card_line(args.device),
                      "device": str(models.device),
                      "shape": [h, w], "images": args.images,
                      "rolled": rolled, "latent": latent}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
