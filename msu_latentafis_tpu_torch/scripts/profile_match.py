"""Ablation profile of the dense match step.

    python -m msu_latentafis_tpu_torch.scripts.profile_match \
        [--device cuda|cpu] [--record]

The port's counterpart of the JAX package's ``scripts/profile_match.py``:
the dense step (``match_scores_batch``, bf16 with int8 predecoded
texture, 448 shape) timed whole and with stages swapped for stubs that
return the right shapes and types from a cheap reduction of their
operands:

  full    - everything
  nominu  - ``ops.minutiae_match`` stubbed (the whole minutiae kernel)
  core    - ``ops.texture_match`` stubbed as well: the ADC row max, the
            block slicing and the loop
  noadc   - ``ops.adc_rowmax`` stubbed as well: slicing and loop only
  notex   - ``ops.texture_match`` alone stubbed

The engine calls each kernel as an attribute of ``ops``, so a stub reaches
every call; each variant restores the originals when it ends, raising or
not. Subtraction gives minu_kernel_s, tex_kernel_s, core_s, adc_s and
scan_s. Each variant: a warm-up batch, then a timed batch of fresh
latents; the clock is read after a synchronize.

Environment (the JAX script's names and defaults): PROF_GALLERY (16384),
PROF_LATENTS (8), PROF_BLOCK (512). ``--record`` writes
``results/torch/profile_match.json``.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..matcher.engine import MatchEngine
from ..matcher.kernels import ops
from ..utils.synthetic import device_synthetic_gallery, make_latent_template
from . import measure as M


def fake_minu(ldes, lvalid, rdes, rvalid, lpack, rpack, **kw):
    a = ldes.float().sum(dim=(1, 2))
    b = rdes.float().sum(dim=(1, 2))
    return (a[:, None] + b[None, :]) * 1e-30


def fake_tex(best, bestj, lvalid, lpack, rpack, **kw):
    return best.sum(dim=2) * 1e-30


def fake_adc(x, lsq, dec, rsq, rvalid, **kw):
    xs = x.float().sum(dim=2)                          # [NL, Lt]
    ds = dec.float().sum(dim=(1, 2))                   # [B]
    best = xs[:, None, :] * 1e-30 + ds[None, :, None] * 1e-30
    return best, torch.zeros(best.shape, dtype=torch.int32,
                              device=best.device)


STUBS = {"minutiae_match": fake_minu, "texture_match": fake_tex,
         "adc_rowmax": fake_adc}
# variant -> the kernels stubbed in it, in the JAX script's order
VARIANTS = (("full", ()),
            ("nominu", ("minutiae_match",)),
            ("core", ("minutiae_match", "texture_match")),
            ("noadc", ("minutiae_match", "texture_match", "adc_rowmax")),
            ("notex", ("texture_match",)))


@contextlib.contextmanager
def stubbed(names):
    """ops.<name> replaced by its stub for the block, restored after."""
    saved = {n: getattr(ops, n) for n in names}
    try:
        for n in names:
            setattr(ops, n, STUBS[n])
        yield
    finally:
        for n, f in saved.items():
            setattr(ops, n, f)


def time_dense(engine, gal, warm, batch) -> float:
    """A warm-up batch, then the timed batch's seconds."""
    engine.match_scores_batch(warm, gal)
    return M.clock(lambda: engine.match_scores_batch(batch, gal),
                   engine.device)[1]


def profile(engine, gal, latents, time_fn=time_dense) -> dict:
    """Seconds of each variant; ``latents(tag)`` gives its (warm, batch)."""
    results = {}
    for tag, names in VARIANTS:
        with stubbed(names):
            warm, batch = latents(tag)
            results[tag] = time_fn(engine, gal, warm, batch)
        M.emit({"variant": tag, "s": results[tag],
                "latents_per_s": len(batch) / results[tag]})
    return results


def breakdown(results: dict) -> dict:
    """The JAX script's differences (:153-159)."""
    return {"minu_kernel_s": results["full"] - results["nominu"],
            "tex_kernel_s": results["full"] - results["notex"],
            "core_s": results["core"],
            "adc_s": results["core"] - results["noadc"],
            "scan_s": results["noadc"]}


def run(G: int = 16384, NL: int = 8, block: int = 512, device="cuda",
        shapes=M.SHAPES_448) -> dict:
    RM, RT, LM, LT = shapes
    cb = M.codebook()
    engine = MatchEngine(cb, block_size=block, compute_dtype=torch.bfloat16,
                         tex_int8=True, codes_resident=False, device=device)
    gal = device_synthetic_gallery(engine, G, n_minu=RM, n_tex=RT, seed=0)
    rng = np.random.default_rng(7)

    def latents(tag):
        return tuple([M.pack(make_latent_template(rng, n_minu=LM, n_tex=LT),
                             LM, LT) for _ in range(NL)] for _ in range(2))

    results = profile(engine, gal, latents)
    out = {"config": {"gallery": G, "latents": NL, "block": block,
                      "shapes": {"Rm": RM, "Rt": RT, "Lm": LM, "Lt": LT},
                      **M.header(engine.device)},
           "variants_s": results, **breakdown(results)}
    M.emit(out)
    return out


def main(argv=None) -> int:
    args = M.parser(__doc__).parse_args(argv)
    out = run(G=M.env_int("PROF_GALLERY", 16384),
              NL=M.env_int("PROF_LATENTS", 8),
              block=M.env_int("PROF_BLOCK", 512),
              device=M.device_of(args.device))
    if args.record:
        print("wrote", M.write_record("profile_match", out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
