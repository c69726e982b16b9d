"""Phase profile of the screen-then-rerank serving path.

    python -m msu_latentafis_tpu_torch.scripts.profile_rerank \
        [--device cuda|cpu] [--record]

The port's counterpart of the JAX package's ``scripts/profile_rerank.py``,
at its bench configuration (bf16, int8 predecoded texture, 448 shape):

- full serving (``match_scores_batch_reranked``, m PROF_RERANK, no
  prescreen) against the screen alone (``screen_scores_batch``); the
  difference is the top-k, the gather and the rerank; each the fastest of
  3 after a warm-up;
- the two screen kernels alone at one block of 512 entries:
  ``ops.adc_screen`` and ``ops.minu_screen``, 8 launches each (the JAX
  script's ``lax.scan`` of 8), the fastest of 3 after a warm-up;
- the ADC screen's TFLOP/s at blocks of 512, 1,024 and 2,048 entries, by
  the JAX script's formula NL B 8 2 Lt D Rt / t.

The gallery is ``device_synthetic_gallery`` in the engine's mode. Every
clock reading follows a synchronize.

Environment (the JAX script's names and defaults): PROF_GALLERY (100000),
PROF_LATENTS (8), PROF_BLOCK (512), PROF_RERANK (512). ``--record`` writes
``results/torch/profile_rerank.json``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..matcher.engine import MatchEngine
from ..matcher.kernels import ops
from ..utils.synthetic import device_synthetic_gallery, make_latent_template
from . import measure as M

REPS = 8                     # launches per timed call (the JAX scan's 8)
ADC_BLOCKS = (512, 1024, 2048)
D = 96


def kernel_rates(engine, gal, lats, blocks=ADC_BLOCKS,
                 block: int = 512) -> dict:
    """The two screens alone on the first ``block`` entries, and the ADC
    screen's TFLOP/s over ``blocks``, as the JAX script counts them."""
    dev = engine.device
    L = engine.screen_side(engine.latent_batch(lats), gal)
    NL, Lt, Dx = L["tex_des"].shape
    NT, Lm, _ = L["minu_des"].shape
    Rm, Rt = gal.minu_des.shape[1], gal.tex_sqnorm.shape[1]

    def many(kernel, args):
        def call():
            for _ in range(REPS):
                kernel(**args)
        return call

    minu, adc = engine.screen_args(L, gal, slice(0, block))
    t_adc = M.min_of(many(ops.adc_screen, adc), dev)
    t_minu = M.min_of(many(ops.minu_screen, minu), dev)
    by_block = {}
    for BB in blocks:
        _, adcB = engine.screen_args(L, gal, slice(0, BB))
        tB = M.min_of(many(ops.adc_screen, adcB), dev)
        by_block[str(BB)] = NL * BB * REPS * 2 * Lt * Dx * Rt / tB / 1e12
    adc_pairs = NL * block * REPS
    minu_pairs = NT * block * REPS
    return {"adc_screen_pairs_per_s": adc_pairs / t_adc,
            "adc_screen_tflops": adc_pairs * 2 * Lt * Dx * Rt / t_adc / 1e12,
            "adc_screen_tflops_by_block": by_block,
            "minu_screen_pairs_per_s": minu_pairs / t_minu,
            "minu_screen_tflops": minu_pairs * 2 * Lm * Dx * Rm / t_minu
            / 1e12}


def run(G: int = 100000, NL: int = 8, block: int = 512, m: int = 512,
        device="cuda", shapes=M.SHAPES_448, blocks=ADC_BLOCKS) -> dict:
    RM, RT, LM, LT = shapes
    cb = M.codebook()
    engine = MatchEngine(cb, block_size=block, compute_dtype=torch.bfloat16,
                         tex_int8=True, codes_resident=False, device=device)
    dev = engine.device
    gal = device_synthetic_gallery(engine, G, n_minu=RM, n_tex=RT, seed=0)
    rng = np.random.default_rng(7)
    lats = [M.pack(make_latent_template(rng, n_minu=LM, n_tex=LT), LM, LT)
            for _ in range(NL)]
    t_full = M.min_of(lambda: engine.match_scores_batch_reranked(
        lats, gal, m=m), dev)
    t_screen = M.min_of(lambda: float(engine.screen_scores_batch(
        lats, gal)[:, :8].sum()), dev)
    out = {
        "config": {"gallery": G, "latents": NL, "block": block, "m": m,
                   "shapes": {"Rm": RM, "Rt": RT, "Lm": LM, "Lt": LT,
                              "D": D},
                   "source": "msu_latentafis_tpu_torch/scripts/"
                             "profile_rerank.py, bf16+int8 tex, serving "
                             "path", **M.header(dev)},
        "full_s": t_full,
        "latents_per_s": NL / t_full,
        "breakdown_s": {"screen_scan": t_screen,
                        "topk_gather_rerank": t_full - t_screen},
        "kernel_rates": kernel_rates(engine, gal, lats, blocks=blocks,
                                     block=min(512, gal.size)),
    }
    M.emit(out)
    return out


def main(argv=None) -> int:
    args = M.parser(__doc__).parse_args(argv)
    out = run(G=M.env_int("PROF_GALLERY", 100000),
              NL=M.env_int("PROF_LATENTS", 8),
              block=M.env_int("PROF_BLOCK", 512),
              m=M.env_int("PROF_RERANK", 512), device=M.device_of(args.device))
    if args.record:
        print("wrote", M.write_record("profile_rerank", out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
