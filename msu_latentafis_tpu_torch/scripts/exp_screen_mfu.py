#!/usr/bin/env python
"""ADC-screen throughput experiment on the card: the shipped screen against
two transposed formulations of it.

    python -m msu_latentafis_tpu_torch.scripts.exp_screen_mfu

The port of the JAX package's scripts/exp_screen_mfu.py, at its shapes (NL
8, Lt 448, D 96, Rt 448, gallery block ``EXP_B`` entries, default 4096,
seed 0) and with its variants:

  base            : the port's ``adc_screen`` on a bf16 latent operand and an
                    int8 predecoded gallery, one -rsq / 2 scale over the
                    block (the JAX script's single ``fused_adc_screen``
                    call);
  transposed      : dots [Rt, NL Lt] per entry, max over Rt
                    (``ops.screen_t``, kernel ``screen_t_bf16``), the int8
                    gallery cast to bf16 beside the bf16 aug columns;
  transposed_e16  : the same kernel, the blocks of each 512-column group
                    of xt taking the gallery 16 entries at a time (8 in
                    ``transposed``);
  transposed_int8 : x quantized to int8, int8 x int8 dots in int32
                    (``screen_t_int8``);
  base_e16        : base again: the port's screen has no entries-per-step
                    knob (its persistent blocks take one entry at a time,
                    all latents at once), so this is its own block width.

On the card ``base`` and ``transposed`` run the same tensor-core body
(``csrc/screen_body.cuh``) on the same product; they differ in the
epilogue (the screen rounds each row maximum to bf16 and folds it into
terms; the transposed screen writes its maxima and leaves the rest to
PyTorch).

Per variant it prints {"seconds", "tflops", "pairs_per_s"} (tflops counts
2 NL Lt (D + 2) Rt B, as the script does), and for the transposed and int8
variants max_abs_err_vs_base (int8 also rel_err), then the whole record as
one JSON line. Times come from CUDA events over REPS calls after one
warm-up. The script writes no file. The inputs are drawn in the JAX
script's order and rounded to bf16 from f32.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from msu_latentafis_tpu_torch.scripts.microbench_body_stages import cuda_ms

NL, Lt, D, Rt = 8, 448, 96, 448
B = int(os.environ.get("EXP_B", "4096"))        # gallery block
REPS = 6


def make_inputs(rng, device, B: int = B) -> dict:
    """The JAX script's inputs (seed 0 there), the gallery in the port's
    [B, Rt, D] layout: x bf16, lsq / lvalid f32, dec int8, rsq / rvalid
    f32."""
    import numpy as np
    import torch

    def put(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype).contiguous()
    x = put(rng.standard_normal((NL, Lt, D)).astype(np.float32),
            torch.bfloat16)
    lsq = put(rng.random((NL, Lt)))
    lvalid = put(np.ones((NL, Lt)))
    dec = put(np.swapaxes(rng.integers(-127, 127, (B, D, Rt)), 1, 2),
              torch.int8)
    rsq = put(rng.random((B, Rt)))
    rvalid = put(np.ones((B, Rt)))
    return dict(x=x, lsq=lsq, lvalid=lvalid, dec=dec, rsq=rsq, rvalid=rvalid)


def variants(a: dict) -> dict:
    """variant -> a call of it on the inputs ``a``."""
    from msu_latentafis_tpu_torch.matcher.kernels import ops
    B_ = a["dec"].shape[0]
    base = lambda: ops.adc_screen(**a, block=B_)
    return {"base": base,
            "transposed": lambda: ops.screen_t(**a),
            "transposed_e16": lambda: ops.screen_t(**a, entries=16),
            "transposed_int8": lambda: ops.screen_t(**a, int8=True),
            "base_e16": base}


def run(emit=print, device="cuda", B: int = B, reps: int = REPS) -> dict:
    """Time every variant; returns the record (and emits one line per
    variant and the record)."""
    import numpy as np
    a = make_inputs(np.random.default_rng(0), device, B)
    flops = 2.0 * NL * Lt * (D + 2) * Rt * B
    out = {"shapes": {"NL": NL, "Lt": Lt, "D": D, "Rt": Rt, "B": B}}
    base = None
    for name, fn in variants(a).items():
        dt = cuda_ms(fn, reps) / 1e3
        out[name] = {"seconds": dt, "tflops": flops / dt / 1e12,
                     "pairs_per_s": NL * B / dt}
        r = fn()
        if name == "base":
            base = r
        elif name in ("transposed", "transposed_int8"):
            err = float((r - base).abs().max())
            out[name]["max_abs_err_vs_base"] = err
            if name == "transposed_int8":
                out[name]["rel_err"] = err / max(1.0, float(base.abs().max()))
        emit(f"{name} {json.dumps(out[name])}")
    emit(json.dumps(out))
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("exp_screen_mfu: no CUDA device", file=sys.stderr)
        return 2
    run(lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
