#!/usr/bin/env python
"""Probe three ways to build the graph filter's stage-1 distance matrix H1
on the card.

    python -m msu_latentafis_tpu_torch.scripts.microbench_h1_probe

The port of the JAX package's scripts/microbench_h1_probe.py, at its
texture shape (NP 4096 sets of K 200, coordinates uniform in [0, 30), 15%
of the slots invalid, seed 0) and with its variants (``ops.h1_probe``):

  bcast  - the pairwise differences x_i - x_j;
  matmul - the same differences in the outer-product form
           x_i * 1 + (-1) * x_j, exact, so equal to bcast bit for bit;
  gram   - d^2 = |p_i|^2 + |p_j|^2 - 2 x_i x_j - 2 y_i y_j, clamped at 0:
           not exact.

The JAX script steps 8 sets per grid step; the kernel runs one set per
thread block. It prints {"variant", "ms"} per variant (CUDA events over
REPS calls after one warm-up), then ``matmul exact: True/False`` and
``gram maxdiff: <max |gram - bcast|>``.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from msu_latentafis_tpu_torch.scripts.microbench_body_stages import cuda_ms

T, K = 8, 200
NP = 4096
REPS = 8


def make_inputs(rng, device, NP: int = NP) -> dict:
    """The JAX script's inputs, drawn in its order."""
    import numpy as np
    import torch

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device) \
            .contiguous()
    lx, ly, rx, ry = (put(rng.uniform(0, 30, (NP, K))) for _ in range(4))
    vf = put((rng.random((NP, K)) > 0.15).astype(np.float32))
    return dict(lx=lx, ly=ly, rx=rx, ry=ry, vf=vf)


def run(emit=print, device="cuda", NP: int = NP, reps: int = REPS) -> dict:
    """Time the three variants; returns {"ms": {variant: ms}, "out":
    {variant: [NP]}, "matmul_exact": bool, "gram_maxdiff": float}."""
    import numpy as np
    import torch
    from msu_latentafis_tpu_torch.matcher.kernels import ops
    a = make_inputs(np.random.default_rng(0), device, NP)
    ms, out = {}, {}
    for v in ops.H1_VARIANTS:
        out[v] = ops.h1_probe(**a, variant=v)
        ms[v] = cuda_ms(lambda v=v: ops.h1_probe(**a, variant=v), reps)
        emit(json.dumps({"variant": v, "ms": round(ms[v], 4)}))
    exact = bool(torch.equal(out["bcast"], out["matmul"]))
    diff = float((out["bcast"] - out["gram"]).abs().max())
    emit(f"matmul exact: {exact}")
    emit(f"gram maxdiff: {diff}")
    return dict(ms=ms, out=out, matmul_exact=exact, gram_maxdiff=diff)


def main():
    import torch
    if not torch.cuda.is_available():
        print("microbench_h1_probe: no CUDA device", file=sys.stderr)
        return 2
    run(lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
