#!/usr/bin/env python
"""Isolate the graph-filter body cost from the selection preamble on the
card.

    python -m msu_latentafis_tpu_torch.scripts.microbench_filter

The port of the JAX package's scripts/microbench_filter.py, on the same
data (seed 0): ``graph_filter_packed`` is the body-only kernel (operands
pre-gathered), timed at the match step's set counts (24 x 512 sets of
K 120, float distance, 5 power iterations; 8 x 512 sets of K 200, lookup
distance, 3 iterations); the difference to the whole ``minutiae_match`` and
``texture_match`` kernels at the same sets is their similarity and
selection preamble. The minutiae match gets bf16 descriptors, as the JAX
script feeds it. One JSON line per variant,
{"variant", "ms"}, timed with CUDA events over REPS launches after one
warm-up.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from msu_latentafis_tpu_torch.scripts.microbench_body_stages import cuda_ms

NT, B, P, R, D = 24, 512, 64, 96, 96
K = 120
NL, Lt, Rt, KT = 8, 448, 448, 200
REPS = 4


def make_inputs(rng, device):
    """Every variant's operands, drawn in the JAX script's order."""
    import numpy as np
    import torch

    def put(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype).contiguous()
    i32 = torch.int32
    NP = NT * B
    minu_sets = (put(rng.uniform(0.5, 3.0, (NP, K))),
                 put(rng.uniform(0, 480, (NP, K, 4))),
                 put(rng.uniform(0, 480, (NP, K, 4))),
                 put(rng.integers(0, P, (NP, K)), i32),
                 put(rng.integers(0, R, (NP, K)), i32),
                 put(rng.random((NP, K)) > 0.15, torch.bool))
    NP2 = NL * B
    tex_sets = (put(rng.uniform(0.5, 3.0, (NP2, KT))),
                put(rng.integers(0, 30, (NP2, KT, 4))),
                put(rng.integers(0, 30, (NP2, KT, 4))),
                put(rng.integers(0, Lt, (NP2, KT)), i32),
                put(rng.integers(0, Rt, (NP2, KT)), i32),
                put(rng.random((NP2, KT)) > 0.15, torch.bool))
    lat = rng.standard_normal((NT, P, D)).astype(np.float32)
    lat /= np.linalg.norm(lat, axis=-1, keepdims=True)
    rol = rng.standard_normal((B, R, D)).astype(np.float32)
    rol /= np.linalg.norm(rol, axis=-1, keepdims=True)
    lpackT = rng.uniform(0, 480, (NT, 4, P))
    rpackT = rng.uniform(0, 480, (B, 4, R))
    minu = dict(ldes=put(lat, torch.bfloat16), lvalid=put(np.ones((NT, P))),
                rdes=put(rol, torch.bfloat16),
                rvalid=put(np.ones((B, R))),
                lpack=put(np.swapaxes(lpackT, 1, 2)),
                rpack=put(np.swapaxes(rpackT, 1, 2)), top_n=K, row_cap=8,
                dist_iters=5)
    best = put(rng.uniform(-3, 6, (NL, B, Lt)))
    bestj = put(rng.integers(0, Rt, (NL, B, Lt)), i32)
    lval = put(np.ones((NL, Lt)))
    lpackT2 = rng.uniform(0, 30, (NL, 4, Lt))
    rpackT2 = rng.uniform(0, 30, (B, 4, Rt))
    tex = dict(best=best, bestj=bestj, lvalid=lval,
               lpack=put(np.swapaxes(lpackT2, 1, 2)),
               rpack=put(np.swapaxes(rpackT2, 1, 2)), top_n=KT, lookup=True,
               dist_iters=3)
    return minu_sets, tex_sets, minu, tex


def run(emit=print, device="cuda"):
    """Time the four variants; returns {variant: ms}."""
    import numpy as np
    from msu_latentafis_tpu_torch.matcher.kernels import ops
    minu_sets, tex_sets, minu, tex = make_inputs(np.random.default_rng(0),
                                                 device)
    variants = (
        ("body/minu[NP=12288,K=120]", lambda: ops.graph_filter_packed(
            *minu_sets, lookup=False, dist_iters=5)),
        ("body/tex[NP=4096,K=200]", lambda: ops.graph_filter_packed(
            *tex_sets, lookup=True, dist_iters=3)),
        ("fused_minutiae_match", lambda: ops.minutiae_match(**minu)),
        ("fused_texture_match", lambda: ops.texture_match(**tex)))
    times = {}
    for name, fn in variants:
        times[name] = cuda_ms(fn, REPS)
        emit(json.dumps({"variant": name, "ms": round(times[name], 2)}))
    return times


def main():
    import torch
    if not torch.cuda.is_available():
        print("microbench_filter: no CUDA device", file=sys.stderr)
        return 2
    run(lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
