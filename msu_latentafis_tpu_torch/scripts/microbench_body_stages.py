#!/usr/bin/env python
"""Ablate the graph-filter body by stage to locate its cost on the card.

    python -m msu_latentafis_tpu_torch.scripts.microbench_body_stages

The port of the JAX package's scripts/microbench_body_stages.py: the same
sets (seed 0; minutiae shape 24 x 512 sets of K 120 without the lookup
distance and 5 power iterations, texture shape 8 x 512 sets of K 200 with
it and 3), timed through ``graph_filter_packed`` with its ``stages`` hook:
0 = the I/O floor, 1 = H1 build, 2 = +power(dist), 3 = +greedy1,
4 = +angle-H build, 5 = +power(5), 6 = full. One JSON line per stage,
{"variant", "ms", "delta_ms"}, timed with CUDA events over REPS launches
after one warm-up. Stage 0 is a line the JAX script does not print.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

REPS = 4
SHAPES = (("minu", 24 * 512, 120, False, 5, 0, 480),
          ("tex", 8 * 512, 200, True, 3, 0, 30))
STAGES = range(7)


def cuda_ms(fn, reps: int = REPS) -> float:
    """Mean milliseconds of ``fn`` on the card over ``reps`` calls after
    one warm-up call, from CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def make_sets(rng, NP, K, lo, hi, device):
    """The JAX script's random sets, drawn in its order: (val, gl, gr, li,
    ri, valid) with li < 64 and ri < 448."""
    import torch

    def put(a, dtype):
        return torch.as_tensor(a).to(device=device, dtype=dtype).contiguous()
    f32 = torch.float32
    val = put(rng.uniform(0.5, 3.0, (NP, K)), f32)
    gl = put(rng.uniform(lo, hi, (NP, K, 4)), f32)
    gr = put(rng.uniform(lo, hi, (NP, K, 4)), f32)
    li = put(rng.integers(0, 64, (NP, K)), torch.int32)
    ri = put(rng.integers(0, 448, (NP, K)), torch.int32)
    valid = put(rng.random((NP, K)) > 0.15, torch.bool)
    return val, gl, gr, li, ri, valid


def run(emit=print, device="cuda"):
    """Time every stage of both shapes; returns {(name, stage): ms}."""
    import numpy as np
    from msu_latentafis_tpu_torch.matcher.kernels import ops
    rng = np.random.default_rng(0)
    times = {}
    for name, NP, K, lookup, dist_iters, lo, hi in SHAPES:
        args = make_sets(rng, NP, K, lo, hi, device)
        prev = 0.0
        for st in STAGES:
            ms = cuda_ms(lambda: ops.graph_filter_packed(
                *args, lookup=lookup, dist_iters=dist_iters, stages=st))
            times[(name, st)] = ms
            emit(json.dumps({"variant": f"{name}/st{st}", "ms": round(ms, 2),
                             "delta_ms": round(ms - prev, 2)}))
            prev = ms
    return times


def main():
    import torch
    if not torch.cuda.is_available():
        print("microbench_body_stages: no CUDA device", file=sys.stderr)
        return 2
    run(lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
