"""Descriptor-pool generator: the producer of streamed descriptor training.

A fixed pregenerated pool saturates and overfits (the JAX package's record
of its round-4 recipe); streaming keeps the batches fresh. This script
writes ``synthetic_descriptor_batch`` shards to a directory while
``training.pretrain`` reads them (``PRETRAIN_STREAM_DIR``). Its image
operations run on ``--device`` (the card by default; without one that
raises).

    python -m msu_latentafis_tpu_torch.scripts.gen_descriptor_pool \
        --out DIR --worker 0 [--batches-per-shard 8] [--max-shards N] \
        [--n-ids 16] [--samples-per-id 4] [--seed S] [--device cpu]

A shard is ``shard_w<worker>_<index>.npz`` with x [S, B, 96, 96, 1] f32 in
[-1, 1] and y [S, B] int32, written atomically (a temporary file, then a
rename) so a reader never sees a partial file. Without ``--seed`` each
worker's seed is salted with the time of day, so a restart does not repeat
its shards.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--worker", type=int, default=0)
    p.add_argument("--batches-per-shard", type=int, default=8)
    p.add_argument("--max-shards", type=int, default=100000,
                   help="stop after this many shards from this worker")
    p.add_argument("--n-ids", type=int, default=16)
    p.add_argument("--samples-per-id", type=int, default=4)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ..training.pretrain import check_device
    from ..training.synthetic_data import synthetic_descriptor_batch
    device = check_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    seed = args.seed if args.seed is not None else \
        (args.worker + 1) * 1_000_003 + (int(time.time()) % 86400)
    rng = np.random.default_rng(seed)
    t_start = time.time()
    for shard_i in range(args.max_shards):
        xs, ys = [], []
        for _ in range(args.batches_per_shard):
            x, y = synthetic_descriptor_batch(
                rng, n_ids=args.n_ids, samples_per_id=args.samples_per_id,
                device=device)
            xs.append(x)
            ys.append(y)
        name = f"shard_w{args.worker}_{shard_i:06d}"
        tmp = os.path.join(args.out, "." + name + ".tmp.npz")
        np.savez(tmp, x=np.stack(xs), y=np.stack(ys))
        os.replace(tmp, os.path.join(args.out, name + ".npz"))
        if shard_i % 5 == 0:
            dt = time.time() - t_start
            print(f"w{args.worker}: {shard_i + 1} shards "
                  f"({(shard_i + 1) * args.batches_per_shard} batches) "
                  f"in {dt:.0f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
