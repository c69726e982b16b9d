"""Sharded gallery matching: each rank scores its contiguous shard with the
dense engine, then collectives gather the scores or merge the top-k.

Counterpart of the JAX package's ``parallel/sharding.py`` (shard_map over
the gallery axis), in place of the reference's OpenMP data parallelism over
gallery files (matcher.cpp:168/:273). Each rank holds a contiguous gallery
shard in its device's memory and scores the latents against it with
``MatchEngine._match_all`` (the dense kernels on a CUDA device); the scores
are all-gathered in shard order, and the ranked list is merged from every
shard's top-k (the collective carries O(n_shards * k) entries, not O(G)).
Ties rank the lower gallery index first, as ``jax.lax.top_k`` does: every
top-k is a stable descending sort, and the gathered blocks arrive in rank
order.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..matcher.engine import DeviceGallery, MatchEngine
from ..templates.packing import PackedGallery
from .distributed import check_backend
from .mesh import gallery_group, gallery_shape


def shard_gallery(engine: MatchEngine, packed: PackedGallery,
                  mesh) -> DeviceGallery:
    """Pad the gallery to a multiple of (n_shards * block) entries; this
    rank loads only its contiguous slice, through the engine's
    ``load_gallery`` (and its predecode rule). The result keeps every name
    and ``n_real``, the real entries of the whole gallery."""
    if engine.device.type != mesh.device_type:
        raise ValueError(f"engine on {engine.device}, mesh over "
                         f"{mesh.device_type} devices")
    n, r = gallery_shape(mesh)
    G0 = packed.size
    quantum = n * engine.block_size
    local_n = -(-G0 // quantum) * quantum // n
    lo = r * local_n
    k = max(0, min(G0 - lo, local_n))

    def part(a: np.ndarray) -> np.ndarray:
        out = np.zeros((local_n,) + a.shape[1:], a.dtype)
        out[:k] = a[lo:lo + k]
        return out

    arrays = {f.name: part(getattr(packed, f.name))
              for f in dataclasses.fields(packed) if f.name != "names"}
    gal = engine.load_gallery(PackedGallery(**arrays))
    gal.names = list(packed.names)
    gal.n_real = G0
    return gal


def _gather(t: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """Every gallery shard's ``t`` concatenated along ``dim`` in shard
    order."""
    group = gallery_group(mesh)
    check_backend(group, t.device)
    parts = [torch.empty_like(t) for _ in range(gallery_shape(mesh)[0])]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def match_sharded(engine: MatchEngine, latent, gallery: DeviceGallery,
                  mesh) -> torch.Tensor:
    """Scores [G_padded] (or [NL, G_padded] for a latent batch) over the
    whole sharded gallery, on every rank: this rank's shard through
    ``_match_all``, then an all_gather along the gallery axis."""
    single = not isinstance(latent, (list, tuple))
    lat = engine.latent_batch([latent] if single else list(latent))
    out = _gather(engine._match_all(lat, gallery), mesh, dim=1)
    return out[0] if single else out


def topk_collective(scores: torch.Tensor, k: int,
                    mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global (values, indices) top-k of a score vector [G] split evenly
    over the gallery shards: each rank takes the top min(k, G / n_shards)
    of its own slice, offsets its indices by rank x slice, all-gathers
    values and indices, and keeps the top min(k, gathered) of those."""
    n, r = gallery_shape(mesh)
    G = scores.shape[0]
    if G % n:
        raise ValueError(f"{G} scores do not split over {n} shards")
    local_n = G // n
    kk = min(k, local_n)
    v, i = torch.sort(scores[r * local_n:(r + 1) * local_n],
                      descending=True, stable=True)
    av = _gather(v[:kk], mesh, dim=0)
    ai = _gather(i[:kk] + r * local_n, mesh, dim=0)
    fv, fi = torch.sort(av, descending=True, stable=True)
    kf = min(k, av.shape[0])
    return fv[:kf], ai[fi[:kf]]
