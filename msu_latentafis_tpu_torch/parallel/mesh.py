"""Device mesh helpers on ``torch.distributed``.

Counterpart of the JAX package's ``parallel/mesh.py``. The reference's only
parallelism is an 8-thread OpenMP loop over the gallery
(matcher.cpp:168, :273). Here one process drives one device; the processes
form a (latent, gallery) ``DeviceMesh``, the gallery split along its
``"gallery"`` axis, and collectives run over NCCL between CUDA devices or
over gloo between CPU processes. Ranks in different rows of the latent
axis hold the same gallery shards and compute the same scores.

The JAX package's ``gallery_sharding`` / ``replicated_sharding`` (named
shardings of global arrays) have no counterpart in eager PyTorch: each rank
holds its shard as local tensors (``parallel.sharding``).
"""
from __future__ import annotations

from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

GALLERY_AXIS = "gallery"
LATENT_AXIS = "latent"


def make_mesh(n_gallery: Optional[int] = None, n_latent: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A (latent, gallery) mesh over the initialized process group;
    defaults to every process on the gallery axis."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "distributed.initialize_multihost (or "
                           "torch.distributed.init_process_group) first")
    world = dist.get_world_size()
    if n_gallery is None:
        n_gallery = world // n_latent
    if n_gallery * n_latent != world:
        raise ValueError(f"{n_latent} x {n_gallery} != {world} processes")
    return init_device_mesh(device_type, (n_latent, n_gallery),
                            mesh_dim_names=(LATENT_AXIS, GALLERY_AXIS))


def gallery_group(mesh: DeviceMesh) -> dist.ProcessGroup:
    """The process group of this rank's row along the gallery axis (group
    rank i holds gallery shard i)."""
    return mesh.get_group(GALLERY_AXIS)


def gallery_shape(mesh: DeviceMesh):
    """(number of gallery shards, this rank's shard)."""
    return mesh[GALLERY_AXIS].size(), mesh.get_local_rank(GALLERY_AXIS)
