"""Multi-host runtime initialization and gallery distribution.

Counterpart of the JAX package's ``parallel/distributed.py``. The reference
has no distributed runtime (inter-stage transport is the filesystem —
SURVEY.md §2.4); here one process per device joins a ``torch.distributed``
process group, NCCL between CUDA devices and gloo between CPU processes,
and each process holds its contiguous slice of the gallery.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist


def backend_for(device) -> str:
    """The collective backend for tensors on ``device``."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for {kind} tensors")


def check_backend(group, device) -> None:
    """Raise unless ``group`` runs the backend of ``device``'s tensors."""
    want, have = backend_for(device), dist.get_backend(group)
    if have != want:
        raise ValueError(f"{torch.device(device).type} tensors need the "
                         f"{want} backend; the group runs {have}")


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device="cuda") -> None:
    """``init_process_group`` with the JAX package's environment variables
    as fallbacks (AFIS_NUM_PROCESSES, AFIS_COORDINATOR "host:port",
    AFIS_PROCESS_ID); a no-op for one process. The backend follows
    ``device``; a CUDA process takes card process_id % cards on its host
    (ranks numbered host by host)."""
    n = num_processes if num_processes is not None else int(
        os.environ.get("AFIS_NUM_PROCESSES", "1"))
    if n <= 1:
        return
    rank = process_id if process_id is not None else int(
        os.environ["AFIS_PROCESS_ID"])
    addr = coordinator or os.environ["AFIS_COORDINATOR"]
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend_for(device), init_method=f"tcp://{addr}",
                            world_size=n, rank=rank)


@dataclasses.dataclass
class ShardedPlane:
    """One gallery plane as this rank holds it: its local rows and the
    shape of the plane over every rank."""
    local: torch.Tensor
    global_shape: Tuple[int, ...]


def global_gallery_from_local(local_arrays: dict, mesh,
                              axis: str = "gallery") -> Dict[str, ShardedPlane]:
    """Every rank's local planes are its shard along ``axis``: check that
    all ranks along it hold the same planes with equal shapes (an
    all_gather of the shapes) and report each plane's global shape, the
    local rows times the number of shards."""
    group = mesh.get_group(axis)
    n = mesh[axis].size()
    shapes = {k: tuple(v.shape) for k, v in local_arrays.items()}
    every = [None] * n
    dist.all_gather_object(every, shapes, group=group)
    if any(s != shapes for s in every):
        raise ValueError(f"local gallery planes differ between ranks: {every}")
    return {k: ShardedPlane(local=torch.as_tensor(v),
                            global_shape=(v.shape[0] * n,) + tuple(v.shape[1:]))
            for k, v in local_arrays.items()}
