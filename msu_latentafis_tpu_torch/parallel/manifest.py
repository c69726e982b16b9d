"""Idempotent gallery shard manifests (failure detection / elastic recovery).

The port's copy of the JAX package's ``parallel/manifest.py`` (host code;
the same JSON). The reference's only failure handling is skip-and-continue
on corrupt templates and resume-by-skip on existing outputs
(matcher.cpp:798-801, extraction_rolled.py:158-160 — SURVEY.md §5). For a
sharded deployment the equivalent needs to be explicit: a manifest records
every enrolled template (path, size, mtime), hosts claim deterministic
shard slices of it, and a host failure is recovered by re-sharding the
same manifest over the surviving hosts — no enrollment work is redone
because the template store itself is the checkpoint.
"""
from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class GalleryManifest:
    gallery_dir: str
    entries: List[Dict] = field(default_factory=list)  # {name, path, size, mtime}
    version: int = 1

    @property
    def names(self) -> List[str]:
        return [e["name"] for e in self.entries]

    def __len__(self) -> int:
        return len(self.entries)


def build_manifest(gallery_dir: str) -> GalleryManifest:
    """Scan a template directory into a deterministic (sorted) manifest."""
    entries = []
    for path in sorted(glob.glob(os.path.join(gallery_dir, "*.dat"))):
        st = os.stat(path)
        entries.append(dict(name=os.path.splitext(os.path.basename(path))[0],
                            path=path, size=st.st_size,
                            mtime=round(st.st_mtime, 3)))
    return GalleryManifest(gallery_dir=gallery_dir, entries=entries)


def save_manifest(manifest: GalleryManifest, path: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(dict(gallery_dir=manifest.gallery_dir,
                       version=manifest.version,
                       entries=manifest.entries), f)
    os.replace(tmp, path)          # atomic: readers never see partial JSON


def load_manifest(path: str) -> GalleryManifest:
    with open(path) as f:
        d = json.load(f)
    return GalleryManifest(gallery_dir=d["gallery_dir"],
                           entries=d["entries"],
                           version=d.get("version", 1))


def verify_manifest(manifest: GalleryManifest) -> Dict[str, List[str]]:
    """Detect drift between the manifest and the template store.

    Returns {"missing": [...], "changed": [...], "new": [...]} by name;
    all empty means the manifest is current.
    """
    missing, changed = [], []
    seen = set()
    for e in manifest.entries:
        seen.add(e["name"])
        if not os.path.exists(e["path"]):
            missing.append(e["name"])
            continue
        st = os.stat(e["path"])
        if st.st_size != e["size"] or round(st.st_mtime, 3) != e["mtime"]:
            changed.append(e["name"])
    new = [os.path.splitext(os.path.basename(p))[0]
           for p in sorted(glob.glob(os.path.join(manifest.gallery_dir, "*.dat")))
           if os.path.splitext(os.path.basename(p))[0] not in seen]
    return dict(missing=missing, changed=changed, new=new)


def assign_shard(manifest: GalleryManifest, n_hosts: int,
                 host_id: int) -> List[Dict]:
    """Deterministic contiguous shard slice for one host.

    Contiguous (not strided) so each host's slice is a dense block —
    re-sharding after a host failure moves whole blocks, and every host
    computes the same assignment with no coordination beyond (n_hosts,
    host_id). Host i of n gets entries [i*ceil(N/n), (i+1)*ceil(N/n)).
    """
    if not 0 <= host_id < n_hosts:
        raise ValueError(f"host_id {host_id} out of range for {n_hosts} hosts")
    per = -(-len(manifest.entries) // n_hosts) if manifest.entries else 0
    return manifest.entries[host_id * per:(host_id + 1) * per]


def reshard_plan(manifest: GalleryManifest, old_hosts: int,
                 surviving: List[int]) -> Dict[int, List[Dict]]:
    """Recovery plan after host failures: the same manifest re-sharded
    over the surviving hosts (keyed by their old host ids). Entries only
    ever move between hosts; none are lost or duplicated."""
    n_new = len(surviving)
    if n_new == 0:
        raise ValueError("no surviving hosts")
    plan: Dict[int, List[Dict]] = {}
    for new_rank, old_id in enumerate(sorted(surviving)):
        tmp = GalleryManifest(manifest.gallery_dir, manifest.entries)
        plan[old_id] = assign_shard(tmp, n_new, new_rank)
    return plan
