from .mesh import make_mesh, gallery_group, GALLERY_AXIS, LATENT_AXIS
from .sharding import shard_gallery, match_sharded, topk_collective
from .manifest import (GalleryManifest, build_manifest, save_manifest,
                       load_manifest, verify_manifest, assign_shard,
                       reshard_plan)

__all__ = ["make_mesh", "gallery_group", "GALLERY_AXIS", "LATENT_AXIS",
           "shard_gallery", "match_sharded", "topk_collective",
           "GalleryManifest", "build_manifest", "save_manifest",
           "load_manifest", "verify_manifest", "assign_shard",
           "reshard_plan"]
