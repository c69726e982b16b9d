"""In-memory template data model.

Mirrors the semantics of the reference's template classes
(the reference implementation's extraction/template.py:8-47 and
the reference implementation's matching/include.h:24-558) with plain NumPy dataclasses:

- a fingerprint ``Template`` holds N minutiae templates (points + descriptors
  + block orientation field) and up to one texture template (virtual minutiae
  + descriptors, float for latents / uint8 PQ codes for rolled prints);
- minutiae rows are ``[x, y, ori, reliability]`` (latents) or ``[x, y, ori]``
  (rolled), angles in radians.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


class MatcherConstants:
    """Capacity / tunable constants of the matching pipeline.

    Values follow the reference implementation:
    the reference implementation's matching/matcher.h:31-32 (max minutiae per template),
    matcher.cpp:33 (texture top-N), :479 (minutiae top-N corr), :491/:758
    (distance threshold), :45 (distance LUT size), :788-790 (reader caps).
    """

    MAX_NROF_MINUTIAE = 2000       # reader cap, incl. virtual minutiae
    MAX_MINU_PER_TEMPLATE = 1000   # per-side cap inside the texture matcher
    MAX_DES_LENGTH = 192
    MAX_BLK_SIZE = 100
    BLK_CLAMP = 50                 # blkH/blkW clamp used by readers/writers
    TOPN_MINU_CORR = 120           # candidate correspondences (minutiae)
    TOPN_TEX_CORR = 200            # candidate correspondences (texture)
    DIST_THRESHOLD = 30.0          # |d_latent - d_rolled| gate (pixels)
    DIST_LUT_N = 50                # quantized-coordinate distance LUT size
    BLOCK_SIZE = 16
    # latent minutiae-template indices fused into the final score
    # (matcher.cpp:380 — templates {27,3,12} 1-based -> {26,2,11})
    SELECTED_MINU_TEMPLATES = (26, 2, 11)
    TEXTURE_SCORE_WEIGHT = 0.3     # matcher.cpp:188/:293


@dataclasses.dataclass
class MinuTemplate:
    """One minutiae template: points, descriptors and orientation field."""

    h: int = 0
    w: int = 0
    blkH: int = 0
    blkW: int = 0
    minutiae: Optional[np.ndarray] = None   # [n, 4] float (x, y, ori, rel)
    des: Optional[np.ndarray] = None        # [n, des_len] float32
    oimg: Optional[np.ndarray] = None       # [blkH, blkW] float32
    mask: Optional[np.ndarray] = None       # [h, w] 0/1 (optional)
    block_size: int = MatcherConstants.BLOCK_SIZE

    def __post_init__(self):
        # Background blocks of the orientation field are marked -10, as in
        # the reference data model (template.py:18-24).
        if self.mask is not None and self.oimg is not None:
            bs = self.block_size
            for i in range(self.blkH):
                y = int(i * bs + bs // 2)
                for j in range(self.blkW):
                    x = int(j * bs + bs // 2)
                    if 0 <= y < self.mask.shape[0] and 0 <= x < self.mask.shape[1]:
                        if self.mask[y, x] == 0:
                            self.oimg[i, j] = -10.0

    @property
    def n_minutiae(self) -> int:
        return 0 if self.minutiae is None else len(self.minutiae)


@dataclasses.dataclass
class TextureTemplate:
    """Texture template: virtual minutiae + descriptors.

    ``des`` is float32 [n, des_len] for latents (kept uncompressed) or
    uint8 [n, n_subs] PQ codes for rolled prints after PQ encoding.
    """

    h: int = 0
    w: int = 0
    minutiae: Optional[np.ndarray] = None
    des: Optional[np.ndarray] = None
    mask: Optional[np.ndarray] = None

    @property
    def n_minutiae(self) -> int:
        return 0 if self.minutiae is None else len(self.minutiae)

    @property
    def is_pq(self) -> bool:
        return self.des is not None and np.asarray(self.des).dtype == np.uint8


@dataclasses.dataclass
class Template:
    """A full fingerprint template (latent or rolled)."""

    minu_template: List[MinuTemplate] = dataclasses.field(default_factory=list)
    texture_template: List[TextureTemplate] = dataclasses.field(default_factory=list)

    def add_minu_template(self, t: MinuTemplate) -> None:
        self.minu_template.append(t)

    def add_texture_template(self, t: TextureTemplate) -> None:
        self.texture_template.append(t)
