"""Typed configuration, compatible with the reference's ``afis.config``.

The port's own copy of the JAX package's ``AfisConfig`` and
``find_config``: a flat JSON with the reference's key names (model, data
and score paths) plus the matcher's knobs. Keys this class does not know
are ignored, so one deployment's file serves both packages. The matcher
reads ``CodebookPath``, ``ScorePath``, ``MatchBlockSize`` and
``ComputeDtype`` ("float32" or "bfloat16").
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional


@dataclasses.dataclass
class AfisConfig:
    # model paths
    DimensionalityReductionModel: str = ""
    DescriptorModelPatch2: str = ""
    DescriptorModelPatch8: str = ""
    DescriptorModelPatch11: str = ""
    MinutiaeExtractionModel: str = ""
    MinutiaeExtractionModelLatentSTFT: str = ""
    MinutiaeExtractionModelRolled: str = ""
    EnhancementModel: str = ""
    # data paths
    LatentImageDirectory: str = ""
    LatentTemplateDirectory: str = ""
    GalleryImageDirectory: str = ""
    GalleryTemplateDirectory: str = ""
    ScorePath: str = ""
    CodebookPath: str = ""
    MinuPath: Optional[str] = None
    # matcher
    MatchBlockSize: int = 64
    ComputeDtype: str = "float32"      # or "bfloat16"
    GalleryShards: int = 0             # 0 = all local devices

    @classmethod
    def load(cls, path: str) -> "AfisConfig":
        with open(path) as f:
            raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})


def find_config(start: Optional[str] = None) -> Optional[str]:
    """Walk up from ``start`` (the working directory) looking for
    afis.config, as the reference resolves it relative to its root."""
    d = os.path.abspath(start or os.getcwd())
    while True:
        cand = os.path.join(d, "afis.config")
        if os.path.exists(cand):
            return cand
        parent = os.path.dirname(d)
        if parent == d:
            return None
        d = parent


def load_config(path: Optional[str] = None) -> AfisConfig:
    """``path``, else the afis.config ``find_config`` finds, else the
    defaults."""
    path = path or find_config()
    return AfisConfig.load(path) if path else AfisConfig()
