"""Packing ragged templates into dense, padded device arrays.

Instead of "load one rolled file, match, discard" inside a thread-parallel
loop (the reference implementation's matching/matcher.cpp:273-295), the
entire gallery shard is packed once into static-shape arrays that live in
device memory, and one latent is scored against all of it in batches.
Ragged minutiae counts become padding + valid-count masks. A copy of the JAX
package's packing module (the port imports nothing from it).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .data_model import MatcherConstants, Template


def _round_up(x: int, m: int) -> int:
    return ((max(x, 1) + m - 1) // m) * m


def _pad_rows(a: np.ndarray, n: int, dtype) -> np.ndarray:
    out = np.zeros((n,) + a.shape[1:], dtype=dtype)
    k = min(len(a), n)
    out[:k] = a[:k]
    return out


@dataclasses.dataclass
class PackedLatent:
    """One latent query, padded for device-resident matching.

    Only the fused-score inputs are packed: the selected minutiae templates
    (matcher.cpp:380) and the first texture template.
    """

    minu_des: np.ndarray      # [T, Lm, D] float32, L2-rows (zero for padding)
    minu_xy: np.ndarray       # [T, Lm, 2] float32 (pixel coordinates)
    minu_ori: np.ndarray      # [T, Lm] float32
    minu_n: np.ndarray        # [T] int32 valid counts
    tex_des: np.ndarray       # [Lt, D] float32
    tex_xy: np.ndarray        # [Lt, 2] float32 (quantized (x-24)/16 coords)
    tex_ori: np.ndarray       # [Lt] float32
    tex_n: np.ndarray         # [] int32
    name: str = ""


@dataclasses.dataclass
class PackedGallery:
    """A gallery shard packed into dense host arrays.

    Rolled minutiae-template descriptors stay uncompressed floats (as in the
    on-disk format); texture descriptors are uint8 PQ codes plus their
    precomputed reconstruction squared-norms (used by the matmul
    reformulation of asymmetric-distance scoring — see matcher/texture_match).
    """

    minu_des: np.ndarray      # [G, Rm, D]
    minu_xy: np.ndarray       # [G, Rm, 2] float32
    minu_ori: np.ndarray      # [G, Rm] float32
    minu_n: np.ndarray        # [G] int32
    tex_codes: np.ndarray     # [G, Rt, S] uint8
    tex_sqnorm: np.ndarray    # [G, Rt] float32  (||decode(codes)||^2)
    tex_xy: np.ndarray        # [G, Rt, 2] float32 (quantized coords)
    tex_ori: np.ndarray       # [G, Rt] float32
    tex_n: np.ndarray         # [G] int32
    names: List[str] = dataclasses.field(default_factory=list)

    @property
    def size(self) -> int:
        return int(self.minu_des.shape[0])

    def nbytes(self) -> int:
        return sum(getattr(self, f.name).nbytes
                   for f in dataclasses.fields(self)
                   if isinstance(getattr(self, f.name), np.ndarray))


def pack_latent(template: Template,
                selected: Sequence[int] = MatcherConstants.SELECTED_MINU_TEMPLATES,
                minu_cap: Optional[int] = None,
                tex_cap: Optional[int] = None,
                des_dim: Optional[int] = None,
                quantize_tex_xy: bool = True,
                name: str = "") -> PackedLatent:
    """Pack the selected latent minutiae templates + texture template.

    ``quantize_tex_xy`` applies the on-disk (x-24)/16 coordinate quantization
    when packing straight from an extraction-produced template; templates
    read from a final .dat already carry quantized coordinates and should
    pass False.
    """
    mts = []
    for idx in selected:
        mts.append(template.minu_template[idx]
                   if idx < len(template.minu_template) else None)

    counts = [0 if mt is None or mt.minutiae is None else len(mt.minutiae) for mt in mts]
    if des_dim is None:
        des_dim = next((mt.des.shape[1] for mt in mts
                        if mt is not None and mt.des is not None and len(mt.des)), 96)
    Lm = minu_cap or _round_up(max(counts + [1]), 8)

    T = len(mts)
    minu_des = np.zeros((T, Lm, des_dim), np.float32)
    minu_xy = np.zeros((T, Lm, 2), np.float32)
    minu_ori = np.zeros((T, Lm), np.float32)
    minu_n = np.zeros((T,), np.int32)
    for t, mt in enumerate(mts):
        if mt is None or mt.minutiae is None or len(mt.minutiae) == 0:
            continue
        m = np.asarray(mt.minutiae)[:Lm]
        n = len(m)
        minu_n[t] = n
        minu_xy[t, :n] = m[:, :2]
        minu_ori[t, :n] = m[:, 2]
        minu_des[t, :n, :] = np.asarray(mt.des, np.float32)[:n, :des_dim]

    if template.texture_template and template.texture_template[0].minutiae is not None:
        tt = template.texture_template[0]
        tn = min(tt.n_minutiae, MatcherConstants.MAX_MINU_PER_TEMPLATE)
        Lt = tex_cap or _round_up(tn, 8)
        tn = min(tn, Lt)
        m = np.asarray(tt.minutiae)[:tn]
        xy = m[:, :2]
        if quantize_tex_xy:
            xy = np.floor((xy - 24.0) / 16.0)
        tex_xy = _pad_rows(xy.astype(np.float32), Lt, np.float32)
        tex_ori = _pad_rows(m[:, 2].astype(np.float32), Lt, np.float32)
        tex_des = _pad_rows(np.asarray(tt.des, np.float32)[:tn, :des_dim], Lt, np.float32)
        tex_n = np.int32(tn)
    else:
        Lt = tex_cap or 8
        tex_xy = np.zeros((Lt, 2), np.float32)
        tex_ori = np.zeros((Lt,), np.float32)
        tex_des = np.zeros((Lt, des_dim), np.float32)
        tex_n = np.int32(0)

    return PackedLatent(minu_des=minu_des, minu_xy=minu_xy, minu_ori=minu_ori,
                        minu_n=minu_n, tex_des=tex_des, tex_xy=tex_xy,
                        tex_ori=tex_ori, tex_n=tex_n, name=name)


def pack_rolled_entry(template: Template, codebook_sqnorm: Optional[np.ndarray],
                      des_dim: int) -> Tuple[np.ndarray, ...]:
    """Extract (minu_des, minu_xy, minu_ori, n, codes, xy, ori, tn) raw
    (unpadded) arrays for one rolled template. ``codebook_sqnorm`` is the
    per-(sub, cluster) squared norm table used to precompute reconstruction
    norms; pass None to defer."""
    if template.minu_template:
        mt = template.minu_template[0]
        m = np.asarray(mt.minutiae) if mt.minutiae is not None else np.zeros((0, 3))
        des = np.asarray(mt.des, np.float32) if mt.des is not None else np.zeros((0, des_dim), np.float32)
    else:
        m = np.zeros((0, 3))
        des = np.zeros((0, des_dim), np.float32)
    if template.texture_template and template.texture_template[0].minutiae is not None:
        tt = template.texture_template[0]
        tm = np.asarray(tt.minutiae)[:MatcherConstants.MAX_MINU_PER_TEMPLATE]
        codes = np.asarray(tt.des, np.uint8)[:len(tm)]
    else:
        tm = np.zeros((0, 3))
        codes = np.zeros((0, 16), np.uint8)
    return m, des, tm, codes


def pack_gallery(templates: Sequence[Template],
                 codebook: np.ndarray,
                 names: Optional[Sequence[str]] = None,
                 minu_cap: Optional[int] = None,
                 tex_cap: Optional[int] = None,
                 des_dim: Optional[int] = None,
                 minu_des_dtype=np.float32,
                 pad_gallery_to: int = 1) -> PackedGallery:
    """Pack rolled templates into one dense gallery shard.

    Texture coordinates are expected already quantized (templates read from
    final rolled .dat files). ``pad_gallery_to`` rounds the gallery axis up
    (padding entries have zero counts and never win the top-K).
    """
    n_subs, n_clusters, sub_dim = codebook.shape
    cw_sqnorm = np.sum(np.asarray(codebook, np.float64) ** 2, axis=2).astype(np.float32)

    raw = []
    for t in templates:
        raw.append(pack_rolled_entry(t, cw_sqnorm, des_dim or 96))

    if des_dim is None:
        des_dim = next((r[1].shape[1] for r in raw if r[1].shape[0]), 96)

    G0 = len(raw)
    G = _round_up(G0, pad_gallery_to) if pad_gallery_to > 1 else G0
    Rm = minu_cap or _round_up(max([len(r[0]) for r in raw] + [1]), 8)
    Rt = tex_cap or _round_up(max([len(r[2]) for r in raw] + [1]), 8)

    minu_des = np.zeros((G, Rm, des_dim), minu_des_dtype)
    minu_xy = np.zeros((G, Rm, 2), np.float32)
    minu_ori = np.zeros((G, Rm), np.float32)
    minu_n = np.zeros((G,), np.int32)
    tex_codes = np.zeros((G, Rt, n_subs), np.uint8)
    tex_sqnorm = np.zeros((G, Rt), np.float32)
    tex_xy = np.zeros((G, Rt, 2), np.float32)
    tex_ori = np.zeros((G, Rt), np.float32)
    tex_n = np.zeros((G,), np.int32)

    sub_ids = np.arange(n_subs)
    for g, (m, des, tm, codes) in enumerate(raw):
        n = min(len(m), Rm)
        minu_n[g] = n
        if n:
            minu_des[g, :n] = des[:n, :des_dim]
            minu_xy[g, :n] = m[:n, :2]
            minu_ori[g, :n] = m[:n, 2]
        tn = min(len(tm), Rt)
        tex_n[g] = tn
        if tn:
            tex_codes[g, :tn] = codes[:tn]
            tex_xy[g, :tn] = tm[:tn, :2]
            tex_ori[g, :tn] = tm[:tn, 2]
            tex_sqnorm[g, :tn] = cw_sqnorm[sub_ids[None, :], codes[:tn].astype(np.int64)].sum(axis=1)

    return PackedGallery(minu_des=minu_des, minu_xy=minu_xy, minu_ori=minu_ori,
                         minu_n=minu_n, tex_codes=tex_codes, tex_sqnorm=tex_sqnorm,
                         tex_xy=tex_xy, tex_ori=tex_ori, tex_n=tex_n,
                         names=list(names) if names is not None
                         else [str(i) for i in range(G0)])
