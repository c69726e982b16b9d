"""Synthetic templates and galleries for tests and the chip smoke run.

The host half is a NumPy copy of the JAX package's generator (final ``.dat``
semantics: texture coordinates already quantized, descriptors L2-normalized
to 1.73 as after dimensionality reduction). ``device_synthetic_gallery``
fills a gallery directly on the card from a ``torch.Generator``, so a
100K-entry gallery costs no host generation or upload.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..templates.data_model import MinuTemplate, TextureTemplate, Template

DES_NORM = 1.73  # post-DR descriptor norm (descriptor_DR.py:152)


def random_descriptors(rng: np.random.Generator, n: int, dim: int = 96,
                       norm: float = DES_NORM) -> np.ndarray:
    d = rng.standard_normal((n, dim)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True) + 1e-7
    return (d * norm).astype(np.float32)


def random_codebook(rng: np.random.Generator, n_subs: int = 16,
                    n_clusters: int = 256, sub_dim: int = 6) -> np.ndarray:
    cb = rng.standard_normal((n_subs, n_clusters, sub_dim)).astype(np.float32)
    return cb * (DES_NORM / np.sqrt(n_subs * sub_dim))


def random_minutiae(rng: np.random.Generator, n: int, h: int = 512,
                    w: int = 512, margin: int = 24,
                    with_reliability: bool = True) -> np.ndarray:
    cols = 4 if with_reliability else 3
    m = np.zeros((n, cols), np.float64)
    m[:, 0] = rng.integers(margin, w - margin, n)
    m[:, 1] = rng.integers(margin, h - margin, n)
    m[:, 2] = rng.uniform(-np.pi, np.pi, n)
    if with_reliability:
        m[:, 3] = 1.0
    return m


def random_quantized_minutiae(rng: np.random.Generator, n: int,
                              blk: int = 30) -> np.ndarray:
    """Texture minutiae with on-disk quantized (x-24)/16 coordinates."""
    m = np.zeros((n, 4), np.float64)
    m[:, 0] = rng.integers(0, blk, n)
    m[:, 1] = rng.integers(0, blk, n)
    m[:, 2] = rng.uniform(-np.pi, np.pi, n)
    return m


def pq_encode(des: np.ndarray, codebook: np.ndarray) -> np.ndarray:
    """Nearest-codeword PQ encoding [N, S*d] -> uint8 codes [N, S]."""
    n_subs, _, sub_dim = codebook.shape
    x = np.asarray(des, np.float32).reshape(len(des), n_subs, sub_dim)
    cb = np.asarray(codebook, np.float32)
    d2 = (np.sum(x * x, axis=2)[:, :, None]
          - 2.0 * np.einsum("nsd,scd->nsc", x, cb)
          + np.sum(cb * cb, axis=2)[None])
    return np.argmin(d2, axis=2).astype(np.uint8)


def make_rolled_template(rng: np.random.Generator, n_minu: int = 60,
                         n_tex: int = 300, des_dim: int = 96,
                         n_subs: int = 16, h: int = 512, w: int = 512,
                         mated_latent: Optional[Template] = None,
                         codebook: Optional[np.ndarray] = None,
                         noise: float = 0.25,
                         mate_template_idx: int = 26) -> Template:
    """Rolled template in final-PQ form (uint8 texture codes).

    With ``mated_latent`` the descriptors/coordinates are noisy copies of
    the latent's selected minutiae template ``mate_template_idx`` and the
    texture codes PQ-encode the latent's texture descriptors (requires
    ``codebook``), so the genuine pair scores far above random impostors.
    """
    t = Template()
    minu = random_minutiae(rng, n_minu, h, w, with_reliability=False)
    des = random_descriptors(rng, n_minu, des_dim)
    if mated_latent is not None and mated_latent.minu_template:
        idx = min(mate_template_idx, len(mated_latent.minu_template) - 1)
        src = mated_latent.minu_template[idx]
        k = min(n_minu, src.n_minutiae)
        minu[:k, :3] = np.asarray(src.minutiae)[:k, :3]
        minu[:k, :2] += rng.normal(0, 2.0, (k, 2))
        d = src.des[:k] + noise * rng.standard_normal(
            (k, des_dim)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True) + 1e-7
        des[:k] = d * DES_NORM
    t.add_minu_template(MinuTemplate(
        h=h, w=w, blkH=h // 16, blkW=w // 16, minutiae=minu, des=des,
        oimg=np.zeros((h // 16, w // 16), np.float32)))
    tex = random_quantized_minutiae(rng, n_tex)
    codes = rng.integers(0, 256, (n_tex, n_subs)).astype(np.uint8)
    if mated_latent is not None and mated_latent.texture_template:
        src = mated_latent.texture_template[0]
        k = min(n_tex, src.n_minutiae)
        tex[:k] = np.asarray(src.minutiae)[:k, :4]
        if codebook is not None and k:
            codes[:k] = pq_encode(np.asarray(src.des)[:k], codebook)
    t.add_texture_template(TextureTemplate(h=h, w=w, minutiae=tex, des=codes))
    return t


def make_latent_template(rng: np.random.Generator, n_minu: int = 30,
                         n_tex: int = 200, des_dim: int = 96,
                         n_minu_templates: int = 28, h: int = 512,
                         w: int = 512) -> Template:
    """Latent template in final form: 28 minutiae templates + 1 float
    texture template with quantized coordinates."""
    t = Template()
    for _ in range(n_minu_templates):
        minu = random_minutiae(rng, n_minu, h, w)
        des = random_descriptors(rng, n_minu, des_dim)
        t.add_minu_template(MinuTemplate(
            h=h, w=w, blkH=h // 16, blkW=w // 16, minutiae=minu, des=des,
            oimg=np.zeros((h // 16, w // 16), np.float32)))
    tex = random_quantized_minutiae(rng, n_tex)
    des = random_descriptors(rng, n_tex, des_dim)
    t.add_texture_template(TextureTemplate(h=h, w=w, minutiae=tex, des=des))
    return t


def synthetic_packed_gallery(rng: np.random.Generator, codebook: np.ndarray,
                             G: int, n_minu: int = 96, n_tex: int = 448,
                             des_dim: int = 96):
    """A PackedGallery of G synthetic rolled templates built with
    vectorized NumPy; counts are jittered down to 75% per entry."""
    from ..templates.packing import PackedGallery
    n_subs, n_clusters, _ = codebook.shape
    Rm, Rt = n_minu, n_tex

    minu_des = rng.standard_normal((G, Rm, des_dim), dtype=np.float32)
    minu_des /= np.linalg.norm(minu_des, axis=2, keepdims=True) + 1e-7
    minu_des *= DES_NORM
    minu_n = rng.integers(int(0.75 * Rm), Rm + 1, G).astype(np.int32)
    mmask = np.arange(Rm)[None, :] < minu_n[:, None]
    minu_des *= mmask[:, :, None]
    minu_xy = rng.integers(24, 488, (G, Rm, 2)).astype(np.float32) \
        * mmask[:, :, None]
    minu_ori = rng.uniform(-np.pi, np.pi, (G, Rm)).astype(np.float32) * mmask

    tex_codes = rng.integers(0, n_clusters, (G, Rt, n_subs)).astype(np.uint8)
    tex_n = rng.integers(int(0.75 * Rt), Rt + 1, G).astype(np.int32)
    tmask = np.arange(Rt)[None, :] < tex_n[:, None]
    tex_codes *= tmask[:, :, None]
    cw_sqnorm = np.sum(codebook.astype(np.float64) ** 2, axis=2) \
        .astype(np.float32)
    tex_sqnorm = cw_sqnorm[np.arange(n_subs)[None, None, :],
                           tex_codes.astype(np.int64)].sum(axis=2) * tmask
    tex_xy = rng.integers(0, 30, (G, Rt, 2)).astype(np.float32) \
        * tmask[:, :, None]
    tex_ori = rng.uniform(-np.pi, np.pi, (G, Rt)).astype(np.float32) * tmask
    return PackedGallery(minu_des=minu_des, minu_xy=minu_xy,
                         minu_ori=minu_ori, minu_n=minu_n,
                         tex_codes=tex_codes,
                         tex_sqnorm=tex_sqnorm.astype(np.float32),
                         tex_xy=tex_xy, tex_ori=tex_ori, tex_n=tex_n,
                         names=[str(i) for i in range(G)])


def device_synthetic_gallery(engine, G: int, n_minu: int = 96,
                             n_tex: int = 448, des_dim: int = 96,
                             seed: int = 0, chunk: int = 2048,
                             both_layouts: bool = False):
    """A DeviceGallery of G random rolled templates generated on the
    engine's device from ``torch.Generator(seed)``, predecoded
    (``tex_dec`` in the engine's mode: f32, bf16 or int8). With
    ``both_layouts`` it returns the pair (predecoded, codes-resident): the
    second holds the uint8 ``tex_codes`` the first's ``tex_dec`` decodes
    from and shares every other tensor with it. The descriptors are drawn
    in f32 and stored as the engine stores them (``minutiae_storage``:
    the compute dtype, or int8 with minu_int8); the squared norms are those
    of the f32 decode. G is padded to a block multiple; padding entries
    have zero counts and score -1."""
    from ..matcher.engine import DeviceGallery
    from ..matcher.texture_match import decode_pq

    dev = engine.device
    B = engine.block_size
    Gp = -(-G // B) * B
    Rm, Rt, D = n_minu, n_tex, des_dim
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    cb = engine.codebook_t
    S, C, _ = cb.shape
    f32 = dict(dtype=torch.float32, device=dev)
    t = dict(
        minu_des=torch.empty((Gp, Rm, D), **f32),
        minu_pack=torch.empty((Gp, Rm, 4), **f32),
        minu_n=torch.zeros((Gp,), dtype=torch.int32, device=dev),
        tex_dec=torch.empty((Gp, Rt, D), dtype=engine.tex_dec_dtype,
                            device=dev),
        tex_codes=torch.zeros((Gp, Rt, S), dtype=torch.uint8, device=dev)
        if both_layouts else None,
        tex_sqnorm=torch.empty((Gp, Rt), **f32),
        tex_pack=torch.empty((Gp, Rt, 4), **f32),
        tex_n=torch.zeros((Gp,), dtype=torch.int32, device=dev))
    t["minu_n"][:G] = Rm
    t["tex_n"][:G] = Rt
    for a in range(0, Gp, chunk):
        n = min(chunk, Gp - a)
        des = torch.randn((n, Rm, D), generator=gen, **f32)
        des /= des.norm(dim=2, keepdim=True) + 1e-7
        t["minu_des"][a:a + n] = des * DES_NORM
        ori = uniform((n, Rm), -np.pi, np.pi)
        t["minu_pack"][a:a + n] = torch.stack(
            [uniform((n, Rm), 24, 488), uniform((n, Rm), 24, 488),
             torch.cos(ori), torch.sin(ori)], dim=2)
        codes = torch.randint(0, C, (n, Rt, S), generator=gen, device=dev)
        if both_layouts:
            t["tex_codes"][a:a + n] = codes
        dec = decode_pq(codes, cb)
        t["tex_dec"][a:a + n] = engine.predecode(codes)
        t["tex_sqnorm"][a:a + n] = (dec * dec).sum(dim=2)
        tori = uniform((n, Rt), -np.pi, np.pi)
        t["tex_pack"][a:a + n] = torch.stack(
            [torch.floor(uniform((n, Rt), 0, 30)),
             torch.floor(uniform((n, Rt), 0, 30)),
             torch.cos(tori), torch.sin(tori)], dim=2)
    for v in t.values():
        if v is not None:
            v[G:] = 0
    codes, dec = t.pop("tex_codes"), t.pop("tex_dec")
    t["minu_des"], minu_scale = engine.minutiae_storage(t["minu_des"])

    def gallery(**tex):
        return DeviceGallery(names=[str(i) for i in range(G)], n_real=G,
                             minu_scale=minu_scale, **t, **tex)
    if not both_layouts:
        return gallery(tex_dec=dec)
    return gallery(tex_dec=dec), gallery(tex_codes=codes)


def plant_gallery_entries(gallery, engine, packed_mates,
                          positions: Sequence[int]) -> None:
    """Overwrite gallery rows at ``positions`` in place with real packed
    templates (planted mates); ``packed_mates`` holds len(positions)
    entries. Every tensor the gallery holds is written, in either layout
    and in the engine's mode (an int8 gallery's minutiae descriptors with
    the gallery's own scale); per-entry axes are zero-padded up to the
    gallery's capacity."""
    from ..matcher.kernels.ops import true_div
    loaded = engine.load_gallery(packed_mates)
    codes = torch.as_tensor(packed_mates.tex_codes, device=engine.device)
    small = {f: getattr(loaded, f) for f in gallery.TENSORS}
    small.update(tex_codes=codes, tex_dec=engine.predecode(codes))
    mdes = torch.as_tensor(np.asarray(packed_mates.minu_des, np.float32),
                           device=engine.device)
    if gallery.minu_scale is not None:
        mdes = torch.clamp(torch.round(true_div(
            mdes, gallery.minu_scale.expand_as(mdes))), -127, 127)
    small["minu_des"] = mdes.to(gallery.minu_des.dtype)
    pos = torch.as_tensor(list(positions), dtype=torch.long,
                          device=gallery.minu_des.device)
    n = len(positions)
    for f in gallery.TENSORS:
        big = getattr(gallery, f)
        if big is None:
            continue
        sm = small[f][:n]
        pad = []
        for b, s in zip(reversed(big.shape[1:]), reversed(sm.shape[1:])):
            if s > b:
                raise ValueError(f"{f}: planted entry wider than gallery")
            pad += [0, b - s]
        if pad:
            sm = torch.nn.functional.pad(sm, pad)
        big.index_copy_(0, pos, sm.to(big.dtype))
    for i, p in enumerate(positions):
        gallery.names[p] = packed_mates.names[i]
