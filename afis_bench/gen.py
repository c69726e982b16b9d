"""Seeded draws of one cell: the codebook, the gallery, the latents and their
planted mates.

The gallery's draws copy those of the port's
``utils.synthetic.device_synthetic_gallery`` (descriptors N(0, 1) rows
scaled to the post-reduction norm 1.73, minutiae in [24, 488) pixels,
uniform orientations, uniform PQ codes, texture coordinates on the
quantized 30 x 30 grid) and add per-entry counts between three quarters of
the capacity and the capacity, as ``synthetic_packed_gallery`` draws them;
slots beyond an entry's counts are zero, as the packer pads them. The
codebook copies ``random_codebook``. Everything is raw: f32 descriptors,
uint8 codes, coordinates and counts, from which the program derives its
stored layout and the reference derives its own.

Each gallery chunk has a generator of its own, seeded from (seed, chunk),
so that the reference can draw any chunk again after the program's
gallery is freed. This module imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

DES_NORM = 1.73          # post-reduction descriptor norm (descriptor_DR.py:152)
MATE_DES_NOISE = 0.25    # a mate's minutiae descriptors: the latent's plus this
MATE_XY_NOISE = 2.0      # a mate's minutiae coordinates: the latent's plus this
CHUNK = 2048             # gallery entries a generator draws at once

_MASK64 = (1 << 64) - 1


def derive(seed: int, *keys) -> int:
    """A 63-bit seed from ``seed`` and ``keys`` (splitmix64 steps), so that
    every stream of one run is its own and one seed gives one stream."""
    x = int(seed) & _MASK64
    for k in keys:
        k = k if isinstance(k, int) else int.from_bytes(
            str(k).encode(), "little") & _MASK64
        x = (x ^ (k & _MASK64)) + 0x9E3779B97F4A7C15 & _MASK64
        x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
        x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _MASK64
        x ^= x >> 31
    return x & ((1 << 63) - 1)


def batch_order(pool: int, seed: int) -> np.ndarray:
    """The seeded order in which the window sends the pool, cycled."""
    return np.random.default_rng(derive(seed, "order")).permutation(pool)


def random_codebook(seed: int, n_subs: int, n_clusters: int,
                    sub_dim: int) -> np.ndarray:
    """The PQ codebook [S, C, d] f32: N(0, 1) scaled so that a decoded
    descriptor has the post-reduction norm on average."""
    rng = np.random.default_rng(derive(seed, "codebook"))
    cb = rng.standard_normal((n_subs, n_clusters, sub_dim)).astype(np.float32)
    return cb * np.float32(DES_NORM / np.sqrt(n_subs * sub_dim))


def pq_encode(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest sub-codeword of each sub-vector: x [n, S * d] f32 ->
    codes [n, S] uint8 (first index on ties)."""
    S, C, d = codebook.shape
    sub = x.reshape(-1, S, 1, d)
    dist = ((sub - codebook[None]) ** 2).sum(dim=3)          # [n, S, C]
    return dist.argmin(dim=2).to(torch.uint8)


class Draws:
    """The raw inputs of one run of one cell, drawn from ``seed``.

    ``config`` holds the gallery and latent sizes (``gallery``, ``Rm``,
    ``Rt``, ``D``, ``pq``, ``latent``) and ``modes.block``; ``pool`` is
    the number of distinct latents. Gallery rows are padded up to a block
    multiple; padding rows have zero counts.
    """

    def __init__(self, config: dict, pool: int, seed: int, device):
        self.device = torch.device(device)
        self.seed = int(seed)
        self.G = int(config["gallery"])
        block = int(config["modes"]["block"])
        self.Gp = -(-self.G // block) * block
        self.Rm, self.Rt, self.D = (int(config[k]) for k in ("Rm", "Rt", "D"))
        pq = config["pq"]
        self.S, self.C, self.sd = (int(pq[k]) for k in
                                   ("subs", "clusters", "sub_dim"))
        if self.S * self.sd != self.D:
            raise ValueError("pq subs x sub_dim must equal D")
        lat = config["latent"]
        self.T, self.Lm, self.Lt = (int(lat[k]) for k in ("T", "Lm", "Lt"))
        self.pool = int(pool)
        if self.pool > self.G:
            raise ValueError("more latents than gallery entries")
        self.codebook = random_codebook(self.seed, self.S, self.C, self.sd)
        self.codebook_t = torch.as_tensor(self.codebook, device=self.device)
        self.latents = self._latents()
        self.mate_pos, self.mates = self._mates()

    # ------------------------------------------------------------------
    def _gen(self, *keys) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(derive(self.seed, *keys))
        return g

    def _uniform(self, g, shape, lo, hi):
        return torch.rand(shape, generator=g, device=self.device) \
            * (hi - lo) + lo

    def _unit(self, g, shape):
        d = torch.randn(shape, generator=g, device=self.device)
        return d / (d.norm(dim=-1, keepdim=True) + 1e-7) * DES_NORM

    def _latents(self) -> Dict[str, torch.Tensor]:
        """The pool: T minutiae templates of Lm minutiae and one texture
        template of Lt virtual minutiae each, every slot valid."""
        g = self._gen("latents")
        P, T, Lm, Lt, D = self.pool, self.T, self.Lm, self.Lt, self.D
        return dict(
            minu_des=self._unit(g, (P, T, Lm, D)),
            minu_xy=self._uniform(g, (P, T, Lm, 2), 24, 488),
            minu_ori=self._uniform(g, (P, T, Lm), -math.pi, math.pi),
            minu_n=torch.full((P, T), Lm, dtype=torch.int32,
                              device=self.device),
            tex_des=self._unit(g, (P, Lt, D)),
            tex_xy=torch.floor(self._uniform(g, (P, Lt, 2), 0, 30)),
            tex_ori=self._uniform(g, (P, Lt), -math.pi, math.pi),
            tex_n=torch.full((P,), Lt, dtype=torch.int32, device=self.device))

    def _mates(self):
        """Latent i's mate, planted at a seeded position: its first
        min(Rm, Lm) minutiae are noisy copies of the latent's first
        template, its first min(Rt, Lt) virtual minutiae carry the latent's
        coordinates and the PQ codes of its texture descriptors; the rest
        is drawn as any entry's."""
        g = self._gen("mates")
        P = self.pool
        pos = torch.randperm(self.G, generator=g, device=self.device)[:P]
        rows = self._entries(g, P, full=True)
        lat = self.latents
        k = min(self.Rm, self.Lm)
        rows["minu_xy"][:, :k] = lat["minu_xy"][:, 0, :k] + MATE_XY_NOISE \
            * torch.randn((P, k, 2), generator=g, device=self.device)
        rows["minu_ori"][:, :k] = lat["minu_ori"][:, 0, :k]
        d = lat["minu_des"][:, 0, :k] + MATE_DES_NOISE * torch.randn(
            (P, k, self.D), generator=g, device=self.device)
        rows["minu_des"][:, :k] = d / (d.norm(dim=-1, keepdim=True)
                                       + 1e-7) * DES_NORM
        k = min(self.Rt, self.Lt)
        rows["tex_xy"][:, :k] = lat["tex_xy"][:, :k]
        rows["tex_ori"][:, :k] = lat["tex_ori"][:, :k]
        rows["tex_codes"][:, :k] = pq_encode(
            lat["tex_des"][:, :k].reshape(-1, self.D),
            self.codebook_t).reshape(P, k, self.S)
        return pos, rows

    def _entries(self, g, n: int, full: bool = False) -> Dict[str, torch.Tensor]:
        """n gallery entries; counts in [3/4 capacity, capacity] unless
        ``full``; slots beyond the counts zero."""
        dev, Rm, Rt = self.device, self.Rm, self.Rt
        minu_des = self._unit(g, (n, Rm, self.D))
        minu_xy = self._uniform(g, (n, Rm, 2), 24, 488)
        minu_ori = self._uniform(g, (n, Rm), -math.pi, math.pi)
        codes = torch.randint(0, self.C, (n, Rt, self.S), generator=g,
                              device=dev, dtype=torch.int32).to(torch.uint8)
        tex_xy = torch.floor(self._uniform(g, (n, Rt, 2), 0, 30))
        tex_ori = self._uniform(g, (n, Rt), -math.pi, math.pi)
        if full:
            minu_n = torch.full((n,), Rm, dtype=torch.int32, device=dev)
            tex_n = torch.full((n,), Rt, dtype=torch.int32, device=dev)
        else:
            minu_n = torch.randint((3 * Rm + 3) // 4, Rm + 1, (n,),
                                   generator=g, device=dev,
                                   dtype=torch.int32)
            tex_n = torch.randint((3 * Rt + 3) // 4, Rt + 1, (n,),
                                  generator=g, device=dev, dtype=torch.int32)
        rows = dict(minu_des=minu_des, minu_xy=minu_xy, minu_ori=minu_ori,
                    minu_n=minu_n, tex_codes=codes, tex_xy=tex_xy,
                    tex_ori=tex_ori, tex_n=tex_n)
        return zero_beyond_counts(rows)

    # ------------------------------------------------------------------
    @property
    def n_chunks(self) -> int:
        return -(-self.Gp // CHUNK)

    def chunk(self, c: int) -> Dict[str, torch.Tensor]:
        """Raw rows [c * CHUNK, ...) of the padded gallery, mates planted."""
        a = c * CHUNK
        n = min(CHUNK, self.Gp - a)
        rows = self._entries(self._gen("gallery", c), n)
        real = torch.arange(a, a + n, device=self.device) < self.G
        rows["minu_n"] = torch.where(real, rows["minu_n"], 0)
        rows["tex_n"] = torch.where(real, rows["tex_n"], 0)
        rows = zero_beyond_counts(rows)
        here = (self.mate_pos >= a) & (self.mate_pos < a + n)
        if bool(here.any()):
            at = (self.mate_pos[here] - a).long()
            for k, v in rows.items():
                v[at] = self.mates[k][here]
        return rows

    def rows(self, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Raw rows at gallery positions ``idx`` [n] (any order, repeats
        allowed), drawing only the chunks they lie in."""
        idx = idx.to(self.device).long()
        out = None
        for c in torch.unique(idx // CHUNK).tolist():
            rows = self.chunk(int(c))
            if out is None:
                out = {k: torch.zeros((len(idx),) + v.shape[1:],
                                      dtype=v.dtype, device=self.device)
                       for k, v in rows.items()}
            here = (idx // CHUNK) == c
            at = idx[here] - c * CHUNK
            for k, v in rows.items():
                out[k][here] = v[at]
        return out


def zero_beyond_counts(rows: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Zero every minutiae / texture slot at or beyond the entry's count."""
    dev = rows["minu_n"].device
    mm = torch.arange(rows["minu_des"].shape[1], device=dev)[None] \
        < rows["minu_n"][:, None]
    tm = torch.arange(rows["tex_codes"].shape[1], device=dev)[None] \
        < rows["tex_n"][:, None]
    for k in ("minu_des", "minu_xy", "minu_ori"):
        rows[k] = rows[k] * mm.reshape(mm.shape + (1,) * (rows[k].dim() - 2))
    for k in ("tex_xy", "tex_ori"):
        rows[k] = rows[k] * tm.reshape(tm.shape + (1,) * (rows[k].dim() - 2))
    rows["tex_codes"] = rows["tex_codes"] * tm[:, :, None].to(torch.uint8)
    return rows
