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

A latent holds every slot of its T minutiae templates (Lm) and of its
texture template (Lt) unless the configuration states a law of latent
sizes, ``latent.counts`` (``count_law``): then each template's minutiae
count and the texture count are drawn from it, from a stream of their own,
and the slots at or beyond a count are zero. The draws of every slot are
those of the full latent either way, so a law changes no other stream.

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
LAWS = ("loguniform",)

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


def count_law(lat: dict):
    """The law of latent sizes that ``lat`` (a configuration's
    ``latent``) states: None, or ``(minu (lo, hi), tex (lo, hi))``, each
    1 <= lo <= hi <= Lm (Lt). Raises on any other law or bounds."""
    law = lat.get("counts")
    if law is None:
        return None
    if law.get("law") not in LAWS:
        raise ValueError(f"latent counts: law {law.get('law')!r} is not one "
                         f"of {LAWS}")
    out = []
    for key, cap in (("minu", int(lat["Lm"])), ("tex", int(lat["Lt"]))):
        lo, hi = (int(v) for v in law[key])
        if not 1 <= lo <= hi <= cap:
            raise ValueError(f"latent counts: {key} [{lo}, {hi}] is not "
                             f"within [1, {cap}]")
        out.append((lo, hi))
    return tuple(out)


def loguniform_counts(rng: np.random.Generator, shape, lo: int,
                      hi: int) -> np.ndarray:
    """Integers in [lo, hi], log-uniform: floor(exp(u)) for u uniform on
    [log lo, log(hi + 1)), so that P(n) is proportional to log((n+1)/n)."""
    u = rng.random(shape)
    n = np.floor(np.exp(np.log(lo) + u * (np.log(hi + 1) - np.log(lo))))
    return np.clip(n, lo, hi).astype(np.int32)


def latent_counts(lat: dict, pool: int, seed: int):
    """(minu_n [pool, T], tex_n [pool]) int32 of the pool's latents: the
    configuration's law drawn from ``derive(seed, "latent_counts")``
    (the T minutiae counts of every latent first, then the texture
    counts), or every latent full."""
    T, Lm, Lt = (int(lat[k]) for k in ("T", "Lm", "Lt"))
    law = count_law(lat)
    if law is None:
        return (np.full((pool, T), Lm, np.int32),
                np.full((pool,), Lt, np.int32))
    rng = np.random.default_rng(derive(seed, "latent_counts"))
    (mlo, mhi), (tlo, thi) = law
    return (loguniform_counts(rng, (pool, T), mlo, mhi),
            loguniform_counts(rng, (pool,), tlo, thi))


class Draws:
    """The raw inputs of one run of one cell, drawn from ``seed``.

    ``config`` holds the gallery and latent sizes (``gallery``, ``Rm``,
    ``Rt``, ``D``, ``pq``, ``latent``, with ``latent.counts`` where a law
    sizes the latents) and ``modes.block``; ``pool`` is the number of
    distinct latents. Gallery rows are padded up to a block multiple;
    padding rows have zero counts.
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
        self.lat_config = lat
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
        """The pool: T minutiae templates of Lm slots and one texture
        template of Lt slots each; every slot valid, or under a law of
        sizes the first ``minu_n`` / ``tex_n`` and the rest zero."""
        g = self._gen("latents")
        P, T, Lm, Lt, D = self.pool, self.T, self.Lm, self.Lt, self.D
        minu_n, tex_n = latent_counts(self.lat_config, P, self.seed)
        lat = dict(
            minu_des=self._unit(g, (P, T, Lm, D)),
            minu_xy=self._uniform(g, (P, T, Lm, 2), 24, 488),
            minu_ori=self._uniform(g, (P, T, Lm), -math.pi, math.pi),
            minu_n=torch.as_tensor(minu_n, device=self.device),
            tex_des=self._unit(g, (P, Lt, D)),
            tex_xy=torch.floor(self._uniform(g, (P, Lt, 2), 0, 30)),
            tex_ori=self._uniform(g, (P, Lt), -math.pi, math.pi),
            tex_n=torch.as_tensor(tex_n, device=self.device))
        if count_law(self.lat_config) is None:
            # every slot valid: nothing to zero, and no device work that a
            # configuration without a law did not do before (the caching
            # allocator's peak depends on the order of allocations)
            return lat
        return zero_beyond_counts(lat)

    def _mates(self):
        """Latent i's mate, planted at a seeded position: its first
        min(Rm, n_0) minutiae are noisy copies of the latent's first
        template (n_0 that template's count), its first min(Rt, tex_n)
        virtual minutiae carry the latent's coordinates and the PQ codes of
        its texture descriptors; the rest is drawn as any entry's. The
        noise is drawn for min(Rm, Lm) slots whatever the counts, so that
        the stream is the full latent's."""
        g = self._gen("mates")
        P, dev = self.pool, self.device
        pos = torch.randperm(self.G, generator=g, device=dev)[:P]
        rows = self._entries(g, P, full=True)
        lat = self.latents

        def plant(key, on, value):
            old = rows[key][:, :on.shape[1]]
            on = on.reshape(on.shape + (1,) * (value.dim() - 2))
            rows[key][:, :on.shape[1]] = torch.where(on, value, old)
        k = min(self.Rm, self.Lm)
        on = torch.arange(k, device=dev)[None] < lat["minu_n"][:, :1]
        plant("minu_xy", on, lat["minu_xy"][:, 0, :k] + MATE_XY_NOISE
              * torch.randn((P, k, 2), generator=g, device=dev))
        plant("minu_ori", on, lat["minu_ori"][:, 0, :k])
        d = lat["minu_des"][:, 0, :k] + MATE_DES_NOISE * torch.randn(
            (P, k, self.D), generator=g, device=dev)
        plant("minu_des", on, d / (d.norm(dim=-1, keepdim=True) + 1e-7)
              * DES_NORM)
        k = min(self.Rt, self.Lt)
        on = torch.arange(k, device=dev)[None] < lat["tex_n"][:, None]
        plant("tex_xy", on, lat["tex_xy"][:, :k])
        plant("tex_ori", on, lat["tex_ori"][:, :k])
        plant("tex_codes", on, pq_encode(
            lat["tex_des"][:, :k].reshape(-1, self.D),
            self.codebook_t).reshape(P, k, self.S))
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
    """Zero every minutiae / texture slot at or beyond its count: an
    entry's (``minu_n`` [N], ``tex_n`` [N]), or each latent template's
    (``minu_n`` [P, T]) and each latent's texture (``tex_n`` [P])."""
    for key, fields in (("minu_n", ("minu_des", "minu_xy", "minu_ori")),
                        ("tex_n", ("tex_des", "tex_codes", "tex_xy",
                                   "tex_ori"))):
        n = rows[key]
        for k in fields:
            if k not in rows:
                continue
            v = rows[k]
            on = torch.arange(v.shape[n.dim()], device=n.device) < n[..., None]
            rows[k] = v * on.reshape(on.shape + (1,) * (v.dim() - on.dim())
                                     ).to(v.dtype)
    return rows
