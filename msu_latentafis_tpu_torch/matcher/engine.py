"""Gallery-scale dense matching engine (PyTorch).

Counterpart of the JAX package's ``MatchEngine`` dense path
(``matcher/engine.py``: ``load_gallery``, ``_match_all``, ``one_to_list``).
The whole gallery lives on the device as dense padded tensors and a batch
of latents is scored against it block by block:

- minutiae-template scores from the ``minutiae_match`` kernel;
- texture scores from ``adc_rowmax`` (ADC similarity row maxima against
  the predecoded gallery) and ``texture_match`` (top-200 + filter);
- fused score = s0 + s1 + s2 + 0.3 * s_tex (matcher.cpp:188/:293), -1 for
  empty gallery entries (skip semantics of matcher.cpp:181-186).

On a CUDA device every block runs the three kernels; on the CPU the same
wrappers run their plain PyTorch versions.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..templates.data_model import MatcherConstants as MC
from ..templates.packing import PackedGallery, PackedLatent
from .kernels import ops
from .texture_match import decode_pq

DECODE_CHUNK = 4096      # gallery entries decoded per gather (bounds the
#                          int64 index temporaries to ~0.5 GB)


@dataclasses.dataclass
class DeviceGallery:
    """A PackedGallery resident on one device, padded to a block multiple.

    Descriptors keep the minutiae axis before the feature axis; coordinate
    packs are (x, y, cos ori, sin ori). Texture descriptors are predecoded
    f32 reconstructions of the PQ codes.
    """
    minu_des: torch.Tensor           # [G, Rm, D] f32
    minu_pack: torch.Tensor          # [G, Rm, 4] f32
    minu_n: torch.Tensor             # [G] int32
    tex_dec: torch.Tensor            # [G, Rt, D] f32
    tex_sqnorm: torch.Tensor         # [G, Rt] f32 (||decode(codes)||^2)
    tex_pack: torch.Tensor           # [G, Rt, 4] f32 (quantized x, y)
    tex_n: torch.Tensor              # [G] int32
    names: List[str]
    n_real: int                      # entries before block padding

    @property
    def size(self) -> int:
        return int(self.minu_des.shape[0])


@dataclasses.dataclass
class MatchResult:
    scores: np.ndarray               # [n_real] fused scores (-1 = skipped)
    names: List[str]

    def ranked(self, k: Optional[int] = None) -> List[Tuple[str, float]]:
        order = np.argsort(-self.scores, kind="stable")
        if k is not None:
            order = order[:k]
        return [(self.names[i], float(self.scores[i])) for i in order]


def coord_pack(xy: torch.Tensor, ori: torch.Tensor) -> torch.Tensor:
    """[..., 2] coordinates + [...] orientations -> [..., 4] packs."""
    return torch.stack([xy[..., 0], xy[..., 1], torch.cos(ori),
                        torch.sin(ori)], dim=-1).contiguous()


def _valid(n: torch.Tensor, size: int) -> torch.Tensor:
    return (torch.arange(size, device=n.device) < n[..., None]).float()


class MatchEngine:
    """Scores latents against a device-resident gallery (dense, exact).

    codebook: f32 [n_subs, n_clusters, sub_dim] PQ codebook.
    block_size: gallery entries per kernel launch.
    compute_dtype: only torch.float32 in this port so far.
    row_cap: minutiae candidates per latent row (8, as on the TPU; the
        top-120 is exact while no latent row holds more than row_cap of it).
    device: "cuda" unless the caller asks for "cpu".
    """

    def __init__(self, codebook: np.ndarray, block_size: int = 64,
                 compute_dtype=torch.float32, row_cap: int = 8,
                 device="cuda"):
        if compute_dtype != torch.float32:
            raise NotImplementedError(
                "only float32 compute is ported; bf16/int8 modes are later work")
        self.device = torch.device(device)
        self.codebook = np.asarray(codebook, np.float32)
        self.codebook_t = torch.as_tensor(self.codebook, device=self.device)
        self.n_subs, self.n_clusters, self.sub_dim = self.codebook.shape
        self.block_size = int(block_size)
        self.row_cap = int(row_cap)

    # ------------------------------------------------------------------
    def load_gallery(self, packed: PackedGallery) -> DeviceGallery:
        """Pad the gallery axis to a block multiple, move it to the device
        and predecode the PQ codes to f32 (chunked)."""
        B = self.block_size
        G0 = packed.size
        G = -(-G0 // B) * B

        def put(a, dtype=None):
            t = torch.as_tensor(np.asarray(a), device=self.device)
            if dtype is not None:
                t = t.to(dtype)
            if t.shape[0] != G:
                pad = torch.zeros((G - t.shape[0],) + tuple(t.shape[1:]),
                                  dtype=t.dtype, device=self.device)
                t = torch.cat([t, pad])
            return t.contiguous()

        codes = put(packed.tex_codes)
        dec = torch.empty(tuple(codes.shape[:2]) + (
            self.n_subs * self.sub_dim,), dtype=torch.float32,
            device=self.device)
        for a in range(0, G, DECODE_CHUNK):
            dec[a:a + DECODE_CHUNK] = decode_pq(codes[a:a + DECODE_CHUNK],
                                                self.codebook_t)
        return DeviceGallery(
            minu_des=put(packed.minu_des, torch.float32),
            minu_pack=coord_pack(put(packed.minu_xy), put(packed.minu_ori)),
            minu_n=put(packed.minu_n, torch.int32),
            tex_dec=dec,
            tex_sqnorm=put(packed.tex_sqnorm, torch.float32),
            tex_pack=coord_pack(put(packed.tex_xy), put(packed.tex_ori)),
            tex_n=put(packed.tex_n, torch.int32),
            names=list(packed.names), n_real=G0)

    # ------------------------------------------------------------------
    def latent_batch(self, lats: Sequence[PackedLatent]) -> dict:
        """Stack same-shape latents on the engine's device (leading NL)."""
        def f(attr, dtype):
            return torch.as_tensor(np.stack([getattr(l, attr) for l in lats]),
                                   device=self.device).to(dtype)
        f32, i32 = torch.float32, torch.int32
        return dict(minu_des=f("minu_des", f32), minu_xy=f("minu_xy", f32),
                    minu_ori=f("minu_ori", f32), minu_n=f("minu_n", i32),
                    tex_des=f("tex_des", f32), tex_xy=f("tex_xy", f32),
                    tex_ori=f("tex_ori", f32), tex_n=f("tex_n", i32))

    def latent_side(self, lat: dict) -> dict:
        """Block-invariant latent operands of the three kernels."""
        NL, T, Lm, D = lat["minu_des"].shape
        Lt = lat["tex_des"].shape[1]
        tex_des = lat["tex_des"].contiguous()
        return dict(
            NL=NL, T=T,
            minu_des=lat["minu_des"].reshape(NL * T, Lm, D).contiguous(),
            minu_valid=_valid(lat["minu_n"], Lm).reshape(NL * T, Lm),
            minu_pack=coord_pack(lat["minu_xy"], lat["minu_ori"])
            .reshape(NL * T, Lm, 4),
            tex_des=tex_des, tex_sq=(tex_des * tex_des).sum(dim=-1),
            tex_valid=_valid(lat["tex_n"], Lt),
            tex_pack=coord_pack(lat["tex_xy"], lat["tex_ori"]),
            k_tex=min(MC.TOPN_TEX_CORR, Lt))

    def block_args(self, L: dict, gal: DeviceGallery, a: int):
        """Keyword arguments of minutiae_match, adc_rowmax and texture_match
        (which also takes adc_rowmax's best, bestj) for the gallery block
        starting at entry ``a``."""
        blk = slice(a, a + self.block_size)
        Rm, Rt = gal.minu_des.shape[1], gal.tex_dec.shape[1]
        minu = dict(ldes=L["minu_des"], lvalid=L["minu_valid"],
                    rdes=gal.minu_des[blk], rvalid=_valid(gal.minu_n[blk], Rm),
                    lpack=L["minu_pack"], rpack=gal.minu_pack[blk],
                    top_n=MC.TOPN_MINU_CORR, row_cap=self.row_cap,
                    lookup=False, dist_iters=5)
        adc = dict(x=L["tex_des"], lsq=L["tex_sq"], dec=gal.tex_dec[blk],
                   rsq=gal.tex_sqnorm[blk],
                   rvalid=_valid(gal.tex_n[blk], Rt))
        tex = dict(lvalid=L["tex_valid"], lpack=L["tex_pack"],
                   rpack=gal.tex_pack[blk], top_n=L["k_tex"], lookup=True,
                   dist_iters=3)
        return minu, adc, tex

    def _match_all(self, lat: dict, gal: DeviceGallery,
                   components: bool = False):
        """NL latents against the whole gallery -> fused scores [NL, G].

        ``components=True`` returns the unfused (s_minu [NL, T, G],
        s_tex [NL, G]) instead (One2One_matching_all_templates surface).
        """
        B = self.block_size
        if gal.size % B:
            raise ValueError(f"gallery size {gal.size} is not a multiple of {B}")
        L = self.latent_side(lat)
        s_minu_all, s_tex_all, fused_all = [], [], []
        for a in range(0, gal.size, B):
            minu, adc, tex = self.block_args(L, gal, a)
            s_minu = ops.minutiae_match(**minu).reshape(L["NL"], L["T"], B)
            best, bestj = ops.adc_rowmax(**adc)
            s_tex = ops.texture_match(best, bestj, **tex)
            if components:
                s_minu_all.append(s_minu)
                s_tex_all.append(s_tex)
                continue
            fused = s_minu.sum(dim=1) + MC.TEXTURE_SCORE_WEIGHT * s_tex
            nonempty = (gal.minu_n[a:a + B] > 0) | (gal.tex_n[a:a + B] > 0)
            fused_all.append(torch.where(nonempty[None, :], fused,
                                         torch.full_like(fused, -1.0)))
        if components:
            return torch.cat(s_minu_all, dim=2), torch.cat(s_tex_all, dim=1)
        return torch.cat(fused_all, dim=1)

    # ------------------------------------------------------------------
    def match_scores(self, latent: PackedLatent,
                     gallery: DeviceGallery) -> torch.Tensor:
        """Raw device scores [G_padded] for one latent."""
        return self._match_all(self.latent_batch([latent]), gallery)[0]

    def match_scores_batch(self, latents: Sequence[PackedLatent],
                           gallery: DeviceGallery) -> torch.Tensor:
        """Scores [NL, G_padded] for a batch of same-shape latents."""
        return self._match_all(self.latent_batch(latents), gallery)

    def one_to_list(self, latent: PackedLatent,
                    gallery: DeviceGallery) -> MatchResult:
        scores = self.match_scores(latent, gallery)[:gallery.n_real]
        return MatchResult(scores=scores.cpu().numpy(), names=gallery.names)


def write_score_csv(path: str, result: MatchResult) -> None:
    """List2List-style score file: one '<name>,<score>' line per gallery
    entry, fixed 3 decimals (matcher.cpp:198-205)."""
    with open(path, "w") as f:
        for name, score in zip(result.names, result.scores):
            f.write(f"{name},{score:.3f}\n")


def write_rank_csv(path: str, result: MatchResult, top_k: int = 24) -> None:
    """One2List-style ranked candidate list (matcher.cpp:305-330)."""
    with open(path, "w") as f:
        f.write("filename,score\n")
        for rank, (name, score) in enumerate(result.ranked(top_k), start=1):
            f.write(f"{rank}{name},{score}\n")
