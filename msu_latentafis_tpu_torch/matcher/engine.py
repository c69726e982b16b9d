"""Gallery-scale matching engine (PyTorch): dense and screen-then-rerank.

Counterpart of the JAX package's ``MatchEngine`` (``matcher/engine.py``:
``load_gallery``, ``_match_all``, ``one_to_list``, ``list_to_list``,
``one_to_one_all_templates``, ``_screen_all``,
``match_scores_batch_reranked``, ``one_to_list_reranked``; and
``write_corr_files``). The whole gallery lives on the device as dense
padded tensors:

- dense exact path, block by block: minutiae-template scores from the
  ``minutiae_match`` kernel; texture scores from ``adc_rowmax`` (or
  ``adc_rowmax_codes`` over a codes-resident gallery) and
  ``texture_match``; fused score = s0 + s1 + s2 + 0.3 * s_tex
  (matcher.cpp:188/:293), -1 for empty gallery entries (skip semantics of
  matcher.cpp:181-186);
- serving path: the ``minu_screen`` (``minu_screen_norm`` with
  ``normalize=True``) and ``adc_screen`` (``adc_screen_codes``) kernels
  screen every entry, a stable top-k keeps the best m per latent, and the
  dense exact path scores only those.

Throughput modes, as in the JAX engine: ``compute_dtype=torch.bfloat16``
gives every kernel bf16 descriptor operands (f32 accumulation);
``tex_int8`` stores the predecoded texture gallery as int8 with one global
scale, folded into the latent operand; ``minu_int8`` stores the gallery's
minutiae descriptors as int8 with one scale per gallery
(``DeviceGallery.minu_scale``), folded in the same way. The squared norms
and everything after the dot products stay f32.

On a CUDA device every step runs the kernels; on the CPU the same wrappers
run their plain PyTorch versions.

While a torch profiler records, the search path records spans
(``utils.timing.span``), named by layer (the name up to the first dot):
``search`` (a request: each ``match_scores_batch_reranked`` and
``list_to_list`` call), ``dispatch.pack`` (``latent_batch``,
``list_to_list``'s bucketing), ``dispatch.side`` (``latent_side``,
``screen_side``), ``screen`` (each ``_screen_all``), ``exact`` (each
``_match_all``), ``select.topk`` (the stable sorts and the gather),
``select.take`` (``DeviceGallery.take``), ``select.readback`` (the copies
to the host and the NumPy work after them) and ``select.rank``
(``MatchResult.ranked``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..templates.data_model import MatcherConstants as MC
from ..templates.packing import (PackedGallery, PackedLatent, pack_gallery,
                                 pack_latent, repad_latent)
from ..utils.timing import span
from .graph_filter import coord_pack
from .kernels import ops
from .texture_match import decode_pq

DECODE_CHUNK = 4096      # gallery entries decoded per gather (bounds the
#                          int64 index temporaries to ~0.5 GB)
SCREEN_CHUNK = 16384     # gallery entries per screen launch (rounded down to
#                          a block multiple): a screen entry carries no
#                          state, so only the validity masks and the
#                          screen's two aug planes (~30 MB each at Rt 448)
#                          bound the chunk
LM_BUCKET = 32           # list_to_list pads latents to multiples of these
LT_BUCKET = 128          # (minutiae, texture minutiae) slots, the JAX
#                          engine's buckets, so that a batch has one shape
MAX_BATCH = 8            # latents per list_to_list batch


@dataclasses.dataclass
class DeviceGallery:
    """A PackedGallery resident on one device, padded to a block multiple.

    Descriptors keep the minutiae axis before the feature axis; coordinate
    packs are (x, y, cos ori, sin ori). The texture side is either
    predecoded reconstructions of the PQ codes (``tex_dec``, in the compute
    dtype or int8) or, for a codes-resident gallery, the uint8 codes
    themselves (``tex_codes``, 16 B per minutia), decoded inside the
    kernels. A gallery holds exactly one of the two. ``minu_scale`` [1] f32
    is the dequantization scale of int8 ``minu_des`` (None otherwise).
    """
    minu_des: torch.Tensor           # [G, Rm, D] f32, bf16 or int8
    minu_pack: torch.Tensor          # [G, Rm, 4] f32
    minu_n: torch.Tensor             # [G] int32
    tex_sqnorm: torch.Tensor         # [G, Rt] f32 (||decode(codes)||^2)
    tex_pack: torch.Tensor           # [G, Rt, 4] f32 (quantized x, y)
    tex_n: torch.Tensor              # [G] int32
    names: List[str]
    n_real: int                      # entries before block padding
    tex_dec: Optional[torch.Tensor] = None    # [G, Rt, D] f32/bf16/int8
    tex_codes: Optional[torch.Tensor] = None  # [G, Rt, S] uint8
    minu_scale: Optional[torch.Tensor] = None  # [1] f32 with int8 minu_des

    TENSORS = ("minu_des", "minu_pack", "minu_n", "tex_sqnorm", "tex_pack",
               "tex_n", "tex_dec", "tex_codes")

    def __post_init__(self):
        if (self.tex_dec is None) == (self.tex_codes is None):
            raise ValueError("a gallery holds exactly one of tex_dec and "
                             "tex_codes")

    @property
    def size(self) -> int:
        return int(self.minu_des.shape[0])

    @property
    def codes_resident(self) -> bool:
        return self.tex_dec is None

    def take(self, idx: torch.Tensor) -> "DeviceGallery":
        """The rows ``idx`` [m] (int64, on the gallery's device) of every
        tensor, in that order. The result is nameless: its rows are
        positions in this gallery, which names them."""
        with span("select.take"):
            return DeviceGallery(
                names=[], n_real=int(idx.shape[0]),
                minu_scale=self.minu_scale,
                **{f: None if getattr(self, f) is None
                   else getattr(self, f).index_select(0, idx)
                   for f in self.TENSORS})


@dataclasses.dataclass
class MatchResult:
    scores: np.ndarray               # [n_real] fused scores (-1 = skipped)
    names: List[str]

    def ranked(self, k: Optional[int] = None) -> List[Tuple[str, float]]:
        with span("select.rank"):
            order = np.argsort(-self.scores, kind="stable")
            if k is not None:
                order = order[:k]
            return [(self.names[i], float(self.scores[i])) for i in order]


def _valid(n: torch.Tensor, size: int) -> torch.Tensor:
    return (torch.arange(size, device=n.device) < n[..., None]).float()


class MatchEngine:
    """Scores latents against a device-resident gallery.

    codebook: f32 [n_subs, n_clusters, sub_dim] PQ codebook.
    block_size: gallery entries per launch of the dense exact path (and
        per scale of the int8 screen's -rsq / 2 row).
    compute_dtype: torch.float32 (parity) or torch.bfloat16 (throughput):
        the type of every descriptor operand of the kernels.
    row_cap: minutiae candidates per latent row (8, as on the TPU; the
        top-120 is exact while no latent row holds more than row_cap of it).
    codes_resident: keep the texture gallery as uint8 PQ codes instead of
        predecoding it (the JAX engine's ``predecode=False``); None decides
        by ``should_predecode``.
    tex_int8: predecode the texture gallery to int8 with the global scale
        max|codebook| / 127.
    minu_int8: store the gallery's minutiae descriptors as int8 with the
        scale max|minu_des| / 127 of the gallery loaded.
    device: "cuda" unless the caller asks for "cpu".
    """

    # The JAX engine's budget for predecoded texture (``_should_predecode``),
    # kept for galleries in host memory, counted as the JAX engine counts:
    # 2 bytes per element, 1 with tex_int8. At Rt 448 / D 96, block 64, a
    # padded gallery of more than 104,576 entries (209,216 with tex_int8)
    # stays codes-resident there.
    PREDECODE_BUDGET_BYTES = 9_000_000_000

    def __init__(self, codebook: np.ndarray, block_size: int = 64,
                 compute_dtype=torch.float32, row_cap: int = 8,
                 codes_resident: Optional[bool] = None,
                 tex_int8: bool = False, minu_int8: bool = False,
                 device="cuda"):
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype {compute_dtype}: float32 or "
                             f"bfloat16")
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.tex_int8 = bool(tex_int8)
        self.minu_int8 = bool(minu_int8)
        self.codebook = np.asarray(codebook, np.float32)
        self.codebook_t = torch.as_tensor(self.codebook, device=self.device)
        # the codebook the kernels and the predecode read: in the compute
        # dtype, as the JAX engine builds its decode tensors
        self.codebook_k = self.codebook_t.to(compute_dtype)
        self.n_subs, self.n_clusters, self.sub_dim = self.codebook.shape
        # tex_int8: decoded values are codebook entries, so one global scale
        # bounds them; quantizing the (compute-dtype) codebook once gives
        # the quantized decode by the same gather, as the JAX engine's
        # clip(round(decode / scale)) would elementwise
        self.tex_scale = float(np.float32(
            float(np.abs(self.codebook).max()) / 127.0 + 1e-12))
        self.codebook_q = None
        if self.tex_int8:
            cbk = self.codebook_k.float().cpu().numpy()
            self.codebook_q = torch.as_tensor(np.clip(np.round(
                cbk / np.float32(self.tex_scale)), -127, 127).astype(np.int8),
                device=self.device)
        self.block_size = int(block_size)
        self.row_cap = int(row_cap)
        self.codes_resident = codes_resident

    @property
    def tex_dec_dtype(self) -> torch.dtype:
        return torch.int8 if self.tex_int8 else self.compute_dtype

    def should_predecode(self, G: int, Rt: int) -> bool:
        """Predecode a G x Rt texture gallery unless the caller fixed the
        layout or it would not fit: on a CUDA device, the bytes the
        predecoded tensor takes (4 per element in f32, 2 in bf16, 1 with
        tex_int8) within half the device memory free at load time (the
        other half holds the screen's chunk temporaries and the rerank's
        sub-galleries); in host memory, the JAX engine's rule and budget.
        The predecoded layout serves faster."""
        if self.codes_resident is not None:
            return not self.codes_resident
        elems = G * Rt * self.n_subs * self.sub_dim
        if self.device.type == "cuda":
            nbytes = elems * self.tex_dec_dtype.itemsize
            return nbytes < torch.cuda.mem_get_info(self.device)[0] // 2
        return elems * (1 if self.tex_int8 else 2) \
            < self.PREDECODE_BUDGET_BYTES

    def predecode(self, codes: torch.Tensor) -> torch.Tensor:
        """uint8 PQ codes [..., S] -> the predecoded texture [..., D] of
        this engine's mode: in the compute dtype, or int8 with tex_int8."""
        if self.tex_int8:
            return decode_pq(codes, self.codebook_q)
        return decode_pq(codes, self.codebook_k)

    def minutiae_storage(self, des: torch.Tensor,
                         scale: Optional[float] = None):
        """Gallery minutiae descriptors (f32, any shape) -> (stored, scale):
        in the compute dtype and None, or with minu_int8 int8
        clip(round(des / s)) and s = [max|des| / 127 + 1e-12] f32, computed
        as the JAX engine's load_gallery computes them; a given ``scale``
        is s instead (a gallery quantized piece by piece)."""
        if not self.minu_int8:
            return des.to(self.compute_dtype), None
        if scale is None:
            scale = float(des.abs().max()) / 127.0 + 1e-12
        q = torch.clamp(torch.round(ops.true_div(des, float(np.float32(
            scale)))), -127, 127).to(torch.int8)
        return q, torch.full((1,), scale, dtype=torch.float32,
                             device=des.device)

    # ------------------------------------------------------------------
    def load_gallery(self, packed: PackedGallery) -> DeviceGallery:
        """Pad the gallery axis to a block multiple, move it to the device
        and, unless it stays codes-resident, predecode the PQ codes
        (chunked). With minu_int8 the descriptors are quantized on the host
        with the JAX engine's NumPy expression, so the int8 bits equal its
        gallery's."""
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
        tex = dict(tex_codes=codes)
        if self.should_predecode(G, codes.shape[1]):
            dec = torch.empty(tuple(codes.shape[:2]) + (
                self.n_subs * self.sub_dim,), dtype=self.tex_dec_dtype,
                device=self.device)
            for a in range(0, G, DECODE_CHUNK):
                dec[a:a + DECODE_CHUNK] = self.predecode(
                    codes[a:a + DECODE_CHUNK])
            tex = dict(tex_dec=dec)
        minu_des = np.asarray(packed.minu_des, np.float32)
        minu_scale = None
        if self.minu_int8:
            mscale = float(np.abs(minu_des).max()) / 127.0 + 1e-12
            minu_des = np.clip(np.round(minu_des / mscale), -127,
                               127).astype(np.int8)
            minu_scale = torch.full((1,), mscale, dtype=torch.float32,
                                    device=self.device)
        return DeviceGallery(
            minu_des=put(minu_des, torch.int8 if self.minu_int8
                         else self.compute_dtype), minu_scale=minu_scale,
            minu_pack=coord_pack(put(packed.minu_xy), put(packed.minu_ori)),
            minu_n=put(packed.minu_n, torch.int32),
            tex_sqnorm=put(packed.tex_sqnorm, torch.float32),
            tex_pack=coord_pack(put(packed.tex_xy), put(packed.tex_ori)),
            tex_n=put(packed.tex_n, torch.int32),
            names=list(packed.names), n_real=G0, **tex)

    # ------------------------------------------------------------------
    def latent_batch(self, lats: Sequence[PackedLatent]) -> dict:
        """Stack same-shape latents on the engine's device (leading NL)."""
        def f(attr, dtype):
            return torch.as_tensor(np.stack([getattr(l, attr) for l in lats]),
                                   device=self.device).to(dtype)
        f32, i32 = torch.float32, torch.int32
        with span("dispatch.pack"):
            return dict(
                minu_des=f("minu_des", f32), minu_xy=f("minu_xy", f32),
                minu_ori=f("minu_ori", f32), minu_n=f("minu_n", i32),
                tex_des=f("tex_des", f32), tex_xy=f("tex_xy", f32),
                tex_ori=f("tex_ori", f32), tex_n=f("tex_n", i32))

    def latent_side(self, lat: dict, gal: DeviceGallery,
                    screen: bool = False) -> dict:
        """Block-invariant latent operands of the kernels against ``gal``,
        in the compute dtype, with the gallery's int8 scales folded in as
        the JAX engine folds them: minutiae (des * minu_scale), texture
        over an int8 predecoded gallery (x * tex_scale; the dense path
        rounds x to the compute dtype before scaling, the screen after).
        The squared norms stay f32, from the unrounded descriptors."""
        with span("dispatch.side"):
            return self._side(lat, gal, screen)

    def _side(self, lat: dict, gal: DeviceGallery, screen: bool) -> dict:
        NL, T, Lm, D = lat["minu_des"].shape
        Lt = lat["tex_des"].shape[1]
        cdt = self.compute_dtype
        tex_des = lat["tex_des"].contiguous()
        minu_des = lat["minu_des"]
        if gal.minu_scale is not None:
            minu_des = minu_des.float() * gal.minu_scale
        x = tex_des.to(cdt)
        if gal.tex_dec is not None and gal.tex_dec.dtype == torch.int8:
            scale = torch.full((1,), self.tex_scale, device=tex_des.device)
            x = ((tex_des if screen else x).float() * scale).to(cdt)
        return dict(
            NL=NL, T=T,
            minu_des=minu_des.to(cdt).reshape(NL * T, Lm, D).contiguous(),
            minu_valid=_valid(lat["minu_n"], Lm).reshape(NL * T, Lm),
            minu_pack=coord_pack(lat["minu_xy"], lat["minu_ori"])
            .reshape(NL * T, Lm, 4),
            tex_des=x.contiguous(), tex_sq=(tex_des * tex_des).sum(dim=-1),
            tex_valid=_valid(lat["tex_n"], Lt),
            tex_pack=coord_pack(lat["tex_xy"], lat["tex_ori"]),
            k_tex=min(MC.TOPN_TEX_CORR, Lt))

    def _tex_operand(self, gal: DeviceGallery, rows: slice) -> dict:
        """The gallery's texture operand of the ADC kernels: ``dec`` or
        ``codes`` + ``codebook``."""
        if gal.codes_resident:
            return dict(codes=gal.tex_codes[rows], codebook=self.codebook_k)
        return dict(dec=gal.tex_dec[rows])

    def block_args(self, L: dict, gal: DeviceGallery, a: int):
        """Keyword arguments of minutiae_match, adc_rowmax (adc_rowmax_codes
        on a codes-resident gallery) and texture_match (which also takes
        the ADC kernel's best, bestj) for the gallery block starting at
        entry ``a``."""
        blk = slice(a, a + self.block_size)
        Rm, Rt = gal.minu_des.shape[1], gal.tex_sqnorm.shape[1]
        minu = dict(ldes=L["minu_des"], lvalid=L["minu_valid"],
                    rdes=gal.minu_des[blk], rvalid=_valid(gal.minu_n[blk], Rm),
                    lpack=L["minu_pack"], rpack=gal.minu_pack[blk],
                    top_n=MC.TOPN_MINU_CORR, row_cap=self.row_cap,
                    lookup=False, dist_iters=5)
        adc = dict(x=L["tex_des"], lsq=L["tex_sq"],
                   rsq=gal.tex_sqnorm[blk],
                   rvalid=_valid(gal.tex_n[blk], Rt),
                   **self._tex_operand(gal, blk))
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
        with span("exact"):
            return self._exact(lat, gal, components)

    def _exact(self, lat: dict, gal: DeviceGallery, components: bool):
        B = self.block_size
        L = self.latent_side(lat, gal)
        adc_kernel = ops.adc_rowmax_codes if gal.codes_resident \
            else ops.adc_rowmax
        s_minu_all, s_tex_all, fused_all = [], [], []
        for a in range(0, gal.size, B):
            minu, adc, tex = self.block_args(L, gal, a)
            s_minu = ops.minutiae_match(**minu).reshape(L["NL"], L["T"], B)
            best, bestj = adc_kernel(**adc)
            s_tex = ops.texture_match(best, bestj, **tex)
            if components:
                s_minu_all.append(s_minu)
                s_tex_all.append(s_tex)
                continue
            fused = s_minu.sum(dim=1) + MC.TEXTURE_SCORE_WEIGHT * s_tex
            fused_all.append(_skip_empty(fused, gal, slice(a, a + B)))
        if components:
            return torch.cat(s_minu_all, dim=2), torch.cat(s_tex_all, dim=1)
        return torch.cat(fused_all, dim=1)

    # ------------------------------------------------------------------
    def screen_side(self, lat: dict, gal: DeviceGallery, lt_cap: int = 0,
                    minu_t_cap: int = 0) -> dict:
        """The screen's ``latent_side`` of a latent batch, truncated for the
        cheap first stage of two-stage screening: the first ``lt_cap``
        texture minutiae and the first ``minu_t_cap`` minutiae templates
        (0 keeps all)."""
        with span("dispatch.side"):
            lat = dict(lat)
            if minu_t_cap:
                for k in ("minu_des", "minu_xy", "minu_ori", "minu_n"):
                    lat[k] = lat[k][:, :minu_t_cap]
            if lt_cap:
                for k in ("tex_des", "tex_xy", "tex_ori"):
                    lat[k] = lat[k][:, :lt_cap]
                lat["tex_n"] = torch.clamp(lat["tex_n"], max=lt_cap)
            return self._side(lat, gal, screen=True)

    def screen_args(self, L: dict, gal: DeviceGallery, rows: slice):
        """Keyword arguments of minu_screen and adc_screen (adc_screen_codes
        on a codes-resident gallery) for the gallery rows ``rows``; an int8
        texture gallery's screen takes one scale per engine block, counted
        from the first of ``rows``."""
        Rm, Rt = gal.minu_des.shape[1], gal.tex_sqnorm.shape[1]
        minu = dict(ldes=L["minu_des"], lvalid=L["minu_valid"],
                    rdes=gal.minu_des[rows],
                    rvalid=_valid(gal.minu_n[rows], Rm))
        adc = dict(x=L["tex_des"], lsq=L["tex_sq"], lvalid=L["tex_valid"],
                   rsq=gal.tex_sqnorm[rows],
                   rvalid=_valid(gal.tex_n[rows], Rt),
                   **self._tex_operand(gal, rows))
        if not gal.codes_resident and gal.tex_dec.dtype == torch.int8:
            adc["block"] = self.block_size
        return minu, adc

    def _screen_all(self, lat: dict, gal: DeviceGallery, tau: float = 0.0,
                    normalize: bool = False, lt_cap: int = 0,
                    minu_t_cap: int = 0) -> torch.Tensor:
        """Screening scores [NL, G]: sum over templates of ``minu_screen``
        + 0.3 * ``adc_screen``, -1 for empty entries. With tau = 0 and
        normalize False an upper bound on the exact fused score; the bound
        does not survive the truncation of ``lt_cap`` / ``minu_t_cap``
        (``screen_side``), and ``normalize=True`` (the mutually normalized
        minutiae screen, a heuristic) bounds nothing. Each kernel launches
        once per SCREEN_CHUNK entries (rounded down to a block multiple,
        so that the int8 screen's scale groups are the JAX engine's
        blocks).
        """
        with span("screen"):
            return self._screen(lat, gal, tau, normalize, lt_cap, minu_t_cap)

    def _screen(self, lat: dict, gal: DeviceGallery, tau: float,
                normalize: bool, lt_cap: int, minu_t_cap: int) -> torch.Tensor:
        L = self.screen_side(lat, gal, lt_cap, minu_t_cap)
        adc_kernel = ops.adc_screen_codes if gal.codes_resident \
            else ops.adc_screen
        chunk = self.screen_chunk
        out = []
        for a in range(0, gal.size, chunk):
            rows = slice(a, a + chunk)
            minu, adc = self.screen_args(L, gal, rows)
            s_minu = ops.minu_screen(normalize=normalize, **minu)
            s_tex = adc_kernel(tau=tau, **adc)
            screen = s_minu.reshape(L["NL"], L["T"], -1).sum(dim=1) \
                + MC.TEXTURE_SCORE_WEIGHT * s_tex
            out.append(_skip_empty(screen, gal, rows))
        return torch.cat(out, dim=1)

    @property
    def screen_chunk(self) -> int:
        """Gallery entries per screen launch."""
        return max(self.block_size,
                   SCREEN_CHUNK // self.block_size * self.block_size)

    def screen_scores_batch(self, latents: Sequence[PackedLatent],
                            gallery: DeviceGallery, tau: float = 0.0,
                            normalize: bool = False) -> torch.Tensor:
        """Screening scores [NL, G_padded] for a batch of latents."""
        return self._screen_all(self.latent_batch(latents), gallery, tau=tau,
                                normalize=normalize)

    def match_scores_batch_reranked(
            self, latents: Sequence[PackedLatent], gallery: DeviceGallery,
            m: int = 512, tau: float = 0.0, normalize: bool = False,
            prescreen_k: int = 0, prescreen_lt: int = 0,
            prescreen_t: int = 0,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Screen-then-rerank serving path.

        1. screen every (latent, entry) pair; with ``prescreen_k`` the
           screen is two-stage: a truncated-latent screen (``prescreen_lt``
           texture minutiae, ``prescreen_t`` minutiae templates) over the
           whole gallery, then, when its k1 = max(B, (prescreen_k // B) B)
           candidates outnumber the m_pad kept, the full screen over those
           candidates, in candidate order;
        2. keep the top m_pad = min(m, G) rounded up to a block multiple
           (capped at G) per latent;
        3. run the dense exact path on each latent's gathered sub-gallery.

        Every top-k is a stable descending sort, so equal screens keep the
        lower position first, as ``jax.lax.top_k`` does. Returns NumPy
        (idx [NL, m_pad], exact [NL, m_pad], margin [NL], threshold [NL]):
        threshold is the best screen outside the kept set (-inf when
        m_pad >= G) and margin the exact 24th score minus it; both are NaN
        whenever ``prescreen_k`` is set, since a truncated screen bounds
        nothing. They are numbers with ``normalize=True`` and no prescreen,
        as in the JAX engine, but certify nothing then: the normalized
        screen is no upper bound on the exact score.
        """
        with span("search"):
            return self._reranked(latents, gallery, m, tau, normalize,
                                  prescreen_k, prescreen_lt, prescreen_t)

    def _reranked(self, latents, gallery, m, tau, normalize, prescreen_k,
                  prescreen_lt, prescreen_t):
        B = self.block_size
        lat = self.latent_batch(latents)
        NL = lat["minu_des"].shape[0]
        G = gallery.size
        m_pad = min(-(-min(m, G) // B) * B, G)

        def topk(s, k):
            with span("select.topk"):
                v, i = torch.sort(s, dim=1, descending=True, stable=True)
                return v[:, :k], i[:, :k]

        if prescreen_k and prescreen_k < G:
            k1 = max(B, (prescreen_k // B) * B)
            s1 = self._screen_all(lat, gallery, tau=tau, normalize=normalize,
                                  lt_cap=prescreen_lt,
                                  minu_t_cap=prescreen_t)
            if k1 <= m_pad:
                topv, topi = topk(s1, min(m_pad + 1, G))
            else:
                _, cand = topk(s1, k1)
                s2 = torch.cat([self._screen_all(
                    _row(lat, i), gallery.take(cand[i]), tau=tau,
                    normalize=normalize) for i in range(NL)])
                topv, sel = topk(s2, min(m_pad + 1, k1))
                with span("select.topk"):
                    topi = torch.gather(cand, 1, sel)
        else:
            topv, topi = topk(self._screen_all(lat, gallery, tau=tau,
                                               normalize=normalize),
                              min(m_pad + 1, G))
        exact = torch.cat([self._match_all(_row(lat, i),
                                           gallery.take(topi[i, :m_pad]))
                           for i in range(NL)])
        with span("select.readback"):
            idx = topi[:, :m_pad].cpu().numpy()
            exact = exact.cpu().numpy()
            if prescreen_k:
                nan = np.full((NL,), np.nan, np.float32)
                return idx, exact, nan, nan
            outside = (topv[:, m_pad].cpu().numpy() if m_pad < G
                       else np.full((NL,), -np.inf, np.float32))
            order = np.argsort(-exact, axis=1, kind="stable")
            k24 = min(24, m_pad) - 1
            margin = exact[np.arange(NL), order[:, k24]] - outside
            return idx, exact, margin, outside

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
        with span("select.readback"):
            scores = scores.cpu().numpy()
        return MatchResult(scores=scores, names=gallery.names)

    def one_to_one_all_templates(self, latent, rolled) -> np.ndarray:
        """Unfused score vector for ONE latent / rolled Template pair: every
        latent minutiae template against rolled minutiae template 0, then
        every latent texture template against rolled texture template 0
        (One2One_matching_all_templates, matcher.cpp:339-374; NumPy spec:
        reference_impl.one2one_all_templates_scores), through
        ``_match_all(components=True)``. Texture coordinates are taken as
        read from final ``.dat`` files, which hold them quantized."""
        import copy
        n_minu = len(latent.minu_template)
        n_tex = len(latent.texture_template)
        out = np.zeros((n_minu + n_tex,), np.float32)
        if (n_minu <= 0 and n_tex <= 0) or (
                not rolled.minu_template and not rolled.texture_template):
            return out
        gal = self.load_gallery(pack_gallery([rolled], self.codebook,
                                             names=["rolled"]))
        for ti in range(max(n_tex, 1)):
            lt = latent
            if ti > 0:
                lt = copy.copy(latent)
                lt.texture_template = latent.texture_template[ti:ti + 1]
            packed = pack_latent(lt, selected=tuple(range(max(n_minu, 1))),
                                 quantize_tex_xy=False)
            s_minu, s_tex = self._match_all(self.latent_batch([packed]), gal,
                                            components=True)
            if ti == 0 and n_minu and rolled.minu_template:
                out[:n_minu] = s_minu[0, :n_minu, 0].cpu().numpy()
            if n_tex and rolled.texture_template:
                out[n_minu + ti] = float(s_tex[0, 0])
        return out

    def list_to_list(self, latents: Sequence[PackedLatent],
                     gallery: DeviceGallery) -> List[MatchResult]:
        """Batch (-ldir) mode: every latent against the whole gallery
        (List2List_matching, matcher.cpp:96-214), results in input order.

        Latents are padded up to (LM_BUCKET, LT_BUCKET) multiples, grouped
        by (T, Lm, Lt, D) and matched in batches of at most MAX_BATCH
        through ``match_scores_batch``: the JAX engine's buckets, which
        bound its compiles; here they give each batch the one shape that
        ``latent_batch`` stacks."""
        with span("search"):
            with span("dispatch.pack"):
                buckets: dict = {}
                for i, lat in enumerate(latents):
                    blm = -(-max(int(lat.minu_n.max()), 1) // LM_BUCKET) \
                        * LM_BUCKET
                    blt = -(-max(int(lat.tex_n), 1) // LT_BUCKET) * LT_BUCKET
                    key = (lat.minu_des.shape[0], blm, blt,
                           lat.minu_des.shape[2])
                    buckets.setdefault(key, []).append(
                        (i, repad_latent(lat, blm, blt)))
            out: List[Optional[MatchResult]] = [None] * len(latents)
            for _, group in sorted(buckets.items()):
                for start in range(0, len(group), MAX_BATCH):
                    chunk = group[start:start + MAX_BATCH]
                    scores = self.match_scores_batch([l for _, l in chunk],
                                                     gallery)
                    with span("select.readback"):
                        scores = scores[:, :gallery.n_real].cpu().numpy()
                        for (i, _), s in zip(chunk, scores):
                            out[i] = MatchResult(scores=s,
                                                 names=gallery.names)
            return out  # type: ignore[return-value]

    def one_to_list_reranked(self, latent: PackedLatent,
                             gallery: DeviceGallery, m: int = 512,
                             **kw) -> MatchResult:
        """1:N with screen-then-rerank: exact scores for the top-m screened
        candidates, -1.0 (the reference's skip marker) elsewhere."""
        idx, exact, _, _ = self.match_scores_batch_reranked(
            [latent], gallery, m=m, **kw)
        scores = np.full((len(gallery.names),), -1.0, np.float32)
        keep = idx[0] < gallery.n_real
        scores[idx[0][keep]] = exact[0][keep]
        return MatchResult(scores=scores, names=gallery.names)


def _skip_empty(score: torch.Tensor, gal: DeviceGallery,
                rows: slice) -> torch.Tensor:
    """-1.0 (the reference's skip marker) for the empty entries of
    ``rows``; ``score`` is [NL, len(rows)]."""
    nonempty = (gal.minu_n[rows] > 0) | (gal.tex_n[rows] > 0)
    return torch.where(nonempty[None, :], score, torch.full_like(score, -1.0))


def _row(lat: dict, i: int) -> dict:
    """Latent i of a batch, as a batch of one."""
    return {k: v[i:i + 1] for k, v in lat.items()}


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


def write_corr_files(latent, rolled, codebook: np.ndarray,
                     prefix: str) -> List[str]:
    """Write the surviving minutiae correspondences of one latent / rolled
    pair as ``<prefix>_<i>.csv``, one per selected latent minutiae
    template, rows ``lx,ly,rx,ry``: the reference's save_corr output for
    the top-24 candidates (matcher.cpp:305-330, :405-406, :497-506), from
    the NumPy spec (reference_impl.one2one_selected_scores).

    ``latent`` / ``rolled`` are in-memory Templates; returns the files
    written."""
    from .reference_impl import one2one_selected_scores
    out = one2one_selected_scores(latent, rolled, codebook, return_corr=True)
    written: List[str] = []
    if out is None:
        return written
    _, corrs = out
    for i, corr in enumerate(corrs):
        path = f"{prefix}_{i}.csv"
        with open(path, "w") as f:
            for lx, ly, rx, ry in corr:
                f.write(f"{lx:g},{ly:g},{rx:g},{ry:g}\n")
        written.append(path)
    return written
