"""The yardstick of the kernel layer: each kernel's operations and bytes
from the shapes of a batch and the latents it carried, and the card's
peaks.

Operations follow the algorithm, whatever a kernel computes: 2 Lt Rt D a
latent-entry pair for an ADC screen or row maximum, 2 P R D a template-entry
pair for a minutiae screen, and ``minutiae_match``'s similarity, mutual
normalisation and row-cap selection (``chip_smoke.py``'s ``match_records``
counts). On the latent's side P and Lt are its valid counts (``LatentSize``:
each template's minutiae, its virtual minutiae), never the slots a program
pads them to, so the count is the same work whatever implements it; the
gallery's side is counted at its capacities Rm and Rt. A window's least
time is the sum of its batches' (``window_least_s``). The graph filter's
data-dependent work is not counted here (``spans.exact_roofline_counted``
adds the program's counts of it). Bytes count each input read once and
each output written once per launch. The peak is that of the operand types
the configuration states: 989 TFLOP/s where either side is bf16, 67 TFLOP/s
for f32 (the filters' arithmetic); 3.35 TB/s of HBM (NVIDIA's data sheet,
H100 SXM, dense rates, 700 W). A mix whose prescreen keeps more candidates
than m_pad, which would add a second screen, is refused by the harness.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float32": 4, "int8": 1, "uint8": 1}

Work = Tuple[float, float, float]          # (operations, bytes, peak)
LatentSize = Tuple[Tuple[int, ...], int]   # (each template's minu_n, tex_n)


def op_peak(a: str, b: str) -> float:
    return PEAK_BF16 if "bfloat16" in (a, b) else PEAK_F32


def bound_s(work: List[Work]) -> float:
    """The least time of these launches: each the larger of its operations
    over its peak and its bytes over the memory rate."""
    return sum(max(o / p, b / PEAK_BYTES) for o, b, p in work)


def latent_sizes(minu_n, tex_n) -> List[LatentSize]:
    """The sizes of a pool of latents from its counts ``minu_n`` [P, T]
    and ``tex_n`` [P]."""
    return [(tuple(int(n) for n in m), int(t)) for m, t in zip(minu_n, tex_n)]


class Shapes:
    """The sizes and operand types of one cell."""

    def __init__(self, config: dict, mix: dict):
        m = config["modes"]
        self.G = int(config["gallery"])
        self.Rm, self.Rt, self.D = (int(config[k]) for k in ("Rm", "Rt", "D"))
        pq = config["pq"]
        self.S, self.C, self.sd = (int(pq[k]) for k in
                                   ("subs", "clusters", "sub_dim"))
        lat = config["latent"]
        self.T, self.Lm, self.Lt = (int(lat[k]) for k in ("T", "Lm", "Lt"))
        self.block, self.row_cap = int(m["block"]), int(m["row_cap"])
        self.lat = m["compute_dtype"]
        self.minu = "int8" if m["minu_int8"] else self.lat
        self.codes = bool(m["codes_resident"])
        self.tex = self.lat if self.codes else (
            "int8" if m["tex_int8"] else self.lat)
        self.batch = int(mix["batch"])
        self.dense = mix["entry"] == "list_to_list"
        pre = mix.get("prescreen") or {}
        self.pre_lt = int(pre.get("lt", 0)) or self.Lt
        self.pre_t = int(pre.get("t", 0)) or self.T
        Gp = -(-self.G // self.block) * self.block
        m_ = int(mix.get("m", 0))
        self.m_pad = min(-(-min(m_, Gp) // self.block) * self.block, Gp)

    @property
    def full(self) -> LatentSize:
        """A latent with every slot of the configuration's capacities."""
        return (self.Lm,) * self.T, self.Lt

    def isz(self, t: str) -> int:
        return ITEMSIZE[t]

    def tex_bytes(self, B: int) -> float:
        """The texture operand of B entries: predecoded, or codes and the
        codebook."""
        if self.codes:
            return B * self.Rt * self.S + self.S * self.C * self.sd \
                * self.isz(self.lat)
        return B * self.Rt * self.D * self.isz(self.tex)

    # -- the screen layer ------------------------------------------------
    def minu_screen(self, P: int, NT: int, B: int) -> Work:
        """NT latent templates of P valid minutiae in all against B
        entries."""
        ops = 2.0 * B * P * self.Rm * self.D
        nbytes = (B * self.Rm * (self.D * self.isz(self.minu) + 4)
                  + P * (self.D * self.isz(self.lat) + 4) + NT * B * 4)
        return ops, nbytes, op_peak(self.lat, self.minu)

    def adc_screen(self, L: int, NL: int, B: int) -> Work:
        """NL latents of L valid virtual minutiae in all against B
        entries."""
        ops = 2.0 * B * L * self.Rt * self.D
        nbytes = (self.tex_bytes(B) + B * self.Rt * 8
                  + L * (self.D * self.isz(self.lat) + 8) + NL * B * 4)
        return ops, nbytes, op_peak(self.lat, self.tex)

    def screen_batch(self, lats: Optional[Sequence[LatentSize]] = None
                     ) -> List[Work]:
        """The screens of one serving batch of ``lats`` (None: full
        latents): every entry by the (pre)screen, which takes each latent's
        first ``pre_t`` templates and first ``pre_lt`` virtual minutiae."""
        if self.dense:
            return []
        lats = [self.full] * self.batch if lats is None else lats
        t = [m[:self.pre_t] for m, _ in lats]
        return [self.minu_screen(sum(map(sum, t)), sum(map(len, t)), self.G),
                self.adc_screen(sum(min(n, self.pre_lt) for _, n in lats),
                                len(lats), self.G)]

    # -- the exact layer -------------------------------------------------
    def minutiae_match(self, P: int, NT: int, B: int) -> Work:
        """NT latent templates of P valid minutiae in all against B
        entries, a template at a time."""
        R, D, cap = self.Rm, self.D, self.row_cap
        ops = B * P * (2.0 * R * D + 5.0 * R + 2.0 * cap * R + 26.0 * cap)
        nbytes = (P * (D * self.isz(self.lat) + 4 + 16)
                  + B * R * (D * self.isz(self.minu) + 4 + 16) + NT * B * 4)
        return ops, nbytes, op_peak(self.lat, self.minu)

    def adc_rowmax(self, L: int, NL: int, B: int) -> Work:
        ops = 2.0 * B * L * self.Rt * self.D
        nbytes = (L * (self.D * self.isz(self.lat) + 4)
                  + self.tex_bytes(B) + B * self.Rt * 8 + B * L * 8)
        return ops, nbytes, op_peak(self.lat, self.tex)

    def texture_match(self, L: int, NL: int, B: int) -> Work:
        ops = 30.0 * B * L
        nbytes = B * L * 8 + L * 20 + B * self.Rt * 16 + NL * B * 4
        return ops, nbytes, PEAK_F32

    def exact_batch(self, lats: Optional[Sequence[LatentSize]] = None
                    ) -> List[Work]:
        """The exact kernels of one batch of ``lats`` (None: full latents),
        launch by launch: serving scores each latent against its m_pad kept
        entries, dense the whole batch against every entry, a block per
        launch."""
        B = self.block
        lats = [self.full] * self.batch if lats is None else lats
        if self.dense:
            groups, n = [lats], -(-self.G // B)
        else:
            groups, n = [[one] for one in lats], self.m_pad // B
        out: List[Work] = []
        for g in groups:
            P = sum(sum(m) for m, _ in g)
            NT = sum(len(m) for m, _ in g)
            L = sum(t for _, t in g)
            out += [self.minutiae_match(P, NT, B),
                    self.adc_rowmax(L, len(g), B),
                    self.texture_match(L, len(g), B)] * n
        return out


def window_least_s(shapes: Shapes,
                   batch_latents: Sequence[Optional[Sequence[LatentSize]]],
                   layer: str) -> float:
    """The least time of ``layer``'s launches ("screen" or "exact") over
    the window's batches, each counted from the latents it carried (None:
    full latents)."""
    work = shapes.screen_batch if layer == "screen" else shapes.exact_batch
    return sum(bound_s(work(lats)) for lats in batch_latents)
