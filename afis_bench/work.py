"""The yardstick of the kernel layer: each kernel's operations and bytes
from the shapes of a batch, and the card's peaks.

Operations follow the algorithm, whatever a kernel computes: 2 Lt Rt D a
latent-entry pair for an ADC screen or row maximum, 2 P R D a template-entry
pair for a minutiae screen, and ``minutiae_match``'s similarity, mutual
normalisation and row-cap selection (``chip_smoke.py``'s ``match_records``
counts). The graph filter's data-dependent work is not counted (its
candidate counts are not observable from the timed path yet), so the exact
layer's share reads low. Bytes count each input read once and each output
written once per launch. The peak is that of the operand types the
configuration states: 989 TFLOP/s where either side is bf16, 67 TFLOP/s
for f32 (the filters' arithmetic); 3.35 TB/s of HBM (NVIDIA's data sheet,
H100 SXM, dense rates, 700 W). A mix whose prescreen keeps more candidates
than m_pad, which would add a second screen, is refused by the harness.
"""
from __future__ import annotations

from typing import List, Tuple

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float32": 4, "int8": 1, "uint8": 1}

Work = Tuple[float, float, float]          # (operations, bytes, peak)


def op_peak(a: str, b: str) -> float:
    return PEAK_BF16 if "bfloat16" in (a, b) else PEAK_F32


def bound_s(work: List[Work]) -> float:
    """The least time of these launches: each the larger of its operations
    over its peak and its bytes over the memory rate."""
    return sum(max(o / p, b / PEAK_BYTES) for o, b, p in work)


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
    def minu_screen(self, NT: int, P: int, B: int) -> Work:
        ops = 2.0 * NT * B * P * self.Rm * self.D
        nbytes = (B * self.Rm * (self.D * self.isz(self.minu) + 4)
                  + NT * P * (self.D * self.isz(self.lat) + 4) + NT * B * 4)
        return ops, nbytes, op_peak(self.lat, self.minu)

    def adc_screen(self, NL: int, Lt: int, B: int) -> Work:
        ops = 2.0 * NL * B * Lt * self.Rt * self.D
        nbytes = (self.tex_bytes(B) + B * self.Rt * 8
                  + NL * Lt * (self.D * self.isz(self.lat) + 8) + NL * B * 4)
        return ops, nbytes, op_peak(self.lat, self.tex)

    def screen_batch(self) -> List[Work]:
        """The screens of one serving batch: every entry by the (pre)screen."""
        if self.dense:
            return []
        n = self.batch
        return [self.minu_screen(n * self.pre_t, self.Lm, self.G),
                self.adc_screen(n, self.pre_lt, self.G)]

    # -- the exact layer -------------------------------------------------
    def minutiae_match(self, NT: int, B: int) -> Work:
        P, R, D, cap = self.Lm, self.Rm, self.D, self.row_cap
        ops = NT * B * (2.0 * P * R * D + 5.0 * P * R + 2.0 * cap * P * R
                        + 26.0 * cap * P)
        nbytes = (NT * P * (D * self.isz(self.lat) + 4 + 16)
                  + B * R * (D * self.isz(self.minu) + 4 + 16) + NT * B * 4)
        return ops, nbytes, op_peak(self.lat, self.minu)

    def adc_rowmax(self, NL: int, B: int) -> Work:
        ops = 2.0 * NL * B * self.Lt * self.Rt * self.D
        nbytes = (NL * self.Lt * (self.D * self.isz(self.lat) + 4)
                  + self.tex_bytes(B) + B * self.Rt * 8 + NL * B * self.Lt * 8)
        return ops, nbytes, op_peak(self.lat, self.tex)

    def texture_match(self, NL: int, B: int) -> Work:
        ops = 30.0 * NL * B * self.Lt
        nbytes = (NL * B * self.Lt * 8 + NL * self.Lt * 20
                  + B * self.Rt * 16 + NL * B * 4)
        return ops, nbytes, PEAK_F32

    def exact_batch(self) -> List[Work]:
        """The exact kernels of one batch, launch by launch: serving scores
        each latent against its m_pad kept entries, dense the whole batch
        against every entry, a block per launch."""
        B = self.block
        if self.dense:
            NL, per, n = self.batch, B, -(-self.G // B)
        else:
            NL, per, n = 1, B, self.batch * (self.m_pad // B)
        one = [self.minutiae_match(NL * self.T, per),
               self.adc_rowmax(NL, per), self.texture_match(NL, per)]
        return one * n
