"""The matcher's kernels: wrappers and plain versions.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs, and then either runs the plain PyTorch version (the tensors lie
on the CPU) or launches the CUDA kernel on the current stream (they lie on
a CUDA device) and raises if the launch was refused. There is no fallback
from one to the other. ``<wrapper>.launches`` counts kernel launches.

The plain versions are the kernels' specification: the same arithmetic in
the same order, so a kernel and its plain version agree bit for bit on the
card (``chip_smoke.py`` holds them to ``KERNEL_TOL``, rtol 1e-5 /
atol 1e-4). The ADC row max with a bf16 latent side runs on the tensor
cores (``mma.sync``) and still gives the plain version's bits: it finds
each row's candidate columns within ``rowmax_threshold`` of its maximum
and recomputes them in index order. These keep the reordered sums:

- the minutiae screen with a bf16 latent side, held to ``KERNEL_TOL``;
- the predecoded ADC screen with a bf16 latent side (bf16 or int8
  gallery) and the codes ADC screen with a bf16 codebook, one body
  (``csrc/screen_body.cuh``): their row maxima round to bf16 and may land
  one bf16 ulp apart, held to ``screen_slack``; on the same entry the two
  give the same bits;
- the experiment's transposed bf16 screen, held to ``screen_t_tol``;
- the normalized minutiae screen with a bf16 latent side, held to
  ``minu_norm_interval``: its normalization divides by sums that may be
  near 1e-6, so a reordered dot can move it far past ``KERNEL_TOL``.

With f32 latents both minutiae screens give the plain bits.

Modes: the descriptor operands come in the types the JAX engine gives its
kernels: the latent side f32 or bf16 (the compute dtype, any int8 scale
folded in), the gallery side the latent's type or int8 (``tex_int8``,
``minu_int8``), the codebook of a codes kernel the latent's type. Kernels
and plain versions widen them to f32 and round where the JAX code rounds:
the screen's augmented rows in the gallery's type (``screen_aug``) and its
row maxima in the latent's type. Any other pair of types raises.

| wrapper | TPU kernel it replaces (JAX package, matcher/pallas_kernels.py) |
| --- | --- |
| adc_rowmax | fused_adc_rowmax :1489 (_adc_rowmax_kernel :29) |
| texture_match | fused_texture_match :1031 (_make_texture_match_kernel :939) |
| minutiae_match | fused_minutiae_match :878 (_make_minutiae_match_kernel :682) |
| minu_screen | fused_minu_screen fast path :1312 (_minu_screen_fast_kernel :1262) |
| minu_screen_norm | fused_minu_screen normalize=True :1312 (_minu_screen_kernel :1281) |
| adc_screen | fused_adc_screen :1106 (_adc_augmax_kernel :1080) |
| adc_screen_codes | fused_adc_screen_codes :1213 (_adc_screen_codes_kernel :1174) |
| adc_rowmax_codes | fused_adc_rowmax_codes :1434 (_adc_rowmax_codes_kernel :1387) |
| graph_filter_packed | fused_graph_filter_packed :456 (_filter_body :189) |
| graph_filter | fused_graph_filter :410 (the same CUDA kernel as graph_filter_packed) |
| graph_filter_infuse | fused_graph_filter_infuse :551 (_make_filter_gather_kernel :494) |
| screen_t_bf16 | scripts/exp_screen_mfu.py :154 (kernel_bf16 :89) |
| screen_t_int8 | scripts/exp_screen_mfu.py :124 (kernel_int8 :101) |
| h1_probe | scripts/microbench_h1_probe.py :98 (k_bcast :51, k_matmul :62, k_gram :79) |
| legality_canary | tests/test_mosaic_legality.py :44 (the block-legality canary) |

The ``_codes`` variants take uint8 PQ codes [B, Rt, S] and the codebook
[S, C, sub_dim] in place of predecoded descriptors; their plain versions
decode (an exact gather) and run the predecoded plain version, and their
kernels decode each tile from the codebook in shared memory and run the
predecoded kernel's body on it, so a codes variant and its predecoded twin
give the same bits on the same entry.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from ..graph_filter import (coord_pack, filter_correspondences, seq_dots,
                            seq_sum)
from ..minutiae_match import (SENT as MINU_SENT, minutiae_similarity,
                              mutual_normalize, row_candidates)
from ..texture_match import decode_pq
from . import _build

NEG_BIG = -1e30          # invalid rolled columns of the ADC similarity
TEX_SENT = -1e4          # invalid latent rows of the texture selection
SCREEN_SENT = -1e4       # invalid rolled columns of the ADC screen
BISECT_ITERS = 26
MAX_K = 256              # filter slots a thread block holds (8 mask words)

# the card's tolerance for a kernel against its plain version
KERNEL_TOL = dict(rtol=1e-5, atol=1e-4)
# A dot summed on the tensor cores against the same dot in index order:
# the products of bf16 (or int8 widened to bf16) operands are exact in f32,
# so only the sums differ. In index order each of the n - 1 additions
# rounds to nearest, within u = 2^-24 of a running sum no larger than
# S = sum_d |p_d|; on the tensor cores a k-step aligns its 16 products and
# the accumulator to the largest of them and may truncate, within 2u of
# that magnitude per addition, itself at most S. Each sum thus lies within
# 2 n u S of the exact dot (first order), the two within 4 n u S of each
# other, and a maximum over columns moves by no more than the largest of
# its dots' moves. This bounds screen_t_bf16 (``screen_t_tol``); the ADC
# screens round their row maxima to bf16 after the maximum, which
# ``screen_slack`` bounds; the ADC row max widens it to a margin
# (``rowmax_margin``) within which it recomputes candidates exactly; the
# normalized minutiae screen carries it through its f32 steps
# (``minu_norm_interval``).
TC_SUM_ULPS = 4.0 * 2.0 ** -24
# what the row max's launches ran on (``adc_rowmax_body``)
ROWMAX_BODIES = ("tensor cores", "f32 body", "CUDA-core tiles")
# what the transposed int8 screen's launches ran on
# (``afis_screen_t_int8_plan``: D <= 96 on the tensor cores)
SCREEN_T_INT8_PLANS = ("tensor cores", "dp4a")
KERNELS = ("adc_rowmax", "texture_match", "minutiae_match", "minu_screen",
           "adc_screen", "adc_screen_codes", "adc_rowmax_codes",
           "minu_screen_norm", "graph_filter_packed", "graph_filter",
           "graph_filter_infuse", "screen_t_bf16", "screen_t_int8",
           "h1_probe", "legality_canary")
# operand type -> the type code of the CUDA launchers (csrc/dtypes.cuh)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
FLOATS = (torch.float32, torch.bfloat16)


def launch_counts() -> dict:
    return {k: globals()[k].launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        globals()[k].launches = 0
    for k in ("adc_rowmax", "adc_rowmax_codes"):
        globals()[k].bodies = dict.fromkeys(ROWMAX_BODIES, 0)
    screen_t_int8.plans = dict.fromkeys(SCREEN_T_INT8_PLANS, 0)


def _check(name: str, t: torch.Tensor, shape: tuple, dtype, device):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if device.type == "cuda" and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_pair(lname: str, lat: torch.Tensor, gname: str,
                gal: torch.Tensor) -> None:
    """The operand types the JAX engine produces: the latent side f32 or
    bf16, the gallery side the latent's type or int8."""
    if lat.dtype not in FLOATS:
        raise TypeError(f"{lname}: dtype {lat.dtype}, expected float32 or "
                        f"bfloat16")
    if gal.dtype not in (lat.dtype, torch.int8):
        raise TypeError(f"{gname}: dtype {gal.dtype}, expected {lat.dtype} "
                        f"or int8 beside {lname} in {lat.dtype}")


def true_div(a: torch.Tensor, b) -> torch.Tensor:
    """a / b with one correctly rounded division per element. A Python
    scalar divisor would let PyTorch's CUDA kernel multiply by its
    reciprocal instead, one rounding away from the JAX code's division."""
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return a / b


def _is_cuda(device: torch.device) -> bool:
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return True


def _stream(device) -> int:
    """The raw handle of the current stream of ``device`` (a tensor's, so
    it has an index). Building a ``torch.cuda.Stream`` object for it costs
    the host more than the launch canary's kernel runs."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _check_codes(codes: torch.Tensor, codebook: torch.Tensor, B: int,
                 Rt: int, D: int, x_dtype, device) -> Tuple[int, int, int]:
    """Shapes of a codes operand [B, Rt, S] u8 and its codebook [S, C, d]
    (in x's type) with S * d == D; returns (S, C, d)."""
    S, C, sd = codebook.shape
    if S * sd != D:
        raise ValueError(f"codebook {tuple(codebook.shape)} decodes to "
                         f"{S * sd} features, expected {D}")
    _check("codes", codes, (B, Rt, S), torch.uint8, device)
    _check("codebook", codebook, (S, C, sd), x_dtype, device)
    return S, C, sd


# ---------------------------------------------------------------------------
# adc_rowmax
# ---------------------------------------------------------------------------

def adc_simi_plain(x, lsq, dec, rsq, rvalid) -> torch.Tensor:
    """simi [NL, B, Lt, Rt] = 2 x.dec + ((6 - |x|^2) - |c|^2), invalid
    rolled columns pushed down by (v - 1) * 1e30; x and dec widened to
    f32, each dot in index order."""
    simi = 2.0 * seq_dots(x, dec) + ((6.0 - lsq)[:, None, :, None] - rsq[None, :, None, :])
    return simi + (rvalid[None, :, None, :] - 1.0) * -NEG_BIG


def adc_rowmax_plain(x, lsq, dec, rsq, rvalid) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """Row max / first argmax of ``adc_simi_plain``."""
    simi = adc_simi_plain(x, lsq, dec, rsq, rvalid)
    best = simi.max(dim=-1).values
    iota = torch.arange(simi.shape[-1], device=x.device, dtype=torch.int32)
    bestj = torch.where(simi == best[..., None], iota,
                        simi.shape[-1]).min(dim=-1).values
    return best, bestj.to(torch.int32)


def rowmax_operand_norms(x: torch.Tensor, dec: Optional[torch.Tensor] = None,
                         codebook: Optional[torch.Tensor] = None,
                         B: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The operands' sizes that bound the row max's tensor-core sums: xl1
    [NL, Lt] = |x_i|_1 in f32, and cmax [B] f32 >= every |c| the kernel
    multiplies for an entry: the largest |dec| of the entry (bf16 or f32),
    128 for an int8 gallery (its type's bound), the largest |codebook|
    for a codes gallery (its decoded values are codebook entries). Taken
    from the operands, not from lsq / rsq, which may carry another
    scale (rsq of an int8 gallery is the dequantized norm)."""
    f32 = torch.float32
    xl1 = torch.linalg.vector_norm(x, ord=1, dim=-1, dtype=f32)
    if codebook is not None:
        cmax = torch.linalg.vector_norm(codebook, ord=float("inf"),
                                        dtype=f32).expand(B).contiguous()
    elif dec.dtype == torch.int8:
        cmax = torch.full((dec.shape[0],), 128.0, dtype=f32,
                          device=dec.device)
    else:
        cmax = torch.linalg.vector_norm(dec, ord=float("inf"), dim=(1, 2),
                                        dtype=f32)
    return xl1.contiguous(), cmax


def rowmax_margin(xl1: torch.Tensor, cmax: torch.Tensor,
                  D: int) -> torch.Tensor:
    """e [NL, B, Lt] = (2^-21 (D + 32) xl1) cmax: how far one column's
    value 2 dot + ((6 - lsq) - rsq) on the tensor cores may lie from the
    plain version's, before the epilogue's roundings.

    Both dots multiply the same exact products (bf16 x bf16, or int8
    widened to bf16) and differ only in their sums: in index order within
    (D - 1) u S of the exact dot (u = 2^-24, S = sum |x_d c_d| <= xl1
    cmax); on the tensor cores each product's alignment to the largest term
    loses under 2u S and each internal step (of at least four products)
    under 4u S, so within 3 D u S; together TC_SUM_ULPS D S = 4 D u S, and
    2 dot doubles it. The 32 covers the second-order terms, the f32
    rounding of xl1 and the k-steps' fixed cost at small D. The card's
    kernel computes the same product in the same order
    (``csrc/screen_body.cuh``)."""
    k = torch.tensor(2.0 * TC_SUM_ULPS * (D + 32), dtype=torch.float32,
                     device=xl1.device)
    return (k * xl1)[:, None, :] * cmax[None, :, None]


def rowmax_threshold(t1: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """thr = t1 - 2 ((e + 2^-21 |t1|) + 2^-118), in f32 as the card's
    kernel computes it: with t1 a row's largest value on the tensor cores
    and e its ``rowmax_margin``, the column of the row's exact maximum has
    a tensor-core value >= thr. Its exact value and the tensor cores'
    maximum's each lie within e plus the epilogue's roundings (an ulp of
    values near |t1|, under 2^-23 |t1|, or 2^-149 below 2^-126) of their
    tensor-core values; the 2^-21 |t1| also covers this expression's own
    roundings, and 2^-118 subnormal products the tensor cores may flush
    (at most 96 of them, each under 2^-126)."""
    m = (e + t1.abs() * 2.0 ** -21) + 2.0 ** -118
    return t1 - (m + m)


@functools.lru_cache(maxsize=256)
def _rowmax_body(name: str, device: int, *shape) -> str:
    """The body a row max launch of these sizes and types takes on the
    card ``device`` (``afis_adc_rowmax_body``; fixed per shape)."""
    with torch.cuda.device(device):
        k = _build.load().afis_adc_rowmax_body(*shape)
    if k < 0:
        _build.check(-k, name)
    return ROWMAX_BODIES[k]


def rowmax_counts(reset: bool = False) -> dict:
    """The card's counts over the row max's tensor-core launches since the
    last reset: rows whose maximum was decided between two candidate
    columns, rows sent to the exact pass over all columns (three or more
    candidates), rows of entries with no valid column."""
    torch.cuda.synchronize()
    out = (ctypes.c_longlong * 3)()
    _build.check(_build.load().afis_adc_rowmax_counts(out, int(reset)),
                 "adc_rowmax_counts")
    return dict(two_candidates=out[0], exact_pass=out[1], no_valid=out[2])


def adc_rowmax(x: torch.Tensor, lsq: torch.Tensor, dec: torch.Tensor,
               rsq: torch.Tensor, rvalid: torch.Tensor):
    """ADC texture similarity row maxima without materializing it.

    x [NL, Lt, D] latent texture descriptors (f32 or bf16), lsq [NL, Lt]
    their squared norms (f32); dec [B, Rt, D] decoded gallery descriptors
    (x's type or int8), rsq [B, Rt], rvalid [B, Rt] f32 0/1. Returns best
    [NL, B, Lt] f32 and bestj i32 (first index on ties); rows with no valid
    rolled column come back <= -1e30.

    On the card best and bestj are the plain version's bits in every mode:
    f32 latents on the CUDA cores, bf16 latents (D <= 96) on the tensor
    cores with an exact refine, bf16 with D > 96 on CUDA-core tiles
    (``adc_rowmax.bodies`` counts the launches of each).
    """
    NL, Lt, D = x.shape
    B, Rt, _ = dec.shape
    dev = x.device
    f32 = torch.float32
    _check_pair("x", x, "dec", dec)
    _check("x", x, (NL, Lt, D), x.dtype, dev)
    _check("lsq", lsq, (NL, Lt), f32, dev)
    _check("dec", dec, (B, Rt, D), dec.dtype, dev)
    _check("rsq", rsq, (B, Rt), f32, dev)
    _check("rvalid", rvalid, (B, Rt), f32, dev)
    if not _is_cuda(dev):
        return adc_rowmax_plain(x, lsq, dec, rsq, rvalid)
    best = torch.empty((NL, B, Lt), dtype=f32, device=dev)
    bestj = torch.empty((NL, B, Lt), dtype=torch.int32, device=dev)
    lib = _build.load()
    xtype, dtype = DTYPE_CODE[x.dtype], DTYPE_CODE[dec.dtype]
    body = _rowmax_body("adc_rowmax", dev.index, NL, Lt, B, Rt, D, xtype,
                        dtype, 0, 0)
    norms = rowmax_operand_norms(x, dec) if body == ROWMAX_BODIES[0] \
        else (None, None)
    err = lib.afis_adc_rowmax(
        *(0 if t is None else t.data_ptr()
          for t in (x, lsq, dec, rsq, rvalid, best, bestj) + norms),
        NL, Lt, B, Rt, D, xtype, dtype, _stream(dev))
    _build.check(err, "adc_rowmax")
    adc_rowmax.launches += 1
    adc_rowmax.bodies[body] += 1
    return best, bestj


adc_rowmax.launches = 0
adc_rowmax.bodies = dict.fromkeys(ROWMAX_BODIES, 0)


def adc_rowmax_codes_plain(x, lsq, codes, codebook, rsq, rvalid):
    return adc_rowmax_plain(x, lsq, decode_pq(codes, codebook), rsq, rvalid)


def adc_rowmax_codes(x: torch.Tensor, lsq: torch.Tensor, codes: torch.Tensor,
                     codebook: torch.Tensor, rsq: torch.Tensor,
                     rvalid: torch.Tensor):
    """``adc_rowmax`` over uint8 PQ codes [B, Rt, S] and the codebook
    [S, C, d] in x's type (S * d = D): the same best / bestj, bit for bit,
    as ``adc_rowmax`` on ``decode_pq(codes, codebook)``."""
    NL, Lt, D = x.shape
    B, Rt = rsq.shape
    dev = x.device
    f32 = torch.float32
    _check_pair("x", x, "x", x)
    _check("x", x, (NL, Lt, D), x.dtype, dev)
    _check("lsq", lsq, (NL, Lt), f32, dev)
    S, C, sd = _check_codes(codes, codebook, B, Rt, D, x.dtype, dev)
    _check("rsq", rsq, (B, Rt), f32, dev)
    _check("rvalid", rvalid, (B, Rt), f32, dev)
    if not _is_cuda(dev):
        return adc_rowmax_codes_plain(x, lsq, codes, codebook, rsq, rvalid)
    best = torch.empty((NL, B, Lt), dtype=f32, device=dev)
    bestj = torch.empty((NL, B, Lt), dtype=torch.int32, device=dev)
    lib = _build.load()
    xtype = DTYPE_CODE[x.dtype]
    body = _rowmax_body("adc_rowmax_codes", dev.index, NL, Lt, B, Rt, D,
                        xtype, xtype, S, C)
    norms = rowmax_operand_norms(x, codebook=codebook, B=B) \
        if body == ROWMAX_BODIES[0] else (None, None)
    err = lib.afis_adc_rowmax_codes(
        *(0 if t is None else t.data_ptr()
          for t in (x, lsq, codes, codebook, rsq, rvalid, best, bestj)
          + norms),
        NL, Lt, B, Rt, S, C, sd, xtype, _stream(dev))
    _build.check(err, "adc_rowmax_codes")
    adc_rowmax_codes.launches += 1
    adc_rowmax_codes.bodies[body] += 1
    return best, bestj


adc_rowmax_codes.launches = 0
adc_rowmax_codes.bodies = dict.fromkeys(ROWMAX_BODIES, 0)


# ---------------------------------------------------------------------------
# screens
# ---------------------------------------------------------------------------

def screen_aug(rsq: torch.Tensor, rvalid: torch.Tensor, x_dtype,
               dec_dtype, block: int = 0) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """The two terms [B, Rt] f32 that the TPU screen adds to every dot
    through its augmented contraction rows (``fused_adc_screen``), each the
    product of an aug row of the gallery side and a column of x:

    - f32 / bf16 gallery: a1 = -(rsq / 2) and a2 = 0 (valid) / -1e4
      (invalid), both rounded to the gallery's type (x's columns are 1);
    - int8 gallery (tex_int8): c1 = max(rsq / 2) / 126 + 1e-9 over each
      group of ``block`` entries in the order given (one call of the JAX
      screen per engine block), a1 = c1 rounded to x's type times
      clip(round(-(rsq / 2) / c1), -127, 127), a2 = 0 / -127.
    """
    rsqm = rsq * 0.5
    if dec_dtype != torch.int8:
        a1 = (-rsqm).to(dec_dtype).float()
        a2 = torch.where(rvalid > 0, torch.zeros_like(rvalid),
                         torch.full_like(rvalid, SCREEN_SENT))
        a2 = a2.to(dec_dtype).float()
        return a1, a2
    B, Rt = rsq.shape
    if block <= 0 or B % block:
        raise ValueError(f"an int8 screen needs block > 0 dividing B={B} "
                         f"(the JAX engine's block_size), got {block}")
    c1 = true_div(rsqm.reshape(B // block, block * Rt).max(dim=1).values,
                  126.0) + 1e-9
    c1 = c1.repeat_interleave(block)[:, None]                    # [B, 1]
    q1 = torch.clamp(torch.round(true_div(-rsqm, c1.expand(B, Rt))),
                     -127.0, 127.0)
    a1 = c1.to(x_dtype).float() * q1
    a2 = torch.where(rvalid > 0, torch.zeros_like(rvalid),
                     torch.full_like(rvalid, -127.0))
    return a1.contiguous(), a2


def screen_rowmax_plain(x, dec, rsq, rvalid, block=0) -> torch.Tensor:
    """The screen's row maxima [NL, B, Lt] before rounding:
    max_j ((x_i . dec_j + a1_j) + a2_j), a1 and a2 the terms of
    ``screen_aug``."""
    a1, a2 = screen_aug(rsq, rvalid, x.dtype, dec.dtype, block)
    v = (seq_dots(x, dec) + a1[None, :, None, :]) + a2[None, :, None, :]
    return v.max(dim=-1).values


def screen_slack(x, lvalid, raw) -> torch.Tensor:
    """atol [NL, B] of a screen against its plain version: ``KERNEL_TOL``'s
    atol, plus, when x is bf16, one bf16 ulp of each row maximum ``raw``
    (``screen_rowmax_plain``), doubled as the screen doubles it, summed over
    the valid latent rows. A sum taken in another order (the tensor cores'
    order) moves a row maximum by a few f32 ulps, which can round it to the
    neighbouring bf16 value; the relu, the validity and the row sum in
    index order pass that step on, up to f32 roundings that
    ``KERNEL_TOL`` covers. Held with ``KERNEL_TOL``'s rtol."""
    atol = torch.full(raw.shape[:2], KERNEL_TOL["atol"], dtype=torch.float32,
                      device=raw.device)
    if x.dtype != torch.bfloat16:
        return atol
    ulp = torch.exp2(torch.floor(torch.log2(raw.abs().clamp(min=1e-30)))
                     - 7.0)
    return atol + (2.0 * ulp * lvalid[:, None, :]).sum(dim=2)


def adc_screen_plain(x, lsq, lvalid, dec, rsq, rvalid, tau=0.0, block=0):
    """sum_i max(2 raw_i + ((6 - lsq_i) - tau), 0) * lvalid_i, the sum in
    row order, with raw_i = max_j ((x_i . dec_j + a1_j) + a2_j) rounded to
    x's type (the TPU screen's output type) and a1, a2 the terms of
    ``screen_aug``; in f32: a1 = -(rsq / 2), a2 = 0 for a valid rolled
    column and -1e4 for an invalid one."""
    raw = screen_rowmax_plain(x, dec, rsq, rvalid, block) \
        .to(x.dtype).float()                              # [NL, B, Lt]
    t6 = (6.0 - lsq) - tau
    term = torch.clamp(2.0 * raw + t6[:, None, :], min=0.0) \
        * lvalid[:, None, :]
    return seq_sum(term, dim=2)


def _adc_screen_args(x, lsq, lvalid, rsq, rvalid):
    NL, Lt, D = x.shape
    B, Rt = rsq.shape
    dev = x.device
    f32 = torch.float32
    _check_pair("x", x, "x", x)
    _check("x", x, (NL, Lt, D), x.dtype, dev)
    _check("lsq", lsq, (NL, Lt), f32, dev)
    _check("lvalid", lvalid, (NL, Lt), f32, dev)
    _check("rsq", rsq, (B, Rt), f32, dev)
    _check("rvalid", rvalid, (B, Rt), f32, dev)
    return NL, Lt, D, B, Rt, dev


def adc_screen(x: torch.Tensor, lsq: torch.Tensor, lvalid: torch.Tensor,
               dec: torch.Tensor, rsq: torch.Tensor, rvalid: torch.Tensor,
               tau: float = 0.0, block: int = 0) -> torch.Tensor:
    """Texture screening score [NL, B] (an upper bound on the exact texture
    score at tau = 0, up to the rounding of the bf16 and int8 modes).

    x [NL, Lt, D] (f32 or bf16), lsq / lvalid [NL, Lt] f32; dec [B, Rt, D]
    predecoded gallery descriptors (x's type or int8), rsq / rvalid [B, Rt]
    f32. An int8 gallery takes ``block``, the JAX engine's block size: one
    scale of the -rsq / 2 row per group of that many entries.

    On the card f32 latents run on the CUDA cores, bit for bit the plain
    version; bf16 latents with D <= 96 on the tensor cores, within
    ``screen_slack`` of it (bf16 with D > 96 on the CUDA cores, bit for
    bit).
    """
    NL, Lt, D, B, Rt, dev = _adc_screen_args(x, lsq, lvalid, rsq, rvalid)
    _check_pair("x", x, "dec", dec)
    _check("dec", dec, (B, Rt, D), dec.dtype, dev)
    if not _is_cuda(dev):
        return adc_screen_plain(x, lsq, lvalid, dec, rsq, rvalid, tau, block)
    a1, a2 = screen_aug(rsq, rvalid, x.dtype, dec.dtype, block)
    out = torch.empty((NL, B), dtype=torch.float32, device=dev)
    lib = _build.load()
    err = lib.afis_adc_screen(
        *(t.data_ptr() for t in (x, lsq, lvalid, dec, a1, a2, out)),
        NL, Lt, B, Rt, D, float(tau), DTYPE_CODE[x.dtype],
        DTYPE_CODE[dec.dtype], _stream(dev))
    _build.check(err, "adc_screen")
    adc_screen.launches += 1
    return out


adc_screen.launches = 0


def adc_screen_codes_plain(x, lsq, lvalid, codes, codebook, rsq, rvalid,
                           tau=0.0):
    return adc_screen_plain(x, lsq, lvalid, decode_pq(codes, codebook), rsq,
                            rvalid, tau)


def adc_screen_codes(x: torch.Tensor, lsq: torch.Tensor, lvalid: torch.Tensor,
                     codes: torch.Tensor, codebook: torch.Tensor,
                     rsq: torch.Tensor, rvalid: torch.Tensor,
                     tau: float = 0.0) -> torch.Tensor:
    """``adc_screen`` over uint8 PQ codes [B, Rt, S] and the codebook
    [S, C, d] in x's type: in f32 bit for bit ``adc_screen`` on the decoded
    gallery; with a bf16 codebook (S * d <= 96) the card's tensor cores sum
    the dots in another order, within ``screen_slack`` of it."""
    NL, Lt, D, B, Rt, dev = _adc_screen_args(x, lsq, lvalid, rsq, rvalid)
    S, C, sd = _check_codes(codes, codebook, B, Rt, D, x.dtype, dev)
    if not _is_cuda(dev):
        return adc_screen_codes_plain(x, lsq, lvalid, codes, codebook, rsq,
                                      rvalid, tau)
    a1, a2 = screen_aug(rsq, rvalid, x.dtype, codebook.dtype)
    out = torch.empty((NL, B), dtype=torch.float32, device=dev)
    lib = _build.load()
    err = lib.afis_adc_screen_codes(
        *(t.data_ptr() for t in (x, lsq, lvalid, codes, codebook, a1, a2,
                                 out)),
        NL, Lt, B, Rt, S, C, sd, float(tau), DTYPE_CODE[x.dtype],
        _stream(dev))
    _build.check(err, "adc_screen_codes")
    adc_screen_codes.launches += 1
    return out


adc_screen_codes.launches = 0


def minu_screen_plain(ldes, lvalid, rdes, rvalid):
    """min(sum_p relu(max_r s), sum_r relu(max_p s)) of s = the product of
    the validity-zeroed descriptors (widened to f32), sums in index
    order."""
    s = seq_dots(ldes.float() * lvalid[..., None],
                 rdes.float() * rvalid[..., None])
    rb = seq_sum(torch.clamp(s.max(dim=-1).values, min=0.0), dim=-1)
    cb = seq_sum(torch.clamp(s.max(dim=-2).values, min=0.0), dim=-1)
    return torch.minimum(rb, cb)


def _minu_screen_args(ldes, lvalid, rdes, rvalid):
    NT, P, D = ldes.shape
    B, R, _ = rdes.shape
    dev = ldes.device
    f32 = torch.float32
    _check_pair("ldes", ldes, "rdes", rdes)
    _check("ldes", ldes, (NT, P, D), ldes.dtype, dev)
    _check("lvalid", lvalid, (NT, P), f32, dev)
    _check("rdes", rdes, (B, R, D), rdes.dtype, dev)
    _check("rvalid", rvalid, (B, R), f32, dev)
    return NT, P, D, B, R, dev


def minu_screen(ldes: torch.Tensor, lvalid: torch.Tensor, rdes: torch.Tensor,
                rvalid: torch.Tensor, normalize: bool = False) -> torch.Tensor:
    """Minutiae screening score [NT, B]: an upper bound on the exact
    minutiae-template score, or with ``normalize`` the mutually normalized
    heuristic of ``minu_screen_norm``.

    ldes [NT, P, D] (f32 or bf16), lvalid [NT, P] f32; rdes [B, R, D]
    (ldes's type or int8), rvalid [B, R] f32. With bf16 ldes (D <= 96) the
    card's kernel runs on the tensor cores, the descriptors times their
    validity (0 or 1) rounded to bf16, and sums each dot in another order
    than the plain version.
    """
    if normalize:
        return minu_screen_norm(ldes, lvalid, rdes, rvalid)
    NT, P, D, B, R, dev = _minu_screen_args(ldes, lvalid, rdes, rvalid)
    if not _is_cuda(dev):
        return minu_screen_plain(ldes, lvalid, rdes, rvalid)
    out = torch.empty((NT, B), dtype=torch.float32, device=dev)
    lib = _build.load()
    err = lib.afis_minu_screen(
        *(t.data_ptr() for t in (ldes, lvalid, rdes, rvalid, out)),
        NT, P, B, R, D, DTYPE_CODE[ldes.dtype], DTYPE_CODE[rdes.dtype],
        _stream(dev))
    _build.check(err, "minu_screen")
    minu_screen.launches += 1
    return out


minu_screen.launches = 0


def minu_screen_norm_plain(ldes, lvalid, rdes, rvalid):
    """min(sum_p max_r n, sum_r max_p n) of the mutually normalized
    n = ((s / (((row + col) - s) + 1e-6)) * lv) * rv, s = (relu(ldes .
    rdes) * lv) * rv, row / col its sums; every sum in index order. The
    descriptors are not zeroed before the product."""
    lv = lvalid[:, None, :, None]
    rv = rvalid[None, :, None, :]
    s = (torch.clamp(seq_dots(ldes, rdes), min=0.0) * lv) * rv
    row = seq_sum(s, dim=-1)[..., :, None]
    col = seq_sum(s, dim=-2)[..., None, :]
    n = ((s / (((row + col) - s) + 1e-6)) * lv) * rv
    return torch.minimum(seq_sum(n.max(dim=-1).values, dim=-1),
                         seq_sum(n.max(dim=-2).values, dim=-1))


def minu_screen_norm(ldes: torch.Tensor, lvalid: torch.Tensor,
                     rdes: torch.Tensor, rvalid: torch.Tensor) -> torch.Tensor:
    """Mutually normalized minutiae screen [NT, B] (``fused_minu_screen``
    with normalize=True): the quantity the top-120 selection ranks by, a
    correlation heuristic and not a bound on the exact score. Shapes as
    ``minu_screen``. With bf16 ldes (D <= 96, R <= 128) the card's kernel
    runs the dots on the tensor cores and the rest in the plain version's
    order, within ``minu_norm_interval``; else it gives the plain bits."""
    NT, P, D, B, R, dev = _minu_screen_args(ldes, lvalid, rdes, rvalid)
    if not _is_cuda(dev):
        return minu_screen_norm_plain(ldes, lvalid, rdes, rvalid)
    out = torch.empty((NT, B), dtype=torch.float32, device=dev)
    lib = _build.load()
    err = lib.afis_minu_screen_norm(
        *(t.data_ptr() for t in (ldes, lvalid, rdes, rvalid, out)),
        NT, P, B, R, D, DTYPE_CODE[ldes.dtype], DTYPE_CODE[rdes.dtype],
        _stream(dev))
    _build.check(err, "minu_screen_norm")
    minu_screen_norm.launches += 1
    return out


minu_screen_norm.launches = 0


# ---------------------------------------------------------------------------
# standalone graph filter
# ---------------------------------------------------------------------------

def graph_filter_packed_plain(val, gl, gr, li, ri, valid, lookup=False,
                              dist_iters=5, stages=6, stage2_cap=0,
                              stats: Optional[dict] = None):
    """``filter_correspondences`` with no tie keys (slot order breaks
    support ties)."""
    return filter_correspondences(val, li, ri, gl, gr, valid, lookup,
                                  dist_iters, (), stats, stages, stage2_cap)


def _filter_set_args(val, li, ri, valid, N, K, dev):
    _check("val", val, (N, K), torch.float32, dev)
    _check("li", li, (N, K), torch.int32, dev)
    _check("ri", ri, (N, K), torch.int32, dev)
    _check("valid", valid, (N, K), torch.bool, dev)


def _launch_graph_filter(val, gl, gr, li, ri, valid, lookup, dist_iters,
                         stages, stage2_cap, what) -> torch.Tensor:
    N, K = val.shape
    if K > MAX_K:
        raise ValueError(f"{what}: K={K} > {MAX_K}")
    out = torch.empty((N,), dtype=torch.float32, device=val.device)
    lib = _build.load()
    err = lib.afis_graph_filter_packed(
        *(t.data_ptr() for t in (val, gl, gr, li, ri, valid, out)),
        N, K, int(lookup), dist_iters, stages, stage2_cap,
        _stream(val.device))
    _build.check(err, what)
    return out


def graph_filter_packed(val: torch.Tensor, gl: torch.Tensor,
                        gr: torch.Tensor, li: torch.Tensor, ri: torch.Tensor,
                        valid: torch.Tensor, lookup: bool, dist_iters: int,
                        stages: int = 6, stage2_cap: int = 0) -> torch.Tensor:
    """Both graph-filter stages over N pre-gathered correspondence sets ->
    scores [N] (``fused_graph_filter_packed``).

    val [N, K] f32; gl / gr [N, K, 4] f32 = (x, y, cos ori, sin ori) at the
    slots; li / ri [N, K] int32; valid [N, K] bool. ``stages`` and
    ``stage2_cap`` are the bench hooks of ``filter_correspondences``.
    """
    N, K = val.shape
    dev = val.device
    _filter_set_args(val, li, ri, valid, N, K, dev)
    _check("gl", gl, (N, K, 4), torch.float32, dev)
    _check("gr", gr, (N, K, 4), torch.float32, dev)
    if stage2_cap < 0:
        raise ValueError("stage2_cap must be >= 0")
    if not _is_cuda(dev):
        return graph_filter_packed_plain(val, gl, gr, li, ri, valid, lookup,
                                         dist_iters, stages, stage2_cap)
    out = _launch_graph_filter(val, gl, gr, li, ri, valid, lookup,
                               dist_iters, stages, stage2_cap,
                               "graph_filter_packed")
    graph_filter_packed.launches += 1
    return out


graph_filter_packed.launches = 0


def graph_filter_plain(val, lxy, lori, rxy, rori, li, ri, valid,
                       lookup=False, dist_iters=5,
                       stats: Optional[dict] = None):
    gl, gr = coord_pack(lxy, lori), coord_pack(rxy, rori)
    return graph_filter_packed_plain(val, gl, gr, li, ri, valid, lookup,
                                     dist_iters, stats=stats)


def graph_filter(val: torch.Tensor, lxy: torch.Tensor, lori: torch.Tensor,
                 rxy: torch.Tensor, rori: torch.Tensor, li: torch.Tensor,
                 ri: torch.Tensor, valid: torch.Tensor, lookup: bool,
                 dist_iters: int) -> torch.Tensor:
    """``graph_filter_packed`` from coordinates lxy / rxy [N, K, 2] and
    orientations lori / rori [N, K] f32 (``fused_graph_filter``): the
    cos / sin packs are built with torch ops, as the JAX function builds
    them outside its kernel, and the same CUDA kernel runs."""
    N, K = val.shape
    dev = val.device
    _filter_set_args(val, li, ri, valid, N, K, dev)
    for name, t, shape in (("lxy", lxy, (N, K, 2)), ("lori", lori, (N, K)),
                           ("rxy", rxy, (N, K, 2)), ("rori", rori, (N, K))):
        _check(name, t, shape, torch.float32, dev)
    if not _is_cuda(dev):
        return graph_filter_plain(val, lxy, lori, rxy, rori, li, ri, valid,
                                  lookup, dist_iters)
    gl, gr = coord_pack(lxy, lori), coord_pack(rxy, rori)
    out = _launch_graph_filter(val, gl, gr, li, ri, valid, lookup,
                               dist_iters, 6, 0, "graph_filter")
    graph_filter.launches += 1
    return out


graph_filter.launches = 0


def infuse_gather(li, ri, lpackT, rpackT, simi=None):
    """The slot operands of ``graph_filter_infuse``: packs gl / gr
    [NT, B, K, 4] gathered from the [NT, 4, P] / [B, 4, R] planes and, with
    ``simi`` [NT, B, P, R], the weights simi[t, b, li, ri]. An index outside
    [0, P) or [0, R) gathers zeros, as the TPU kernel's one-hot rows do."""
    NT, B, K = li.shape
    P, R = lpackT.shape[2], rpackT.shape[2]
    dev = li.device
    lin = (li >= 0) & (li < P)
    rin = (ri >= 0) & (ri < R)
    lic = torch.where(lin, li, 0).long()
    ric = torch.where(rin, ri, 0).long()
    t_of = torch.arange(NT, device=dev)[:, None, None]
    b_of = torch.arange(B, device=dev)[None, :, None]
    gl = lpackT.transpose(1, 2)[t_of, lic]
    gr = rpackT.transpose(1, 2)[b_of, ric]
    gl = torch.where(lin[..., None], gl, torch.zeros_like(gl))
    gr = torch.where(rin[..., None], gr, torch.zeros_like(gr))
    val = None
    if simi is not None:
        val = simi[t_of, b_of, lic, ric]
        val = torch.where(lin & rin, val, torch.zeros_like(val))
    return gl, gr, val


def graph_filter_infuse_plain(val, li, ri, valid, lpackT, rpackT,
                              lookup=False, dist_iters=5, simi=None,
                              stats: Optional[dict] = None):
    NT, B, K = li.shape
    gl, gr, sval = infuse_gather(li, ri, lpackT, rpackT, simi)
    if simi is not None:
        val = sval
    return graph_filter_packed_plain(
        val.reshape(NT * B, K), gl.reshape(NT * B, K, 4),
        gr.reshape(NT * B, K, 4), li.reshape(NT * B, K),
        ri.reshape(NT * B, K), valid.reshape(NT * B, K), lookup,
        dist_iters, stats=stats).reshape(NT, B)


def graph_filter_infuse(val: Optional[torch.Tensor], li: torch.Tensor,
                        ri: torch.Tensor, valid: torch.Tensor,
                        lpackT: torch.Tensor, rpackT: torch.Tensor,
                        lookup: bool, dist_iters: int,
                        simi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Graph filter over an [NT, B] grid of correspondence sets with the
    operand gathers inside the kernel (``fused_graph_filter_infuse``).

    val [NT, B, K] f32, or None with ``simi`` [NT, B, P, R] f32 given (the
    weights are then simi[t, b, li, ri]); li / ri [NT, B, K] int32; valid
    [NT, B, K] bool; lpackT [NT, 4, P] / rpackT [B, 4, R] coordinate planes
    (x, y, cos ori, sin ori). Returns [NT, B] f32.
    """
    NT, B, K = li.shape
    P, R = lpackT.shape[2], rpackT.shape[2]
    dev = li.device
    f32 = torch.float32
    if (val is None) == (simi is None):
        raise ValueError("graph_filter_infuse takes exactly one of val and "
                         "simi")
    if val is not None:
        _check("val", val, (NT, B, K), f32, dev)
    else:
        _check("simi", simi, (NT, B, P, R), f32, dev)
    _check("li", li, (NT, B, K), torch.int32, dev)
    _check("ri", ri, (NT, B, K), torch.int32, dev)
    _check("valid", valid, (NT, B, K), torch.bool, dev)
    _check("lpackT", lpackT, (NT, 4, P), f32, dev)
    _check("rpackT", rpackT, (B, 4, R), f32, dev)
    if not _is_cuda(dev):
        return graph_filter_infuse_plain(val, li, ri, valid, lpackT, rpackT,
                                         lookup, dist_iters, simi)
    if K > MAX_K:
        raise ValueError(f"graph_filter_infuse: K={K} > {MAX_K}")
    out = torch.empty((NT, B), dtype=f32, device=dev)
    lib = _build.load()
    err = lib.afis_graph_filter_infuse(
        None if val is None else val.data_ptr(),
        *(t.data_ptr() for t in (li, ri, valid, lpackT, rpackT)),
        None if simi is None else simi.data_ptr(), out.data_ptr(),
        NT, B, K, P, R, int(lookup), dist_iters, _stream(dev))
    _build.check(err, "graph_filter_infuse")
    graph_filter_infuse.launches += 1
    return out


graph_filter_infuse.launches = 0


# ---------------------------------------------------------------------------
# threshold selection shared by the two filter kernels
# ---------------------------------------------------------------------------

def select_slots(cand: torch.Tensor, K: int, lo: torch.Tensor,
                 hi: torch.Tensor, band_key: Optional[torch.Tensor] = None):
    """Top-K of each row of ``cand`` [N, C] by threshold bisection.

    BISECT_ITERS steps of mid = 0.5 (lo + hi), keeping count(> lo) > K >=
    count(> hi). Values above hi take the first slots in index order, then
    the (lo, hi] band fills the remaining slots in ascending ``band_key``
    order (index order when None; keys must be distinct within a row).
    Returns (sel [N, C] bool, slot [N, C] int64, the output position).
    """
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        big = (cand > mid[:, None]).sum(dim=1) > K
        lo, hi = torch.where(big, mid, lo), torch.where(big, hi, mid)
    mask_hi = cand > hi[:, None]
    mask_tie = (cand > lo[:, None]) & ~mask_hi
    n_hi = mask_hi.sum(dim=1, keepdim=True)
    rank_hi = torch.cumsum(mask_hi, dim=1) - mask_hi.long()
    if band_key is None:
        rank_tie = torch.cumsum(mask_tie, dim=1) - mask_tie.long()
    else:
        big_key = band_key.max() + 1
        order = torch.argsort(torch.where(mask_tie, band_key, big_key), dim=1)
        rank_tie = torch.empty_like(order)
        rank_tie.scatter_(1, order, torch.arange(
            cand.shape[1], device=cand.device).expand_as(order).contiguous())
    sel_tie = mask_tie & (rank_tie < K - n_hi)
    slot = torch.where(mask_hi, rank_hi, n_hi + rank_tie)
    return mask_hi | sel_tie, slot


def _scatter_slots(sel: torch.Tensor, slot: torch.Tensor, K: int, *values):
    """Move the selected elements of each [N, C] value row to their slots
    [N, K]; empty slots hold 0. Also returns the slot validity mask."""
    N = sel.shape[0]
    n_idx = torch.arange(N, device=sel.device)[:, None].expand_as(sel)
    rows, cols = n_idx[sel], slot[sel]
    outs = []
    for v in values:
        o = torch.zeros((N, K), dtype=v.dtype, device=v.device)
        o[rows, cols] = v[sel]
        outs.append(o)
    vf = torch.zeros((N, K), dtype=torch.bool, device=sel.device)
    vf[rows, cols] = True
    return outs, vf


# ---------------------------------------------------------------------------
# texture_match
# ---------------------------------------------------------------------------

def texture_match_plain(best, bestj, lvalid, lpack, rpack, top_n=200,
                        lookup=True, dist_iters=3,
                        stats: Optional[dict] = None) -> torch.Tensor:
    """Top-K rows of the ADC maxima per (latent, entry) and the filter."""
    NL, B, Lt = best.shape
    K = min(top_n, Lt)
    N = NL * B
    bestm = torch.where(lvalid[:, None, :] > 0.5, best,
                        torch.full_like(best, TEX_SENT)).reshape(N, Lt)
    minv = torch.where(bestm > TEX_SENT + 1.0, bestm,
                       torch.full_like(bestm, 1e30)).min(dim=1).values
    lo = torch.clamp(minv - 1.0, min=TEX_SENT)
    hi = bestm.max(dim=1).values + 1.0
    sel, slot = select_slots(bestm, K, lo, hi)
    rows = torch.arange(Lt, device=best.device).expand(N, Lt)
    (val, li, ri), vf = _scatter_slots(sel, slot, K, bestm, rows,
                                       bestj.reshape(N, Lt).long())
    # spec candidate-list order (matcher.cpp:736-749): latent-row order
    # (the slot order) when <= K rows are valid, value-sorted when more
    usef = (lvalid.sum(dim=1) > float(K)).float()
    tie = val * usef.repeat_interleave(B)[:, None]
    n_of = torch.arange(NL, device=best.device).repeat_interleave(B)
    b_of = torch.arange(B, device=best.device).repeat(NL)
    lp = lpack[n_of[:, None], li]
    rp = rpack[b_of[:, None], ri]
    return filter_correspondences(val, li, ri, lp, rp, vf, lookup,
                                  dist_iters, (tie,), stats).reshape(NL, B)


def texture_match(best: torch.Tensor, bestj: torch.Tensor,
                  lvalid: torch.Tensor, lpack: torch.Tensor,
                  rpack: torch.Tensor, top_n: int = 200, lookup: bool = True,
                  dist_iters: int = 3) -> torch.Tensor:
    """Texture score [NL, B] from the ADC row maxima.

    best/bestj [NL, B, Lt] from ``adc_rowmax``; lvalid [NL, Lt] f32;
    lpack [NL, Lt, 4] / rpack [B, R, 4] = (x, y, cos ori, sin ori) with
    quantized (x-24)/16 coordinates when ``lookup``. K = min(top_n, Lt)
    slots by the 26-step bisect, then the graph filter with tie key
    value * [n_valid > K].
    """
    NL, B, Lt = best.shape
    R = rpack.shape[1]
    K = min(top_n, Lt)
    dev = best.device
    f32 = torch.float32
    _check("best", best, (NL, B, Lt), f32, dev)
    _check("bestj", bestj, (NL, B, Lt), torch.int32, dev)
    _check("lvalid", lvalid, (NL, Lt), f32, dev)
    _check("lpack", lpack, (NL, Lt, 4), f32, dev)
    _check("rpack", rpack, (B, R, 4), f32, dev)
    if not _is_cuda(dev):
        return texture_match_plain(best, bestj, lvalid, lpack, rpack, top_n,
                                   lookup, dist_iters)
    if K > MAX_K:
        raise ValueError(f"texture_match: K={K} > {MAX_K}")
    out = torch.empty((NL, B), dtype=f32, device=dev)
    lib = _build.load()
    err = lib.afis_texture_match(
        *(t.data_ptr() for t in (best, bestj, lvalid, lpack, rpack, out)),
        NL, B, Lt, R, K, int(lookup), dist_iters, _stream(dev))
    _build.check(err, "texture_match")
    texture_match.launches += 1
    return out


texture_match.launches = 0


# ---------------------------------------------------------------------------
# minutiae_match
# ---------------------------------------------------------------------------

def minutiae_match_plain(ldes, lvalid, rdes, rvalid, lpack, rpack,
                         top_n=120, row_cap=8, lookup=False, dist_iters=5,
                         stats: Optional[dict] = None) -> torch.Tensor:
    """Whole minutiae-template match [NT, B]: similarity, mutual
    normalization, row_cap candidates per latent row, bisect top-K over
    the [row_cap, P] table with the (lo, hi] band filled in flat-index
    order, then the filter with tie keys (normalized value, -flat index)."""
    NT, P, _ = ldes.shape
    B, R, _ = rdes.shape
    K = min(top_n, P * R)
    N = NT * B
    simi = minutiae_similarity(ldes, lvalid, rdes, rvalid)     # [NT,B,P,R]
    pair = (lvalid[:, None, :, None] > 0.5) & (rvalid[None, :, None, :] > 0.5)
    normm = torch.where(pair, mutual_normalize(simi),
                        torch.full_like(simi, MINU_SENT))
    cv, cr, cs = row_candidates(normm, simi, row_cap)           # [.., cap, P]
    C = row_cap * P
    cv, cr, cs = (a.reshape(N, C) for a in (cv, cr, cs))
    lo = torch.full((N,), -1.0, device=ldes.device)
    hi = torch.full((N,), 1.0000001, device=ldes.device)
    prow = torch.arange(P, device=ldes.device).repeat(row_cap).expand(N, C)
    # the band fills in the spec's candidate order, flat index p * R + r
    sel, slot = select_slots(cv, K, lo, hi, band_key=prow * R + cr)
    (val, normv, li, ri), vf = _scatter_slots(sel, slot, K, cs, cv, prow, cr)
    neg_flat = -(li.float() * float(R) + ri.float())
    t_of = torch.arange(NT, device=ldes.device).repeat_interleave(B)
    b_of = torch.arange(B, device=ldes.device).repeat(NT)
    lp = lpack[t_of[:, None], li]
    rp = rpack[b_of[:, None], ri]
    return filter_correspondences(val, li, ri, lp, rp, vf, lookup,
                                  dist_iters, (normv, neg_flat),
                                  stats).reshape(NT, B)


def minutiae_match(ldes: torch.Tensor, lvalid: torch.Tensor,
                   rdes: torch.Tensor, rvalid: torch.Tensor,
                   lpack: torch.Tensor, rpack: torch.Tensor,
                   top_n: int = 120, row_cap: int = 8, lookup: bool = False,
                   dist_iters: int = 5) -> torch.Tensor:
    """Minutiae-template scores [NT, B].

    ldes [NT, P, D] (f32 or bf16), lvalid [NT, P] f32; rdes [B, R, D]
    (ldes's type or int8), rvalid [B, R] f32; lpack [NT, P, 4] / rpack
    [B, R, 4] coordinate packs. ``row_cap`` candidates per latent row feed
    the top-K (K = min(top_n, P*R)).
    """
    NT, P, D = ldes.shape
    B, R, _ = rdes.shape
    K = min(top_n, P * R)
    dev = ldes.device
    f32 = torch.float32
    _check_pair("ldes", ldes, "rdes", rdes)
    _check("ldes", ldes, (NT, P, D), ldes.dtype, dev)
    _check("lvalid", lvalid, (NT, P), f32, dev)
    _check("rdes", rdes, (B, R, D), rdes.dtype, dev)
    _check("rvalid", rvalid, (B, R), f32, dev)
    _check("lpack", lpack, (NT, P, 4), f32, dev)
    _check("rpack", rpack, (B, R, 4), f32, dev)
    if row_cap < 1:
        raise ValueError("row_cap must be >= 1")
    if not _is_cuda(dev):
        return minutiae_match_plain(ldes, lvalid, rdes, rvalid, lpack, rpack,
                                    top_n, row_cap, lookup, dist_iters)
    if K > MAX_K:
        raise ValueError(f"minutiae_match: K={K} > {MAX_K}")
    lib = _build.load()
    # a pair too large for shared memory keeps its matrices in a global
    # workspace: one slice per block the card runs at once
    words = lib.afis_minutiae_match_workspace(P, R, D, K, row_cap)
    if words < 0:
        raise ValueError(f"minutiae_match: no launch takes P={P} R={R} D={D} "
                         f"K={K} row_cap={row_cap}")
    ws, nblk = None, 0
    if words:
        nblk = min(NT * B, lib.afis_minutiae_match_blocks(
            P, R, D, K, row_cap, DTYPE_CODE[ldes.dtype],
            DTYPE_CODE[rdes.dtype]))
        if nblk <= 0:
            raise RuntimeError("minutiae_match: no block fits on the card")
        ws = torch.empty((nblk * words,), dtype=f32, device=dev)
    out = torch.empty((NT, B), dtype=f32, device=dev)
    err = lib.afis_minutiae_match(
        *(t.data_ptr() for t in (ldes, lvalid, rdes, rvalid, lpack, rpack,
                                 out)),
        None if ws is None else ws.data_ptr(), nblk,
        NT, P, B, R, D, K, row_cap, int(lookup), dist_iters,
        DTYPE_CODE[ldes.dtype], DTYPE_CODE[rdes.dtype], _stream(dev))
    _build.check(err, "minutiae_match")
    minutiae_match.launches += 1
    return out


minutiae_match.launches = 0


# ---------------------------------------------------------------------------
# the experiment and probe scripts' kernels, and the launch canary
# ---------------------------------------------------------------------------

def screen_t_bf16_plain(xt, dect):
    """raw[b, m] = max_j sum_d dect[b, j, d] xt[d, m], f32 sums in index
    order."""
    return seq_dots(xt.t()[None], dect)[0].max(dim=-1).values


def screen_t_tol(xt, dect, step: int = 256) -> torch.Tensor:
    """atol [B, M] of ``screen_t_bf16`` against its plain version:
    ``KERNEL_TOL``'s atol plus ``TC_SUM_ULPS`` Da max_j sum_d
    |dect[b, j, d] xt[d, m]|, the bound on a dot summed in another order
    (``TC_SUM_ULPS`` says why), with the first 96 products summed on the
    tensor cores and the rest added in index order after them. Held with
    ``KERNEL_TOL``'s rtol. ``step`` entries at a time."""
    Da = xt.shape[0]
    ax = xt.float().abs()
    s = torch.cat([torch.matmul(dect[a:a + step].float().abs(), ax)
                   .amax(dim=1) for a in range(0, dect.shape[0], step)])
    return KERNEL_TOL["atol"] + TC_SUM_ULPS * Da * s


def _f32_outward(x: torch.Tensor, down: bool) -> torch.Tensor:
    """f64 x rounded to f32 toward -inf (down) or +inf."""
    y = x.float()
    off = y.double() > x if down else y.double() < x
    return torch.where(off, torch.nextafter(
        y, torch.full_like(y, -math.inf if down else math.inf)), y)


def minu_norm_interval(ldes, lvalid, rdes, rvalid):
    """(lo, hi) [NT, B] f32: where ``minu_screen_norm`` may land when the
    card sums its dots on the tensor cores (bf16 ldes), around the plain
    version. Validity >= 0.

    A dot summed in the tensor cores' order lies within e = ``TC_SUM_ULPS``
    D sum_d |l_d r_d| of the index-order dot d (``seq_dots``), so in
    [d - e, d + e], taken in f64 (e raised by 2^-30 of itself for the f64
    roundings) and rounded outward to f32. Every later step is the plain
    version's f32 arithmetic, which the kernel repeats, and each step is
    monotone under rounding to nearest: s = (relu(dot) * lv) * rv is
    non-decreasing in the dot; an index-order sum in each term; n = ((s /
    (((row + col) - s) + 1e-6)) * lv) * rv is non-decreasing in s and
    non-increasing in row and col while the denominator is positive;
    maxima, sums and the min are non-decreasing. So these steps on the ends
    of the intervals bound the card's values with every rounding in them,
    the division's included, and nothing taken to first order:

    - s in [s_lo, s_hi]: the steps on d - e and d + e;
    - row in [row_lo, row_hi], col in [col_lo, col_hi]: the index-order
      sums of s_lo and of s_hi;
    - n >= n_lo = n(s_lo, row_hi, col_hi): the card's row and column hold
      its s and terms >= 0, so row >= s, col >= s, and the denominator is
      positive at every point used;
    - n <= n_hi = min(n(s_hi, max(row_lo, s_lo), max(col_lo, s_lo)),
      fl(lv * rv)) where that denominator is positive, else fl(lv * rv):
      row >= s gives ((row + col) - s) >= s and s / (that + 1e-6) <= 1, the
      cap; the first term bounds it where a denominator near 1e-6, which a
      first-order bound gets wrong, stays positive;
    - lo, hi: the maxima, index-order sums and min of n_lo and n_hi.
    """
    lv = lvalid[:, None, :, None]
    rv = rvalid[None, :, None, :]
    d = seq_dots(ldes, rdes).double()
    mag = torch.matmul(ldes.double().abs()[:, None],
                       rdes.double().abs().transpose(1, 2)[None])
    e = TC_SUM_ULPS * ldes.shape[-1] * mag * (1.0 + 2.0 ** -30)
    s_lo, s_hi = ((torch.clamp(_f32_outward(dot, down), min=0.0) * lv) * rv
                  for dot, down in ((d - e, True), (d + e, False)))
    row_lo, row_hi = (seq_sum(s, dim=-1)[..., :, None] for s in (s_lo, s_hi))
    col_lo, col_hi = (seq_sum(s, dim=-2)[..., None, :] for s in (s_lo, s_hi))
    n_lo = ((s_lo / (((row_hi + col_hi) - s_lo) + 1e-6)) * lv) * rv
    den = ((torch.maximum(row_lo, s_lo) + torch.maximum(col_lo, s_lo))
           - s_hi) + 1e-6
    cap = (lv * rv).expand_as(s_hi)
    n_hi = torch.where(den > 0, torch.minimum(((s_hi / den) * lv) * rv, cap),
                       cap)

    def reduce(n):
        return torch.minimum(seq_sum(n.max(dim=-1).values, dim=-1),
                             seq_sum(n.max(dim=-2).values, dim=-1))
    return reduce(n_lo), reduce(n_hi)


def screen_t_bf16(xt: torch.Tensor, dect: torch.Tensor,
                  entries: int = 8) -> torch.Tensor:
    """The transposed bf16 screen of the ADC-screen experiment: xt [Da, M]
    and dect [B, Rt, Da] bf16 -> raw [B, M] f32. On the card the blocks
    that share a group of 512 columns of xt take the gallery ``entries``
    at a time (the script's entries per step; 1 to 64), on the tensor
    cores for Da <= 98, within ``screen_t_tol`` of the plain version."""
    Da, M = xt.shape
    B, Rt, _ = dect.shape
    dev = xt.device
    _check("xt", xt, (Da, M), torch.bfloat16, dev)
    _check("dect", dect, (B, Rt, Da), torch.bfloat16, dev)
    if not _is_cuda(dev):
        return screen_t_bf16_plain(xt, dect)
    raw = torch.empty((B, M), dtype=torch.float32, device=dev)
    err = _build.load().afis_screen_t_bf16(
        xt.data_ptr(), dect.data_ptr(), raw.data_ptr(), M, B, Rt, Da,
        entries, _stream(dev))
    _build.check(err, "screen_t_bf16")
    screen_t_bf16.launches += 1
    return raw


screen_t_bf16.launches = 0


def screen_t_int8_plain(xt, dect, corr):
    """raw[b, m] = max_j (sum_d dect[b, j, d] xt[d, m] + corr[b, j]) in
    int32; the products and sums are exact in f64, so any order gives the
    same integers."""
    dots = torch.matmul(dect.double(), xt.double())            # [B, Rt, M]
    return (dots + corr.double()[:, :, None]).max(dim=1).values \
        .to(torch.int32)


def screen_t_int8(xt: torch.Tensor, dect: torch.Tensor, corr: torch.Tensor,
                  entries: int = 8) -> torch.Tensor:
    """The transposed int8 x int8 screen of the ADC-screen experiment:
    xt [D, M] and dect [B, Rt, D] int8 (D a multiple of 4), corr [B, Rt]
    int32 -> raw [B, M] int32. On the card the plain version's integers bit
    for bit wherever they fit in int32: D <= 96 on the tensor cores, the
    blocks of each group of 512 columns of xt taking the gallery
    ``entries`` at a time (1 to 64); wider D with ``__dp4a``
    (``screen_t_int8.plans`` counts the launches of each)."""
    D, M = xt.shape
    B, Rt, _ = dect.shape
    dev = xt.device
    _check("xt", xt, (D, M), torch.int8, dev)
    _check("dect", dect, (B, Rt, D), torch.int8, dev)
    _check("corr", corr, (B, Rt), torch.int32, dev)
    if not _is_cuda(dev):
        return screen_t_int8_plain(xt, dect, corr)
    raw = torch.empty((B, M), dtype=torch.int32, device=dev)
    lib = _build.load()
    err = lib.afis_screen_t_int8(
        xt.data_ptr(), dect.data_ptr(), corr.data_ptr(), raw.data_ptr(), M, B,
        Rt, D, entries, _stream(dev))
    _build.check(err, "screen_t_int8")
    screen_t_int8.launches += 1
    screen_t_int8.plans[SCREEN_T_INT8_PLANS[lib.afis_screen_t_int8_plan(D)]] \
        += 1
    return raw


screen_t_int8.launches = 0
screen_t_int8.plans = dict.fromkeys(SCREEN_T_INT8_PLANS, 0)


def screen_t_operands(x: torch.Tensor, dec: torch.Tensor,
                      rsq: torch.Tensor, rvalid: torch.Tensor,
                      int8: bool = False):
    """The transposed screens' operands, as the experiment's ``run`` builds
    them (the JAX package's scripts/exp_screen_mfu.py:113-153).

    bf16: (xt [D + 2, M], dect [B, Rt, D + 2]) with dec cast to bf16 beside
    the aug columns -(rsq / 2) and 0 / -1e4, both rounded to bf16, against
    x with two ones rows. int8: (xt [D, M], dect [B, Rt, D], corr [B, Rt],
    sx) with sx = max|x| / 126 + 1e-9, xt = clip(round(x / sx)) and corr =
    round(-(rsq / 2) / sx) + (0 or -2^28).
    """
    NL, Lt, D = x.shape
    M = NL * Lt
    rsqm = rsq * 0.5
    if int8:
        xf = x.float()
        sx = true_div(xf.abs().max(), 126.0) + 1e-9
        xq = torch.clamp(torch.round(true_div(xf, sx.expand_as(xf))), -127,
                         127).to(torch.int8)
        corr = torch.round(true_div(-rsqm, sx.expand_as(rsqm))) \
            .to(torch.int32) + torch.where(
                rvalid > 0, 0, -(1 << 28)).to(torch.int32)
        return (xq.reshape(M, D).t().contiguous(),
                dec.to(torch.int8).contiguous(), corr.contiguous(), sx)
    bf = torch.bfloat16
    aug = torch.stack([(-rsqm).to(bf), torch.where(
        rvalid > 0, torch.zeros_like(rvalid),
        torch.full_like(rvalid, SCREEN_SENT)).to(bf)], dim=2)
    ones = torch.ones((NL, Lt, 2), dtype=bf, device=x.device)
    return (torch.cat([x.to(bf), ones], dim=2).reshape(M, D + 2).t()
            .contiguous(), torch.cat([dec.to(bf), aug], dim=2).contiguous())


def screen_t(x: torch.Tensor, lsq: torch.Tensor, lvalid: torch.Tensor,
             dec: torch.Tensor, rsq: torch.Tensor, rvalid: torch.Tensor,
             int8: bool = False, entries: int = 8) -> torch.Tensor:
    """The experiment's transposed screen end to end (its ``run``, the JAX
    package's scripts/exp_screen_mfu.py:113-170) -> [NL, B] f32.

    x [NL, Lt, D] bf16, lsq / lvalid [NL, Lt] f32, dec [B, Rt, D] int8 or
    bf16, rsq / rvalid [B, Rt] f32; operands as ``screen_t_operands``.
    best = 2 raw + (6 - lsq) in bf16, 2 raw sx + (6 - lsq) in int8; then
    sum_i max(best, 0) * lvalid.
    """
    NL, Lt, _ = x.shape
    B = dec.shape[0]
    ops = screen_t_operands(x, dec, rsq, rvalid, int8)
    if int8:
        raw = screen_t_int8(*ops[:3], entries)
        raw = raw.reshape(B, NL, Lt).transpose(0, 1)
        best = 2.0 * raw.float() * ops[3] + (6.0 - lsq)[:, None, :]
    else:
        raw = screen_t_bf16(*ops, entries)
        raw = raw.reshape(B, NL, Lt).transpose(0, 1)
        best = 2.0 * raw + (6.0 - lsq)[:, None, :]
    return (torch.clamp(best, min=0.0) * lvalid[:, None, :]).sum(dim=2)


H1_VARIANTS = ("bcast", "matmul", "gram")


def _probe_dist(x, y, variant: str):
    """[N, K, K] pairwise distances of one side, as the probe's variant
    forms them (the JAX package's scripts/microbench_h1_probe.py)."""
    if variant == "gram":
        s = x * x + y * y
        q = s[:, :, None] * 1.0 + s[:, None, :] * 1.0
        q = q + (-2.0 * x)[:, :, None] * x[:, None, :]
        q = q + (-2.0 * y)[:, :, None] * y[:, None, :]
        return torch.sqrt(torch.clamp(q, min=0.0))
    if variant == "matmul":
        dx = x[:, :, None] * 1.0 + x[:, None, :] * -1.0
        dy = y[:, :, None] * 1.0 + y[:, None, :] * -1.0
    else:
        dx = x[:, :, None] - x[:, None, :]
        dy = y[:, :, None] - y[:, None, :]
    return torch.sqrt(dx * dx + dy * dy)


def h1_probe_plain(lx, ly, rx, ry, vf, variant: str = "bcast"):
    """sum_i sum_j clip((30 - dist) / 25, 0, 1) (dist <= 30) vf_j vf_i with
    dist = |d1 - d2|, both sums in index order."""
    d1, d2 = _probe_dist(lx, ly, variant), _probe_dist(rx, ry, variant)
    dist = (d1 - d2).abs()
    h1 = torch.clamp((30.0 - dist) / torch.full_like(dist, 25.0), 0.0, 1.0)
    pairf = vf[:, None, :] * vf[:, :, None]
    gate = (dist <= 30.0).float() * pairf
    return seq_sum(seq_sum(h1 * gate, dim=2), dim=1)


def h1_probe(lx: torch.Tensor, ly: torch.Tensor, rx: torch.Tensor,
             ry: torch.Tensor, vf: torch.Tensor,
             variant: str = "bcast") -> torch.Tensor:
    """The H1-build probe over NP sets of K slots: lx, ly, rx, ry, vf
    [NP, K] f32 -> [NP] f32, the distances formed as ``variant`` (bcast,
    matmul: equal bit for bit; gram: not exact)."""
    NP, K = lx.shape
    dev = lx.device
    for name, t in (("lx", lx), ("ly", ly), ("rx", rx), ("ry", ry),
                    ("vf", vf)):
        _check(name, t, (NP, K), torch.float32, dev)
    if variant not in H1_VARIANTS:
        raise ValueError(f"variant {variant!r}, expected one of "
                         f"{H1_VARIANTS}")
    if not _is_cuda(dev):
        return h1_probe_plain(lx, ly, rx, ry, vf, variant)
    out = torch.empty((NP,), dtype=torch.float32, device=dev)
    err = _build.load().afis_h1_probe(
        *(t.data_ptr() for t in (lx, ly, rx, ry, vf, out)), NP, K,
        H1_VARIANTS.index(variant), _stream(dev))
    _build.check(err, "h1_probe")
    h1_probe.launches += 1
    return out


h1_probe.launches = 0


def legality_canary_plain(x):
    return x.clone()


def max_smem_optin() -> int:
    """The card's limit of dynamic shared memory per block, in bytes
    (232,448 on the H100)."""
    return int(_build.load().afis_max_smem_optin())


def legality_canary(x: torch.Tensor, threads: int = 256,
                    smem_bytes: int = 0) -> torch.Tensor:
    """A copy of x (f32, any shape, any offset into its storage) launched
    with the plan (``threads`` per block, ``smem_bytes`` of dynamic shared
    memory). A plan the card refuses raises RuntimeError naming the CUDA
    error; it never returns output. The grid does not follow the plan:
    about as many blocks as the card holds at it."""
    dev = x.device
    _check("x", x, tuple(x.shape), torch.float32, dev)
    if not _is_cuda(dev):
        return legality_canary_plain(x)
    y = torch.empty_like(x)
    err = _build.load().afis_legality_canary(
        x.data_ptr(), y.data_ptr(), x.numel(), int(threads), int(smem_bytes),
        _stream(dev))
    _build.check(err, "legality_canary")
    legality_canary.launches += 1
    return y


legality_canary.launches = 0
