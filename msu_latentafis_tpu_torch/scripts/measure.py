"""What the measuring scripts share.

The scripts (``rank_parity_100k``, ``rank_parity_structured``,
``profile_rerank``, ``profile_match``, ``bench_ladder``) run on the card
unless asked for the CPU (``--device cpu``); without a card and without
that flag they raise. Every record they print carries ``header``: the
card's name and power limit (``utils.timing.card_line``), the torch and
CUDA versions and the device. The codebook is
``random_codebook(np.random.default_rng(CODEBOOK_SEED))``, the one
``chip_smoke.py`` draws, in place of the reference's trained codebook.
``--record`` writes ``results/torch/<name>.json`` of the checkout and no
other file.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from ..matcher.engine import MatchEngine
from ..templates.packing import pack_latent
from ..utils.synthetic import random_codebook
from ..utils.timing import card_line

CODEBOOK_SEED = 20261017
RESULTS = Path(__file__).resolve().parents[2] / "results" / "torch"
# (Rm, Rt, Lm, Lt): the JAX bench's 448 shape, and the reference's
# capacities (matcher.h:31-32)
SHAPES_448 = (96, 448, 64, 448)
SHAPES_CAP = (128, 1000, 128, 1000)


def shapes_of(cap: bool) -> tuple:
    return SHAPES_CAP if cap else SHAPES_448


def parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.split("\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (the default) needs a card")
    p.add_argument("--record", action="store_true",
                   help="write the record to results/torch/")
    return p


def device_of(name: str) -> torch.device:
    """The device to run on; "cuda" without a card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on "
                           "the CPU")
    return dev


def header(device) -> dict:
    return {"card": card_line(device), "torch": torch.__version__,
            "cuda": torch.version.cuda, "device": str(device)}


def codebook() -> np.ndarray:
    return random_codebook(np.random.default_rng(CODEBOOK_SEED))


def env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def clock(fn, device):
    """(fn()'s result, its seconds on the host clock, the device's work
    included: synchronized before each reading)."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def min_of(fn, device, reps: int = 3) -> float:
    """fn() once to warm up, then the fastest of ``reps`` clocked calls."""
    fn()
    return min(clock(fn, device)[1] for _ in range(reps))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def write_record(name: str, obj) -> Path:
    RESULTS.mkdir(parents=True, exist_ok=True)
    path = RESULTS / f"{name}.json"
    path.write_text(json.dumps(obj, indent=1) + "\n")
    return path


def pack(template, Lm: int, Lt: int):
    """A latent packed at (Lm, Lt) slots, coordinates as given."""
    return pack_latent(template, quantize_tex_xy=False, minu_cap=Lm,
                       tex_cap=Lt)


def serving_engine(cb, cap: bool, block: int, device,
                   row_cap: int = 8) -> MatchEngine:
    """The JAX bench's engine in bf16: at the 448 shape with int8
    predecoded texture, at the cap shape codes-resident with int8
    minutiae (bench.py's headline modes)."""
    return MatchEngine(cb, block_size=block, compute_dtype=torch.bfloat16,
                       tex_int8=not cap, minu_int8=cap, codes_resident=cap,
                       row_cap=row_cap, device=device)


def gallery_bytes_per_entry(gal) -> float:
    """Bytes the gallery's tensors hold, per (padded) entry."""
    total = sum(t.numel() * t.element_size() for t in
                (getattr(gal, f) for f in gal.TENSORS) if t is not None)
    return total / gal.size
