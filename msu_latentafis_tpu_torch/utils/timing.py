"""Structured stage timing and a device trace.

The port's copy of the JAX package's ``utils/timing.py``: a PhaseTimer of
named buckets that accumulate across calls (the reference's chrono phase
buckets, matcher.cpp:34-44 and :715-720) and report as a dict or a table;
``device_trace`` wraps ``torch.profiler`` around a block of work and writes
its Chrome trace, the counterpart of the JAX package's ``jax.profiler``
trace. ``card_line`` names the card beside every number measured on it.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import time
from collections import OrderedDict
from typing import Dict, Iterator, Optional


class PhaseTimer:
    """Accumulating named phase buckets (host clock). Time device work by
    ending the phase with ``torch.cuda.synchronize()``: kernels return
    before the device finishes."""

    def __init__(self):
        self.buckets: "OrderedDict[str, float]" = OrderedDict()
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.buckets[name] = self.buckets.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, float]:
        return dict(self.buckets)

    def pretty(self) -> str:
        total = sum(self.buckets.values()) or 1.0
        lines = [f"{'phase':<32}{'total s':>10}{'calls':>8}{'%':>7}"]
        for k, v in self.buckets.items():
            lines.append(f"{k:<32}{v:>10.3f}{self.counts[k]:>8}"
                         f"{100 * v / total:>6.1f}%")
        return "\n".join(lines)

    def reset(self) -> None:
        self.buckets.clear()
        self.counts.clear()


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """``torch.profiler`` over the block (CPU and, where there is a card,
    CUDA activity); writes ``<log_dir>/trace.json`` (Chrome trace format).
    A no-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def card_line(device="cuda") -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (its
    first line); "cpu" for a CPU device. On a CUDA device a missing or
    failing nvidia-smi raises: a card number needs its card's name."""
    import torch
    if torch.device(device).type == "cpu":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
