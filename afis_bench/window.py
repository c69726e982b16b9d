"""The measured window: one client in a closed loop, and its arithmetic.

The client submits a batch, waits until every list of the batch is on the
host, then submits the next. The window opens at the first submission and
closes when the first batch to finish after ``seconds`` finishes. A batch's
latency runs from its submission to its last list on the host. The rate is
every latent completed over the whole window; the tail is taken over every
batch of the window.
"""
from __future__ import annotations

import time
from typing import Callable, List, Tuple

import numpy as np


class ClosedLoop:
    """Drives ``submit(batch_number)`` (which returns the number of latents
    whose lists reached the host) until the window closes; ``clock`` is the
    host clock in seconds."""

    def __init__(self, seconds: float,
                 clock: Callable[[], float] = time.perf_counter):
        if seconds <= 0:
            raise ValueError("the window needs seconds > 0")
        self.seconds = float(seconds)
        self.clock = clock
        self.batches: List[Tuple[float, float, int]] = []
        self.t_open = self.t_close = 0.0

    def run(self, submit: Callable[[int], int]) -> "ClosedLoop":
        self.t_open = t = self.clock()
        b = 0
        while True:
            n = submit(b)
            done = self.clock()
            self.batches.append((t, done, int(n)))
            b += 1
            if done - self.t_open >= self.seconds:
                break
            t = self.clock()
        self.t_close = done
        return self

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    @property
    def latents(self) -> int:
        return sum(n for _, _, n in self.batches)

    @property
    def rate(self) -> float:
        """Latents completed per second over the whole window."""
        return self.latents / self.window_s

    def latencies_ms(self) -> np.ndarray:
        return np.array([(d - s) * 1e3 for s, d, _ in self.batches])

    def percentile_ms(self, q: float) -> float:
        """The q-th percentile of batch latency over every batch (linear
        interpolation between order statistics)."""
        return float(np.percentile(self.latencies_ms(), q))
