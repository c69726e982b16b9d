"""Reading the traced window: torch.profiler's events to device time.

``read_profile`` turns a finished ``torch.profiler.profile`` into plain
event tuples; ``Trace`` reduces them. Device busy time is the union of the
device's operation intervals (so that work on two streams is not counted
twice); the idle share is 1 - busy / window, as ``chip_smoke.py``'s
``profile_call`` takes it over one call, here over the whole window.
Idle gaps are charged to the innermost host operation running at the
gap's middle.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

MEMORY_OPS = ("Memcpy", "Memset", "memcpy", "memset")


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    device: bool          # True: runs on the card; False: a host operation
    start_us: float
    dur_us: float

    @property
    def end_us(self) -> float:
        return self.start_us + self.dur_us

    @property
    def is_kernel(self) -> bool:
        return self.device and not any(m in self.name for m in MEMORY_OPS)


def read_profile(prof) -> List[Event]:
    """Events of a finished profiler, from its Kineto results."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = "CUDA" in str(e.device_type())
        out.append(Event(e.name(), dev, e.start_ns() / 1e3,
                         e.duration_ns() / 1e3))
    return out


def _union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


class Trace:
    """The device's side of a traced window of ``window_s`` seconds."""

    def __init__(self, events: Sequence[Event], window_s: float):
        self.window_s = float(window_s)
        self.device = [e for e in events if e.device and e.dur_us > 0]
        self.host = [e for e in events if not e.device]
        self.busy = _union([(e.start_us, e.end_us) for e in self.device])

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e6

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def by_name(self, kernels_only: bool = True) -> Dict[str, Tuple[float, int]]:
        """{name: (device seconds, count)}."""
        out: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
        for e in self.device:
            if kernels_only and not e.is_kernel:
                continue
            out[e.name][0] += e.dur_us / 1e6
            out[e.name][1] += 1
        return {k: (v[0], int(v[1])) for k, v in out.items()}

    @property
    def kernel_launches(self) -> int:
        return sum(1 for e in self.device if e.is_kernel)

    def device_ops(self, n: int = 10) -> List[list]:
        """The n device operations that took most time: [[name, s], ...]."""
        tab = self.by_name(kernels_only=False)
        top = sorted(tab.items(), key=lambda kv: -kv[1][0])[:n]
        return [[name, s] for name, (s, _) in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle time between device operations, summed by the innermost
        host operation running at each gap's middle: the n largest."""
        host = sorted(self.host, key=lambda e: e.start_us)
        gaps: Dict[str, float] = defaultdict(float)
        opened: List[Event] = []
        k = 0
        for (_, e0), (s1, _) in zip(self.busy, self.busy[1:]):
            mid = 0.5 * (e0 + s1)
            while k < len(host) and host[k].start_us <= mid:
                opened.append(host[k])
                k += 1
            opened = [h for h in opened if h.end_us >= mid]
            inner = min(opened, key=lambda h: h.dur_us, default=None)
            gaps[inner.name if inner else "(no host op)"] += (s1 - e0) / 1e6
        top = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
        return [[name, s] for name, s in top]
