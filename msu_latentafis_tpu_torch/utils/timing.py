"""Structured stage timing, spans and a device trace.

The port's copy of the JAX package's ``utils/timing.py``: a PhaseTimer of
named buckets that accumulate across calls (the reference's chrono phase
buckets, matcher.cpp:34-44 and :715-720) and report as a dict or a table;
``device_trace`` wraps ``torch.profiler`` around a block of work and writes
its Chrome trace, the counterpart of the JAX package's ``jax.profiler``
trace. ``card_line`` names the card beside every number measured on it.

Spans: ``span(name)`` marks a stretch of the search path's host code
(``matcher/engine.py``). It records only while a ``torch.profiler``
profile records (``recording``), which is the one switch: ``device_trace``
and the benchmark's traced window turn it on. Otherwise it returns one
shared no-op context. A recorded span keeps its name (its layer is the
name up to the first dot), its start and end on ``time.time_ns()``, the
clock the profiler stamps its events with, its parent, the request it
belongs to (the number of the enclosing ``search`` span) and the port's
kernel launches made inside it. Spans are kept in memory, never sent to
the profiler: a ``record_function`` range would reach the device timeline
as a user annotation. ``recorded()`` returns them with the port's
counters; ``reset()`` clears both.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import time
from collections import OrderedDict
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch


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


REQUEST = "search"        # the span that opens a request


class Span(NamedTuple):
    """One recorded span. ``parent`` is the index of the enclosing span in
    ``recorded().spans`` (-1 at the top), ``request`` the number of the
    enclosing ``search`` span (None outside one), ``launches`` the port's
    kernel launches inside it (``ops.launch_counts``), children's too."""
    name: str
    t0_ns: int
    t1_ns: int
    parent: int
    request: Optional[int]
    launches: int


class Recording(NamedTuple):
    spans: List[Span]
    counters: dict           # {"filter": ops.filter_counts()}


def recording() -> bool:
    """True while a torch profiler records: spans and the graph filter's
    counters record then, and only then."""
    return _profiler_enabled()


_profiler_enabled = torch.autograd._profiler_enabled


def _kernel_wrappers() -> tuple:
    from ..matcher.kernels import ops
    return tuple(getattr(ops, k) for k in ops.KERNELS)


class _Recorder:
    """The spans of this process: a slot per span, taken when it opens and
    filled when it closes, so that a child knows its parent's index. One
    thread (the caller's) records."""

    def __init__(self):
        self.spans: List[Optional[Span]] = []
        self.open: list = []        # (slot, name, t0_ns, request, launches)
        self.requests = 0
        self.kernels = ()

    def launches(self) -> int:
        if not self.kernels:
            self.kernels = _kernel_wrappers()
        return sum(k.launches for k in self.kernels)

    def enter(self, name: str) -> None:
        if name == REQUEST:
            request = self.requests
            self.requests += 1
        else:
            request = self.open[-1][3] if self.open else None
        self.open.append((len(self.spans), name, time.time_ns(), request,
                          self.launches()))
        self.spans.append(None)

    def exit(self) -> None:
        t1 = time.time_ns()
        i, name, t0, request, n0 = self.open.pop()
        parent = self.open[-1][0] if self.open else -1
        self.spans[i] = Span(name, t0, t1, parent, request,
                             self.launches() - n0)

    def snapshot(self) -> List[Span]:
        out = list(self.spans)
        for k, (i, name, t0, request, n0) in enumerate(self.open):
            parent = self.open[k - 1][0] if k else -1
            out[i] = Span(name, t0, -1, parent, request,
                          self.launches() - n0)
        return out


_recorder = _Recorder()


class _Open:
    """A recorded span; it closes in the recorder it opened in, so that a
    ``reset`` while it is open leaves the new recorder whole."""
    __slots__ = ("name", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rec = _recorder
        self.rec.enter(self.name)
        return self

    def __exit__(self, *exc):
        self.rec.exit()
        return False


_NOOP = contextlib.nullcontext()


def span(name: str):
    """A context that records the block as the span ``name`` while
    ``recording()``; otherwise the shared no-op context."""
    if not recording():
        return _NOOP
    return _Open(name)


def recorded() -> Recording:
    """The spans recorded since the last ``reset`` (an open span's
    ``t1_ns`` is -1) and the port's counters."""
    from ..matcher.kernels import ops
    return Recording(_recorder.snapshot(), {"filter": ops.filter_counts()})


def reset() -> None:
    """Forget the recorded spans and zero the graph filter's counters."""
    from ..matcher.kernels import ops
    global _recorder
    _recorder = _Recorder()
    ops.filter_counts(reset=True)


def chrome_events(rec: Recording, base_ns: int) -> List[dict]:
    """The closed spans of ``rec`` as Chrome trace events ("X", in µs from
    ``base_ns``), on a row of their own, and the counters as one metadata
    event."""
    pid = "program spans"
    out = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": pid}}]
    for i, s in enumerate(rec.spans):
        if s.t1_ns < 0:
            continue
        out.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid,
                    "tid": 0, "ts": (s.t0_ns - base_ns) / 1e3,
                    "dur": (s.t1_ns - s.t0_ns) / 1e3,
                    "args": {"index": i, "parent": s.parent,
                             "request": s.request,
                             "launches": s.launches}})
    out.append({"ph": "M", "name": "counters", "pid": pid, "tid": 0,
                "args": rec.counters})
    return out


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """``torch.profiler`` over the block (CPU and, where there is a card,
    CUDA activity); writes ``<log_dir>/trace.json`` (Chrome trace format)
    with the program's spans (``span``) beside the profiler's events, on
    the same clock, as a process row of their own named "program spans",
    and the graph filter's counters as its "counters" metadata. Spans and
    counters are reset first. A no-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"].extend(chrome_events(
        recorded(), int(trace.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as f:
        json.dump(trace, f)


def card_line(device="cuda") -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (its
    first line); "cpu" for a CPU device. On a CUDA device a missing or
    failing nvidia-smi raises: a card number needs its card's name."""
    if torch.device(device).type == "cpu":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
