"""The program's spans and counters against the traced window's device
timeline.

While a torch profiler records, the port records spans on its search path
(``msu_latentafis_tpu_torch.utils.timing``: ``span``, ``recorded``) on the
clock the profiler stamps its events with (``time.time_ns``), and its exact
layer's kernels count the graph filter's work (``ops.filter_counts``). A
program that has neither gives None here, and each reader of them reports
nothing.

Idle gaps are those of ``trace.Trace.idle_gaps``: between consecutive
intervals of ``Trace.busy``. Each is charged to the innermost span open at
its middle (the deepest; the later started on a tie), a gap under no span
(the caller between requests) to none. A span's layer is its name up to the
first dot.

The profiler's device timeline does not keep the host's clock: on an H100
its device-to-host copies were seen to end up to a few hundred µs before
the host call that issued them began, the offset drifting by ~0.1% of
the time elapsed and jumping back. So each gap's middle is first moved
onto the host clock (``clock_anchors``): every copy to the host on the
search path is made inside a ``select.readback`` span by a pageable
``cudaMemcpyAsync`` call, which returns once the copy has ended; the k-th
such call and the k-th device-to-host copy give the offset at that copy's
end, and the offset is interpolated linearly between copies (held beyond
the first and the last). Where the two counts differ no offset is
applied.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from afis_bench.kernels import device_seconds
from afis_bench.work import PEAK_F32, Shapes, window_least_s

# the power iterations of the filter's first stage in each counted kernel
# (engine.block_args) and the operations per unit of its counts
# (chip_smoke.filter_ops): k^2 (20 + 2 iters + 6) + n^2 (40 + 10 + 6)
FILTER_ITERS = {"minutiae_match": 5, "texture_match": 3}
NO_SPAN = None
READBACK = "select.readback"
COPY_CALL = "cudaMemcpyAsync"


def layer(name: str) -> str:
    return name.split(".", 1)[0]


def program_spans() -> Optional[list]:
    """The spans the program recorded, or None where it records none."""
    try:
        from msu_latentafis_tpu_torch.utils import timing
    except ImportError:
        return None
    recorded = getattr(timing, "recorded", None)
    return None if recorded is None else recorded().spans


def program_filter_counts() -> Optional[dict]:
    """{kernel: {sets, k_valid_sq, n_stage1_sq}}, or None where the
    program counts nothing."""
    try:
        from msu_latentafis_tpu_torch.matcher.kernels import ops
    except ImportError:
        return None
    counts = getattr(ops, "filter_counts", None)
    return None if counts is None else counts()


def _depths(spans: Sequence) -> List[int]:
    """Nesting depth of each span; a parent's slot precedes its child's."""
    depth: List[int] = []
    for s in spans:
        depth.append(0 if s.parent < 0 else depth[s.parent] + 1)
    return depth


def gaps(busy: Sequence[Tuple[float, float]]
         ) -> Iterable[Tuple[float, float]]:
    """(start, end) in µs of each idle gap between busy intervals."""
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        yield e0, s1


def innermost(times_us: Sequence[float], spans: Sequence) -> List[int]:
    """For each time (µs) the index of the innermost closed span open at
    it, -1 where none is."""
    depth = _depths(spans)
    order = sorted((i for i, s in enumerate(spans) if s.t1_ns >= 0),
                   key=lambda i: spans[i].t0_ns)
    t0 = [spans[i].t0_ns / 1e3 for i in order]
    opened: List[int] = []
    out = [-1] * len(times_us)
    k = 0
    for j in sorted(range(len(times_us)), key=lambda j: times_us[j]):
        t = times_us[j]
        while k < len(order) and t0[k] <= t:
            opened.append(order[k])
            k += 1
        opened = [i for i in opened if spans[i].t1_ns / 1e3 >= t]
        out[j] = max(opened, key=lambda i: (depth[i], spans[i].t0_ns),
                     default=-1)
    return out


def readback_calls(host: Sequence, spans: Sequence) -> List:
    """The host's copy calls made inside ``select.readback`` spans, in
    order."""
    reads = sorted((s.t0_ns / 1e3, s.t1_ns / 1e3) for s in spans
                   if s.name == READBACK and s.t1_ns >= 0)
    starts = [a for a, _ in reads]
    out = []
    for e in sorted((e for e in host if e.name == COPY_CALL),
                    key=lambda e: e.start_us):
        k = bisect.bisect_right(starts, e.start_us) - 1
        if k >= 0 and e.start_us <= reads[k][1]:
            out.append(e)
    return out


def device_copies(device: Sequence) -> List:
    """The device-to-host copies on the device timeline, in order."""
    return sorted((e for e in device if "DtoH" in e.name),
                  key=lambda e: e.start_us)


def clock_anchors(trace, spans) -> List[Tuple[float, float]]:
    """[(device µs, host minus device µs)] at each device-to-host copy's
    end; empty where the host's readback calls and the device's copies
    differ in number."""
    calls, copies = readback_calls(trace.host, spans), device_copies(
        trace.device)
    if not copies or len(calls) != len(copies):
        return []
    return [(c.end_us, h.end_us - c.end_us) for h, c in zip(calls, copies)]


def to_host(times_us: Sequence[float], anchors) -> List[float]:
    """Device times on the host clock, by the anchors' offsets."""
    if not anchors:
        return list(times_us)
    x, y = zip(*anchors)
    return (np.asarray(times_us, float) + np.interp(times_us, x, y)).tolist()


def charge(busy: Sequence[Tuple[float, float]], spans: Sequence,
           anchors=()) -> List[Tuple[int, float]]:
    """[(index of the span charged, or -1 for none; gap seconds)] for each
    idle gap, in order, its middle moved to the host clock by
    ``anchors``."""
    g = list(gaps(busy))
    at = innermost(to_host([0.5 * (g0 + g1) for g0, g1 in g], anchors),
                   spans)
    return [(i, (g1 - g0) / 1e6) for i, (g0, g1) in zip(at, g)]


def idle_by_name(busy, spans, anchors=()) -> Dict[Optional[str], float]:
    """Idle seconds charged to each span name (None: under no span)."""
    out: Dict[Optional[str], float] = defaultdict(float)
    for i, s in charge(busy, spans, anchors):
        out[spans[i].name if i >= 0 else NO_SPAN] += s
    return dict(out)


def idle_ms_per_latent(run, layers: Tuple[str, ...],
                       spans: Optional[list] = None) -> Optional[float]:
    """Idle ms per latent completed charged to spans of ``layers``; None
    without device work in the trace or without the program's spans."""
    if run.trace is None or not run.trace.busy:
        return None
    if spans is None:
        # the charge is the same for every reader of one run
        by = getattr(run, "_idle_by_span", None)
        if by is None:
            spans = program_spans()
            by = run._idle_by_span = idle_by_name(
                run.trace.busy, spans, clock_anchors(run.trace, spans)) \
                if spans else {}
    else:
        by = idle_by_name(run.trace.busy, spans, clock_anchors(
            run.trace, spans)) if spans else {}
    if not by:
        return None
    s = sum(v for k, v in by.items()
            if k is not NO_SPAN and layer(k) in layers)
    return s * 1e3 / run.window.latents


def filter_ops(counts: dict) -> float:
    """The graph filter's operations from its counts."""
    return sum(float(c["k_valid_sq"]) * (26.0 + 2.0 * FILTER_ITERS[k])
               + 56.0 * float(c["n_stage1_sq"])
               for k, c in counts.items() if k in FILTER_ITERS)


def exact_roofline_counted(run, counts: Optional[dict] = None
                           ) -> Optional[float]:
    """``exact_roofline``'s least time (each window batch's, from the
    latents it carried) plus the filter's counted operations at the f32
    peak, over the exact group's device time, in per cent."""
    if run.trace is None:
        return None
    counts = program_filter_counts() if counts is None else counts
    if not counts or not any(c["sets"] for c in counts.values()):
        return None
    s = device_seconds(run.trace, "exact")
    least = window_least_s(Shapes(run.config, run.mix), run.window_latents(),
                           "exact")
    if s <= 0 or not least:
        return None
    return 100.0 * (least + filter_ops(counts) / PEAK_F32) / s
