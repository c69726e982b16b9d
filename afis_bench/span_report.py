"""Where the host's time goes in one traced run of a cell, span by span.

    python3 -m afis_bench.span_report --workload <cell> --seed N \\
        --seconds S [--out FILE]

Runs the cell once through the harness with the trace on (the run that
``run.py --trace 1`` makes), keeps the profiler's events and the program's
spans (``afis_bench/spans.py``), and prints one JSON object (also written
to ``--out``): per span name, per latent completed, the host's self time
(the span less its children), the idle time charged to it, the port's own
kernel launches in its self time and torch's (host launch calls whose
start falls in its self time, less the port's own); the idle time under
no span; the program's clock against the device timeline's: the share of
``select.readback`` spans that hold the end of a device-to-host copy, the
offsets of the copies from the host calls that made them
(``spans.clock_anchors``), and the share of copies that fall inside their
host call, raw and moved by the offsets of the other copies (every second
copy held out); the names of the events the profiler kept; and the run's
result line. Idle time is charged on the host clock, as the readers charge
it.
"""
from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
from collections import Counter, defaultdict
from typing import List

from afis_bench import harness as H
from afis_bench import spans as S
from afis_bench import trace as TR

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def self_times(spans) -> List[float]:
    """Each span's duration less its children's, in µs."""
    out = [(s.t1_ns - s.t0_ns) / 1e3 if s.t1_ns >= 0 else 0.0 for s in spans]
    for s in spans:
        if s.parent >= 0 and s.t1_ns >= 0:
            out[s.parent] -= (s.t1_ns - s.t0_ns) / 1e3
    return out


def self_launches(spans) -> List[int]:
    out = [s.launches for s in spans]
    for s in spans:
        if s.parent >= 0:
            out[s.parent] -= s.launches
    return out


def report(events, spans, busy, latents: int) -> dict:
    names = [s.name for s in spans]
    table = defaultdict(lambda: dict(count=0, self_ms=0.0, idle_ms=0.0,
                                     port_launches=0, torch_launches=0))
    for s, t, n in zip(spans, self_times(spans), self_launches(spans)):
        row = table[s.name]
        row["count"] += 1
        row["self_ms"] += t / 1e3
        row["port_launches"] += n
    none = dict(idle_ms=0.0, launch_calls=0)
    host = [e for e in events if not e.device]
    device = [e for e in events if e.device]
    anchors = S.clock_anchors(TR.Trace(events, 1.0), spans)
    charged = S.charge(busy, spans, anchors)
    for i, sec in charged:
        if i >= 0:
            table[names[i]]["idle_ms"] += sec * 1e3
        else:
            none["idle_ms"] += sec * 1e3
    calls = sorted(e.start_us for e in events if e.name in LAUNCH_CALLS)
    for i in S.innermost(calls, spans):
        if i >= 0:
            table[names[i]]["torch_launches"] += 1
        else:
            none["launch_calls"] += 1
    for row in table.values():
        row["torch_launches"] -= row["port_launches"]
    per = {k: {f: (v / latents if f != "count" else v)
               for f, v in row.items()} for k, row in table.items()}
    copies = sorted(e.end_us for e in device if "DtoH" in e.name)
    reads = [s for s in spans if s.name == S.READBACK and s.t1_ns >= 0]
    held = sum(bool(copies_between(copies, s.t0_ns / 1e3, s.t1_ns / 1e3))
               for s in reads)
    idle = sum(sec for _, sec in charged)
    return {"latents": latents, "per_latent": per,
            "no_span": {"idle_ms_per_latent": none["idle_ms"] / latents,
                        "launch_calls_per_latent":
                            none["launch_calls"] / latents,
                        "share_of_idle": none["idle_ms"] / 1e3 / idle
                        if idle else None},
            "readback_holds_copy_end": held / len(reads) if reads else None,
            "readback_spans": len(reads),
            "clock": clock_check(host, device, spans, anchors)}


def clock_check(host, device, spans, anchors) -> dict:
    """The copies' offsets (host call end minus copy end, µs), and for
    every odd copy, raw and moved onto the host clock by the even copies'
    offsets: its end minus its host call's end (µs, quartiles; the call
    returns just after the copy ends) and the share that ends before its
    call began or starts before it (neither can happen)."""
    calls, copies = S.readback_calls(host, spans), S.device_copies(device)
    out = {"calls": len(calls), "copies": len(copies)}
    if not anchors:
        return out

    def quartiles(v):
        v = list(v)
        q = statistics.quantiles(v, n=4) if len(v) > 1 else v * 3
        return dict(min=min(v), q1=q[0], median=q[1], q3=q[2], max=max(v))
    out["offset_us"] = quartiles(y for _, y in anchors)
    even, odd_calls, odd = anchors[0::2], calls[1::2], copies[1::2]
    if not odd:
        return out
    for how, shift in (("raw", lambda t: t),
                       ("moved", lambda t: S.to_host(t, even))):
        ends = shift([c.end_us for c in odd])
        starts = shift([c.start_us for c in odd])
        out[how] = dict(
            end_minus_call_end_us=quartiles(e - h.end_us for h, e in
                                            zip(odd_calls, ends)),
            impossible=sum(e < h.start_us or s < h.start_us for h, e, s in
                           zip(odd_calls, ends, starts)) / len(odd))
    return out


def copies_between(ends: List[float], a: float, b: float) -> List[float]:
    """The sorted ``ends`` within [a, b]."""
    return ends[bisect.bisect_left(ends, a):bisect.bisect_right(ends, b)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    H.set_cache_dirs()
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kept = []
    read_profile = TR.read_profile

    def keep(prof):
        kept.extend(read_profile(prof))
        return kept

    TR.read_profile = keep
    out = H.run_cell(H.Bench.load(), args.workload, args.seed, args.seconds,
                     True, "cuda")
    out.pop("forbidden_modules", None)
    spans = S.program_spans() or []
    busy = TR.Trace(kept, 1.0).busy
    rep = report(kept, spans, busy, out["attempted"] - out["failed"])
    rep["events"] = {
        "host": Counter(e.name for e in kept if not e.device).most_common(25),
        "device": Counter(e.name for e in kept if e.device).most_common(12)}
    rep["result"] = out
    text = json.dumps(rep)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
