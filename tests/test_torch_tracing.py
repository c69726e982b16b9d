"""Spans and counters on the port's search path, and the benchmark's
readers of them.

On the CPU: ``utils.timing.span`` records nothing without a profiler and
the span tree of a serving call and a ``list_to_list`` call under one, on
the profiler's clock; the graph filter's counts (``ops.filter_counts``)
are the plain versions' stats; ``device_trace`` writes the spans beside
the profiler's events; the benchmark's readers (``afis_bench/spans.py``)
charge each idle gap to the innermost span at its middle and count the
filter's operations into the exact roofline. Marked ``cuda``: the card's
filter counts equal the plain versions' and leave the scores unchanged.

    python -m pytest tests/test_torch_tracing.py -q
    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py -q
"""
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from afis_bench import harness as H
from afis_bench import spans as S
from afis_bench.trace import Event, Trace, read_profile
from afis_bench.window import ClosedLoop
from afis_bench.work import PEAK_F32, Shapes, bound_s
from msu_latentafis_tpu_torch.matcher.engine import MatchEngine
from msu_latentafis_tpu_torch.matcher.kernels import ops
from msu_latentafis_tpu_torch.templates import pack_gallery, pack_latent
from msu_latentafis_tpu_torch.utils import timing
from msu_latentafis_tpu_torch.utils.synthetic import (
    make_latent_template, make_rolled_template, random_codebook)

BENCH = Path(__file__).resolve().parents[1] / "afis_bench"
NAMES = {"search", "dispatch.pack", "dispatch.side", "screen", "exact",
         "select.topk", "select.take", "select.readback", "select.rank"}
SERVE = dict(m=4, prescreen_k=8, prescreen_lt=16, prescreen_t=1)


@pytest.fixture(autouse=True)
def _fresh_recorder():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    timing.reset()
    yield
    timing.reset()
    torch.set_num_threads(n)


def toy(device="cpu"):
    """12 entries (2 mates) in blocks of 4 and 2 latents of 3 templates."""
    rng = np.random.default_rng(5)
    cb = random_codebook(rng)
    lats = [make_latent_template(rng, n_minu=20, n_tex=40,
                                 n_minu_templates=3) for _ in range(2)]
    rolled = [make_rolled_template(
        rng, n_minu=24, n_tex=40, mated_latent=lats[i] if i < 2 else None,
        codebook=cb if i < 2 else None) for i in range(12)]
    engine = MatchEngine(cb, block_size=4, device=device)
    gal = engine.load_gallery(pack_gallery(rolled, cb, minu_cap=24,
                                           tex_cap=48))
    packed = [pack_latent(l, minu_cap=32, tex_cap=48, quantize_tex_xy=False)
              for l in lats]
    return engine, gal, packed


def zero_counts(counts):
    return all(v == 0 for c in counts.values() for v in c.values())


def test_span_without_a_profiler_records_nothing():
    engine, gal, packed = toy()
    assert not timing.recording()
    a, b = timing.span("search"), timing.span("exact")
    assert a is b
    with a, b:
        pass
    engine.match_scores_batch_reranked(packed, gal, **SERVE)
    rec = timing.recorded()
    assert rec.spans == [] and zero_counts(rec.counters["filter"])


def test_search_path_records_the_span_tree():
    engine, gal, packed = toy()
    with profile(activities=[ProfilerActivity.CPU]):
        assert timing.recording()
        engine.match_scores_batch_reranked(packed, gal, **SERVE)
        results = engine.list_to_list(packed, gal)
        results[0].ranked(5)
    spans = timing.recorded().spans
    assert [s.request for s in spans if s.name == "search"] == [0, 1]
    by_request = {0: set(), 1: set()}
    for s in spans:
        assert s.name in NAMES and 0 < s.t0_ns <= s.t1_ns
        assert s.launches == 0                   # the plain versions
        if s.name in ("search", "select.rank"):
            assert s.parent == -1
            assert (s.request is None) == (s.name == "select.rank")
        else:
            p = spans[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns
            assert s.request == p.request
        if s.request is not None:
            by_request[s.request].add(s.name)
    assert by_request[0] == NAMES - {"select.rank"}
    assert by_request[1] == {"search", "dispatch.pack", "dispatch.side",
                             "exact", "select.readback"}
    assert spans[-1].name == "select.rank"
    sides = {spans[s.parent].name for s in spans if s.name == "dispatch.side"}
    assert sides == {"screen", "exact"}
    # the second screen of the prescreen's candidates works on taken rows
    assert [s.name for s in spans if s.request == 0].count("screen") == 3


def test_search_spans_contain_their_calls_aten_events():
    engine, gal, packed = toy()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.match_scores_batch_reranked(packed, gal, **SERVE)
        time.sleep(0.002)
        engine.list_to_list(packed, gal)
    searches = [s for s in timing.recorded().spans if s.name == "search"]
    aten = [e for e in read_profile(prof) if e.name.startswith("aten::")]
    slack_us = 50.0
    hits = {id(s): 0 for s in searches}
    for e in aten:
        inside = [s for s in searches
                  if s.t0_ns / 1e3 - slack_us <= e.start_us
                  and e.end_us <= s.t1_ns / 1e3 + slack_us]
        assert len(inside) == 1, e
        hits[id(inside[0])] += 1
    assert all(hits.values())


def test_cpu_filter_counts_are_the_plain_stats():
    engine, gal, packed = toy()
    L = engine.latent_side(engine.latent_batch(packed), gal)
    minu, adc, tex = engine.block_args(L, gal, 0)
    best, bestj = ops.adc_rowmax(**adc)
    ops.minutiae_match(**minu)
    ops.texture_match(best, bestj, **tex)
    assert zero_counts(ops.filter_counts())
    with profile(activities=[ProfilerActivity.CPU]):
        ops.minutiae_match(**minu)
        ops.texture_match(best, bestj, **tex)
    assert timing.recorded().counters["filter"] == ops.filter_counts()
    got = ops.filter_counts(reset=True)
    stats = {"minutiae_match": {}, "texture_match": {}}
    ops.minutiae_match_plain(**minu, stats=stats["minutiae_match"])
    ops.texture_match_plain(best, bestj, **tex, stats=stats["texture_match"])
    for name, st in stats.items():
        k, n = st["k_valid"].long(), st["n_stage1"].long()
        assert got[name] == {"sets": k.numel(),
                             "k_valid_sq": int((k * k).sum()),
                             "n_stage1_sq": int((n * n).sum())}
        assert got[name]["k_valid_sq"] > 0 and got[name]["n_stage1_sq"] > 0
    assert zero_counts(ops.filter_counts())


def test_device_trace_writes_the_spans_on_the_profilers_clock(tmp_path):
    engine, gal, packed = toy()
    with profile(activities=[ProfilerActivity.CPU]):
        engine.latent_batch(packed)               # cleared by the trace
    with timing.device_trace(str(tmp_path)):
        engine.match_scores_batch_reranked(packed, gal, **SERVE)
    trace = json.loads((tmp_path / "trace.json").read_text())
    ev = trace["traceEvents"]
    spans = [e for e in ev if e.get("cat") == "span"]
    assert {e["name"] for e in spans} == NAMES - {"select.rank"}
    assert sum(e["name"] == "search" for e in spans) == 1
    search = next(e for e in spans if e["name"] == "search")
    aten = [e for e in ev if e.get("cat") == "cpu_op"
            and e["name"].startswith("aten::")]
    assert aten and all(search["ts"] - 50 <= e["ts"] and e["ts"] + e["dur"]
                        <= search["ts"] + search["dur"] + 50 for e in aten)
    counters = next(e for e in ev if e.get("name") == "counters")
    assert counters["args"]["filter"]["minutiae_match"]["sets"] > 0


# ---------------------------------------------------------------------------
# the benchmark's readers on canned timelines
# ---------------------------------------------------------------------------

def sp(name, t0_us, t1_us, parent=-1, request=0):
    return timing.Span(name, int(t0_us * 1e3), int(t1_us * 1e3), parent,
                       request, 0)


def canned_run(events, latents=4):
    run = H.RunView(trace=Trace(events, window_s=2e-3),
                    window=ClosedLoop(1.0))
    run.window.batches = [(0.0, 1.0, latents)]
    return run


def read(name, run):
    return H.Bench({}, BENCH).reader(name)(run)


IDLE = ("dispatch_idle_ms_per_latent", "screen_idle_ms_per_latent",
        "exact_idle_ms_per_latent", "select_idle_ms_per_latent")


def test_a_gap_goes_to_the_innermost_span_at_its_middle(monkeypatch):
    spans = [sp("search", 0, 1000), sp("screen", 100, 500, 0),
             sp("dispatch.side", 100, 200, 1), sp("exact", 520, 560, 0),
             sp("select.readback", 600, 1000, 0)]
    # gaps (µs): 110-190 mid 150 in dispatch.side (inside screen, search);
    # 300-350 in screen's own time; 400-700 mid 550 in exact; 800-1100
    # mid 950 in select.readback; 1200-1500 under no span
    busy = [(50, 110), (190, 300), (350, 400), (700, 800), (1100, 1200),
            (1500, 1600)]
    events = [Event("k", True, s, e - s) for s, e in busy]
    monkeypatch.setattr(S, "program_spans", lambda: spans)
    run = canned_run(events)
    got = {n: read(n, run) for n in IDLE}
    assert got == pytest.approx({
        "dispatch_idle_ms_per_latent": 0.080 / 4,
        "screen_idle_ms_per_latent": 0.050 / 4,
        "exact_idle_ms_per_latent": 0.300 / 4,
        "select_idle_ms_per_latent": 0.300 / 4})
    by = S.idle_by_name(run.trace.busy, spans)
    assert by[S.NO_SPAN] == pytest.approx(300e-6)
    assert sum(by.values()) == pytest.approx(1030e-6)
    assert S.idle_by_name([(0, 10), (20, 30)], [sp("search", 0, 40),
                                                sp("search", 12, 18)]) \
        == {"search": pytest.approx(10e-6)}


def test_gaps_move_onto_the_host_clock_by_the_readback_copies(monkeypatch):
    # host clock (µs): the readback's two copy calls return at 900 and 950;
    # the device timeline runs 200 µs early, so its copies end at 690, 740
    spans = [sp("search", 0, 1000), sp("dispatch.pack", 0, 100, 0),
             sp("exact", 100, 700, 0), sp("select.readback", 700, 1000, 0)]
    calls = [Event("cudaMemcpyAsync", False, 720, 180),
             Event("cudaMemcpyAsync", False, 910, 40),
             Event("cudaMemcpyAsync", False, 40, 10)]     # a copy to the card
    dtoh = "Memcpy DtoH (Device -> Pageable)"
    device = [Event("k", True, -180, 40), Event("k", True, -90, 490),
              Event(dtoh, True, 680, 10), Event(dtoh, True, 730, 10)]
    run = canned_run(calls + device)
    assert S.clock_anchors(run.trace, spans) == [(690, 210), (740, 210)]
    # raw: the gaps' middles -115, 540, 710 fall under no span, in exact,
    # in the readback; moved by 210 µs: dispatch.pack, readback, readback
    assert S.idle_by_name(run.trace.busy, spans) == pytest.approx(
        {S.NO_SPAN: 50e-6, "exact": 280e-6, "select.readback": 40e-6})
    monkeypatch.setattr(S, "program_spans", lambda: spans)
    assert {n: read(n, run) for n in IDLE} == pytest.approx({
        "dispatch_idle_ms_per_latent": 0.050 / 4,
        "screen_idle_ms_per_latent": 0.0,
        "exact_idle_ms_per_latent": 0.0,
        "select_idle_ms_per_latent": 0.320 / 4})
    # a copy call missing: the counts differ, no offset is applied
    assert S.clock_anchors(canned_run(calls[1:] + device).trace, spans) == []


def test_readers_report_nothing_without_the_programs_spans(monkeypatch):
    events = [Event("k", True, 0, 10), Event("k", True, 20, 10)]
    monkeypatch.setattr(S, "program_spans", lambda: None)
    monkeypatch.setattr(S, "program_filter_counts", lambda: None)
    run = canned_run(events)
    assert all(read(n, run) is None for n in IDLE
               + ("exact_roofline_counted",))
    # no device work (a CPU run): nothing to charge
    monkeypatch.setattr(S, "program_spans", lambda: [sp("search", 0, 40)])
    assert read("dispatch_idle_ms_per_latent",
                canned_run([Event("aten::mm", False, 0, 10)])) is None


def test_counted_roofline_adds_the_filters_operations(monkeypatch):
    rowmax = "void afis_screen::screen_tc_kernel<afis_screen::CopyTC<signed " \
        "char, false>, afis_screen::ArgRows<__nv_bfloat16> >(...)"
    events = [Event(rowmax, True, 0.0, 300.0),
              Event("void minutiae_match_kernel<bf16, bf16>(...)", True,
                    400.0, 500.0),
              Event("texture_match_kernel(...)", True, 950.0, 200.0)]
    counts = {"minutiae_match": {"sets": 3, "k_valid_sq": 3 * 120 ** 2,
                                 "n_stage1_sq": 3 * 10 ** 2},
              "texture_match": {"sets": 2, "k_valid_sq": 2 * 200 ** 2,
                                "n_stage1_sq": 2 * 30 ** 2}}
    monkeypatch.setattr(S, "program_filter_counts", lambda: counts)
    cfg = json.loads((BENCH / "configs" / "g100k_448.json").read_text())
    mix = json.loads((BENCH / "mixes" / "serve.json").read_text())
    run = canned_run(events)
    run.config, run.mix = cfg, mix
    ops_ = (3 * 120 ** 2 * 36 + 56 * 3 * 10 ** 2
            + 2 * 200 ** 2 * 32 + 56 * 2 * 30 ** 2)
    assert S.filter_ops(counts) == ops_
    least = bound_s(Shapes(cfg, mix).exact_batch()) + ops_ / PEAK_F32
    got = read("exact_roofline_counted", run)
    assert got == pytest.approx(100.0 * least / 1000e-6)
    assert got > read("exact_roofline", run)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_card_filter_counts_equal_the_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    engine, gal, packed = toy("cuda")
    L = engine.latent_side(engine.latent_batch(packed), gal)
    want = {"minutiae_match": {}, "texture_match": {}}
    got = {}
    for a in range(0, gal.size, engine.block_size):
        minu, adc, tex = engine.block_args(L, gal, a)
        best, bestj = ops.adc_rowmax(**adc)
        quiet = (ops.minutiae_match(**minu),
                 ops.texture_match(best, bestj, **tex))
        assert zero_counts(ops.filter_counts())
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            counted = (ops.minutiae_match(**minu),
                       ops.texture_match(best, bestj, **tex))
            torch.cuda.synchronize()
        assert all(torch.equal(q, c) for q, c in zip(quiet, counted))
        for name, c in ops.filter_counts(reset=True).items():
            for key, v in c.items():
                got.setdefault(name, {}).setdefault(key, 0)
                got[name][key] += v
        st_m, st_t = {}, {}
        ops.minutiae_match_plain(**minu, stats=st_m)
        ops.texture_match_plain(best, bestj, **tex, stats=st_t)
        for name, st in (("minutiae_match", st_m), ("texture_match", st_t)):
            k, n = st["k_valid"].long(), st["n_stage1"].long()
            w = want[name]
            w["sets"] = w.get("sets", 0) + k.numel()
            w["k_valid_sq"] = w.get("k_valid_sq", 0) + int((k * k).sum())
            w["n_stage1_sq"] = w.get("n_stage1_sq", 0) + int((n * n).sum())
    assert got == want
    assert all(c["n_stage1_sq"] > 0 for c in got.values())
