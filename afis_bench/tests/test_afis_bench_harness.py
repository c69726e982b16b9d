"""The benchmark's harness on the CPU, at toy sizes: discovery by name,
the window's arithmetic, the trace's, the refusal without a card and the
isolation from JAX and from the program.

    python -m pytest afis_bench/tests -q
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from afis_bench import harness as H
from afis_bench.trace import Event, Trace
from afis_bench.window import ClosedLoop
from afis_bench.work import Shapes, bound_s

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "afis_bench"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def toy_bench(tmp_path: Path, mixes=("serve",), extra_metric: bool = False):
    """A copy of the benchmark's folder with a toy configuration, toy
    mixes, their limits and (``extra_metric``) a toy metric, each added as
    a new file; and a BENCHMARK.json naming them."""
    base = tmp_path / "afis_bench"
    shutil.copytree(BENCH, base, ignore=shutil.ignore_patterns(
        "_cache", "_archive", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((base / "configs" / "g100k_448.json").read_text())
    cfg.update(gallery=60, Rm=24, Rt=48, latent={"T": 3, "Lm": 16, "Lt": 40})
    cfg["modes"]["block"] = 8
    (base / "configs" / "toy.json").write_text(json.dumps(cfg))
    cells = []
    for name in mixes:
        mix = json.loads((base / "mixes" / f"{name}.json").read_text())
        mix.update(batch=4, pool=8, m=16, check_latents=3)
        if mix.get("prescreen"):
            mix["prescreen"] = {"k": 16, "lt": 8, "t": 1}
        if mix["entry"] == "list_to_list":
            mix["check_entries"] = 32
        (base / "mixes" / f"toy{name}.json").write_text(json.dumps(mix))
        cell = f"toy.toy{name}"
        (base / "limits" / f"{cell}.json").write_text(json.dumps(
            {"score_wrong": 0.0, "rank_wrong": 0.0, "kept_wrong": 0.0}))
        spec["workloads"].append({"name": cell, "config": "toy",
                                  "traffic": f"toy{name}", "chips": 1,
                                  "why": "toy"})
        cells.append(cell)
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.pop("workloads", None)
    if extra_metric:
        (base / "metrics" / "toy_batches.py").write_text(
            "def read(run):\n    return float(len(run.window.batches))\n")
        spec["end_to_end"].append({
            "name": "toy_batches", "unit": "batches", "better": "higher",
            "bound": 0.25, "source": "host_clock"})
    return H.Bench(spec, base), cells


def test_discovery_finds_new_config_mix_and_metric(tmp_path):
    bench, (cell,) = toy_bench(tmp_path, extra_metric=True)
    out = H.run_cell(bench, cell, 2 ** 31 + 12345, 0.5, False, "cpu")
    assert out["correct"] is True
    assert out["failed"] == 0 and out["attempted"] > 0
    m = out["metrics"]
    assert m["toy_batches"]["value"] >= 1 and m["toy_batches"]["unit"] \
        == "batches"
    assert m["search_rate"]["value"] > 0 and "setup_s" in m
    assert list(out["check"]) == ["score_wrong", "rank_wrong",
                                  "kept_wrong", "failed"]


@pytest.mark.parametrize("mix", ["dense", "certified"])
def test_every_mix_runs_and_is_correct(tmp_path, mix):
    bench, (cell,) = toy_bench(tmp_path, mixes=(mix,))
    out = H.run_cell(bench, cell, 7, 0.2, False, "cpu")
    assert out["correct"] is True, out["check"]


def test_trace_run_reports_per_layer_metrics(tmp_path):
    bench, (cell,) = toy_bench(tmp_path)
    out = H.run_cell(bench, cell, 3, 0.2, True, "cpu")
    # no device on the CPU: the device readers read nothing, the gallery's
    # layout is a count and is there
    assert set(out["metrics"]) == {"gallery_bytes_per_entry"}
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


class ScriptedClock:
    """A host clock that advances by the scripted batch times."""

    def __init__(self, batch_s):
        self.t = 100.0
        self.batch_s = list(batch_s)
        self.calls = 0

    def __call__(self):
        return self.t

    def submit(self, b):
        self.t += self.batch_s[b]
        return 8


def test_window_rate_and_tail_move_with_a_stall():
    even = ScriptedClock([0.0625] * 1000)          # exact in binary
    w0 = ClosedLoop(10.0, even).run(even.submit)
    assert len(w0.batches) == 160
    assert w0.window_s == 10.0
    assert w0.rate == pytest.approx(128.0)
    assert w0.percentile_ms(95) == pytest.approx(62.5)
    stalled = [0.0625] * 1000
    for b in range(80, 92):
        stalled[b] = 0.5                         # a stall in the middle
    s = ScriptedClock(stalled)
    w1 = ClosedLoop(10.0, s).run(s.submit)
    # the window closes at the first batch to finish after 10 s
    assert w1.window_s >= 10.0 and w1.window_s - 0.0625 < 10.0
    assert w1.latents == 8 * len(w1.batches)
    assert w1.rate == pytest.approx(w1.latents / w1.window_s)
    assert w1.rate < 0.7 * w0.rate
    assert w1.percentile_ms(95) == pytest.approx(500.0)


def test_idle_share_and_rooflines_on_a_canned_table():
    screen = "void afis_screen::screen_tc_kernel<afis_screen::CopyTC<signed " \
        "char, false>, afis_screen::LatRows<__nv_bfloat16> >(...)"
    rowmax = "void afis_screen::screen_tc_kernel<afis_screen::CopyTC<signed " \
        "char, false>, afis_screen::ArgRows<__nv_bfloat16> >(...)"
    ev = [Event(screen, True, 0.0, 400.0),
          Event(screen, True, 300.0, 200.0),       # overlaps: counted once
          Event(rowmax, True, 600.0, 100.0),
          Event("Memcpy DtoH (Device -> Pinned)", True, 800.0, 50.0),
          Event("aten::sort", False, 690.0, 150.0),
          Event("cudaLaunchKernel", False, 510.0, 80.0)]
    tr = Trace(ev, window_s=1e-3)
    assert tr.busy_s == pytest.approx(650e-6)
    assert tr.idle_share == pytest.approx(0.35)
    assert tr.kernel_launches == 3
    assert tr.idle_gaps() == [["cudaLaunchKernel", pytest.approx(100e-6)],
                              ["aten::sort", pytest.approx(100e-6)]]
    assert tr.device_ops()[0] == [screen, pytest.approx(600e-6)]
    from afis_bench.kernels import device_seconds, group_of
    assert group_of(screen) == "screen" and group_of(rowmax) == "exact"
    assert device_seconds(tr, "select", kernels_only=False) \
        == pytest.approx(50e-6)
    cfg = json.loads((BENCH / "configs" / "g100k_448.json").read_text())
    mix = json.loads((BENCH / "mixes" / "serve.json").read_text())
    sh = Shapes(cfg, mix)
    minu, adc = sh.screen_batch()
    # 2 NT G P R D and 2 NL G Lt Rt D at bf16's peak (bf16 x int8 too)
    assert minu[0] == 2.0 * 8 * 100000 * 64 * 96 * 96
    assert adc[0] == 2.0 * 8 * 100000 * 64 * 448 * 96
    assert minu[2] == adc[2] == 989e12
    assert adc[1] > 100000 * 448 * 96            # the int8 gallery, once
    t = bound_s(sh.screen_batch())
    assert t == pytest.approx(minu[0] / 989e12 + adc[0] / 989e12)
    reader = H.Bench({}, BENCH).reader("screen_roofline")
    run = H.RunView(trace=tr, config=cfg, mix=mix,
                    window=ClosedLoop(1.0))
    run.window.batches = [(0.0, 1.0, 8)]
    assert reader(run) == pytest.approx(100.0 * t / 600e-6)


@pytest.mark.parametrize("mix", ["serve", "dense", "certified"])
def test_check_judges_a_latent_of_every_batch_slot(mix):
    """With as many latents judged as a batch holds, every slot of the
    batch is judged, on every seed, and only latents that were answered."""
    from afis_bench import check as C
    from afis_bench.gen import batch_order
    m = json.loads((BENCH / "mixes" / f"{mix}.json").read_text())
    pool, batch, n = int(m["pool"]), int(m["batch"]), int(m["check_latents"])
    assert n >= batch
    for seed in [0, 7, 2 ** 31 + 5, 987654321987] + list(range(100, 140)):
        order = batch_order(pool, seed)
        slot = {int(e): p % batch for p, e in enumerate(order)}
        for answered in (list(range(pool)),
                         [int(e) for e in order[:3 * batch]]):
            got = C.sample_latents(answered, n, seed, pool, batch)
            assert len(set(got)) == n and set(got) <= set(answered)
            assert {slot[i] for i in got} == set(range(batch))
            assert got == C.sample_latents(answered, n, seed, pool, batch)


def test_a_prescreen_that_would_screen_twice_is_refused(tmp_path):
    """A prescreen keeping more candidates than m_pad would add a second
    screen, which neither the rooflines nor the reference model."""
    bench, (cell,) = toy_bench(tmp_path)
    p = bench.base / "mixes" / "toyserve.json"
    m = json.loads(p.read_text())
    m["prescreen"]["k"] = 24          # k1 24 > m_pad 16 at block 8
    p.write_text(json.dumps(m))
    with pytest.raises(ValueError, match="second screen"):
        H.run_cell(bench, cell, 1, 0.1, False, "cpu")


def test_run_refuses_without_a_card(tmp_path):
    """No card (as here): exit other than 0 and no result line; the same
    in a directory that holds only BENCHMARK.json and the benchmark."""
    for cwd in (ROOT, tmp_path):
        if cwd == tmp_path:
            shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
            shutil.copytree(BENCH, tmp_path / "afis_bench",
                            ignore=shutil.ignore_patterns("_cache",
                                                          "__pycache__"))
        p = subprocess.run(
            [sys.executable, "afis_bench/run.py", "--workload",
             "g100k_448.serve", "--seed", "3", "--seconds", "1",
             "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, timeout=300)
        assert p.returncode != 0
        assert '"correct"' not in p.stdout


def test_no_jax_after_a_toy_pass(tmp_path):
    """A toy pass through the harness and the reference in a fresh
    process leaves no module whose top-level name is a JAX name or the
    JAX package's (the port's name only begins with it)."""
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "sys.path.insert(0, %r)\n"
        "from test_afis_bench_harness import toy_bench\n"
        "from pathlib import Path\n"
        "from afis_bench import harness as H\n"
        "b, (c,) = toy_bench(Path(%r))\n"
        "out = H.run_cell(b, c, 5, 0.2, False, 'cpu')\n"
        "assert out['correct'], out\n"
        "print(json.dumps(sorted(sys.modules)))\n"
        % (str(ROOT), str(Path(__file__).parent), str(tmp_path)))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    mods = json.loads(p.stdout.strip().splitlines()[-1])
    top = {m.split(".")[0] for m in mods}
    assert "msu_latentafis_tpu_torch" in top
    assert not top & set(H.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import afis_bench.reference, afis_bench.check, afis_bench.gen\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
            % str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    top = p.stdout.strip().splitlines()[-1]
    assert "msu_latentafis_tpu" not in top          # neither package
    assert "jax" not in top
