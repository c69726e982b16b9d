"""The comparison that decides ``correct`` fails where it should, on the
CPU at a toy size: the control (the reference in the program's place,
its operands one step below the configuration's: bf16 -> fp8, int8 ->
int4) on three seeds, and a run whose timed path is broken underneath,
once for each fault a search cell can have: answers left unchanged from
the batch before (a step that returns its state unchanged), half of each
batch left out, and one answer altered where it is produced. The card's
readings of the same (``readings.py``) set the limits; see PERF.md.

    python -m pytest afis_bench/tests -q
"""
import json

import numpy as np
import pytest
import torch

from afis_bench import check as C
from afis_bench import harness as H
from afis_bench import reference as R
from afis_bench.gen import Draws

from test_afis_bench_harness import toy_bench


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def limits_of(cell: str) -> dict:
    return json.loads((H.HERE / "limits" / f"{cell}.json").read_text())


@pytest.mark.parametrize("mix", ["serve", "dense", "certified"])
@pytest.mark.parametrize("cap", [False, True])
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 5, 987654321987])
def test_control_is_not_correct(tmp_path, mix, cap, seed):
    bench, (cell,) = toy_bench(tmp_path, mixes=(mix,))
    w = bench.cell(cell)
    config, mx = bench.config(w["config"]), bench.mix(w["traffic"])
    if cap:
        config["modes"].update(tex_int8=False, minu_int8=True,
                               codes_resident=True)
    d = Draws(config, int(mx["pool"]), seed, "cpu")
    lats = C.sample_latents(list(range(d.pool)), int(mx["check_latents"]),
                            seed, d.pool, int(mx["batch"]))
    ans = C.control_answers(d, mx, R.Precision(config["modes"], True), lats,
                            seed)
    nums = C.judge(d, mx, R.Precision(config["modes"]), ans, lats, seed)
    real = "g100k_448.dense" if mix == "dense" else "g100k_448.serve"
    assert not C.verdict(nums, limits_of(real), 0), nums


class Stale(H.Program):
    """Answers each batch with the answers of the batch before."""
    last = None

    def search(self, pool_idx):
        got = super().search(pool_idx)
        prev, Stale.last = Stale.last, list(got.values())
        if prev is None:
            return got
        return dict(zip(pool_idx, prev))


class HalfBatch(H.Program):
    """Leaves the second half of every batch out."""

    def search(self, pool_idx):
        got = super().search(pool_idx)
        return {i: got[i] for i in pool_idx[:len(pool_idx) // 2]}


class Altered(H.Program):
    """Alters one answer of every batch where it is produced: the list of
    the latent in batch slot ``slot`` reversed, its scores nudged."""
    slot = 0

    def search(self, pool_idx):
        got = super().search(pool_idx)
        a = got[pool_idx[self.slot]]
        a["top"] = a["top"][::-1].copy()
        key = "exact" if "exact" in a else "scores"
        a[key] = a[key] + 1e-2
        return got


@pytest.mark.parametrize("fault", [Stale, HalfBatch, Altered])
@pytest.mark.parametrize("mix", ["serve", "dense"])
def test_broken_timed_path_is_not_correct(tmp_path, fault, mix):
    bench, (cell,) = toy_bench(tmp_path, mixes=(mix,))
    # every answer judged, so that one altered answer cannot hide
    spec_mix = bench.base / "mixes" / f"toy{mix}.json"
    m = json.loads(spec_mix.read_text())
    m.update(check_latents=8, pool=8)
    spec_mix.write_text(json.dumps(m))
    real = "g100k_448.dense" if mix == "dense" else "g100k_448.serve"
    (bench.base / "limits" / f"{cell}.json").write_text(
        json.dumps(limits_of(real)))
    Stale.last = None
    out = H.run_cell(bench, cell, 5, 1.0, False, "cpu", program=fault)
    assert out["correct"] is False, out["check"]
    sound = H.run_cell(bench, cell, 5, 1.0, False, "cpu")
    assert sound["correct"] is True, sound["check"]


@pytest.mark.parametrize("slot", range(4))
def test_fault_in_one_batch_slot_is_not_correct(tmp_path, slot):
    """A fault confined to one slot of every batch fails ``correct``
    whichever slot it sits in, with fewer latents judged than the pool
    holds (one drawn from each slot)."""
    bench, (cell,) = toy_bench(tmp_path)
    spec_mix = bench.base / "mixes" / "toyserve.json"
    m = json.loads(spec_mix.read_text())
    m.update(pool=16, check_latents=m["batch"])
    spec_mix.write_text(json.dumps(m))
    (bench.base / "limits" / f"{cell}.json").write_text(
        json.dumps(limits_of("g100k_448.serve")))
    fault = type(f"AlteredSlot{slot}", (Altered,), {"slot": slot})
    out = H.run_cell(bench, cell, 2 ** 31 + 77 + slot, 1.0, False, "cpu",
                     program=fault)
    assert out["correct"] is False, out["check"]
