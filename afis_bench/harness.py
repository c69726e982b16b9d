"""The benchmark's harness: one cell, one seed, one run.

A cell ``<config>.<mix>`` is an entry of ``BENCHMARK.json``'s
``workloads``; the harness finds its files by name:
``configs/<config>.json`` (the deployment: sizes and modes),
``mixes/<mix>.json`` (the traffic), ``limits/<cell>.json`` (the limit of
each number that decides ``correct``) and ``metrics/<metric>.py`` (one
reader per metric, ``read(run) -> float or None``). Adding a cell, a mix,
a configuration or a metric adds files and entries; no file here changes.

A run: set-up (the kernels through the program's build, the gallery drawn
on the device from the seed and stored by the engine's own steps, the
pool of latents, the warm-up of the cell's shapes), the window (a closed
loop, ``window.ClosedLoop``; under ``torch.profiler`` with ``--trace 1``),
then the check against the reference (``check.py``) once the program's
state is freed, and one JSON line.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "msu_latentafis_tpu")
MINU_INT8_SCALE = 1.73 / 127.0 + 1e-12   # the synthetic gallery's fixed scale
CACHE = HERE / "_cache"


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is a JAX name or the JAX
    package's (compared whole: the port's name only begins with it)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Bench:
    """``BENCHMARK.json`` and the folder of files its names point to."""

    def __init__(self, spec: dict, base: Path = HERE):
        self.spec = spec
        self.base = Path(base)

    @classmethod
    def load(cls, path: Path = ROOT / "BENCHMARK.json") -> "Bench":
        return cls(load_json(path))

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return load_json(self.base / "configs" / f"{name}.json")

    def mix(self, name: str) -> dict:
        return load_json(self.base / "mixes" / f"{name}.json")

    def limits(self, cell: str) -> dict:
        return load_json(self.base / "limits" / f"{cell}.json")

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        """The metrics this cell reports in this kind of run."""
        group = self.spec["per_layer"] if trace else self.spec["end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, name: str):
        path = self.base / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            "afis_bench_metric_" + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


class RunView:
    """What a metric reader reads: the window, the set-up, the memory, the
    trace (``trace.Trace`` or None), the cell's files and the sizes of the
    latents each window batch carried (``batch_latents``: a list of
    ``work.LatentSize`` a batch; None where a view was built without
    them)."""

    batch_latents = None

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def window_latents(self) -> list:
        """``batch_latents``, or where the view has none, full latents
        (None) for each batch of the window."""
        if self.batch_latents is None:
            return [None] * len(self.window.batches)
        return self.batch_latents


# ---------------------------------------------------------------------------
# the system under test
# ---------------------------------------------------------------------------

def packed_sizes(minu_n, tex_n) -> tuple:
    """The axes the program's packer (``templates/packing.pack_latent``)
    gives a latent of these counts: minutiae ``_round_up(max count, 8)``
    (at least 8), texture ``_round_up(tex_n, 8)`` (8 where there is
    none)."""
    def up8(n: int) -> int:
        return -(-max(int(n), 1) // 8) * 8
    return up8(max(int(n) for n in minu_n)), up8(tex_n)


class Program:
    """The port, set up for one cell: its engine, the gallery stored from
    the draws by the engine's own steps, and the pool as packed latents,
    each at the sizes the program's packer gives it (``packed_sizes``);
    a batch is handed over as it comes, latents of unequal sizes
    included."""

    def __init__(self, config: dict, mix: dict, draws, device):
        import torch
        from msu_latentafis_tpu_torch.matcher.engine import (DeviceGallery,
                                                             MatchEngine)
        from msu_latentafis_tpu_torch.matcher.graph_filter import coord_pack
        from msu_latentafis_tpu_torch.matcher.texture_match import decode_pq
        from msu_latentafis_tpu_torch.templates.packing import PackedLatent

        from .gen import CHUNK

        self.mix = mix
        modes = config["modes"]
        if modes["compute_dtype"] != "bfloat16":
            raise ValueError(f"compute_dtype {modes['compute_dtype']}: "
                             f"every configuration computes in bfloat16")
        cdt = torch.bfloat16
        self.engine = E = MatchEngine(
            draws.codebook, block_size=int(modes["block"]), compute_dtype=cdt,
            row_cap=int(modes["row_cap"]),
            codes_resident=bool(modes["codes_resident"]),
            tex_int8=bool(modes["tex_int8"]),
            minu_int8=bool(modes["minu_int8"]), device=device)
        Gp, Rm, Rt, D, S = draws.Gp, draws.Rm, draws.Rt, draws.D, draws.S
        dev = E.device
        f32 = dict(dtype=torch.float32, device=dev)
        scale = MINU_INT8_SCALE if E.minu_int8 else None
        t = dict(
            minu_des=torch.empty((Gp, Rm, D), dtype=torch.int8
                                 if E.minu_int8 else cdt, device=dev),
            minu_pack=torch.empty((Gp, Rm, 4), **f32),
            minu_n=torch.empty((Gp,), dtype=torch.int32, device=dev),
            tex_sqnorm=torch.empty((Gp, Rt), **f32),
            tex_pack=torch.empty((Gp, Rt, 4), **f32),
            tex_n=torch.empty((Gp,), dtype=torch.int32, device=dev))
        codes_resident = not E.should_predecode(Gp, Rt)
        if codes_resident:
            t["tex_codes"] = torch.empty((Gp, Rt, S), dtype=torch.uint8,
                                         device=dev)
        else:
            t["tex_dec"] = torch.empty((Gp, Rt, D), dtype=E.tex_dec_dtype,
                                       device=dev)
        minu_scale = None
        for c in range(draws.n_chunks):
            rows = draws.chunk(c)
            sl = slice(c * CHUNK, c * CHUNK + rows["minu_n"].shape[0])
            t["minu_des"][sl], minu_scale = E.minutiae_storage(
                rows["minu_des"], scale)
            t["minu_pack"][sl] = coord_pack(rows["minu_xy"], rows["minu_ori"])
            t["minu_n"][sl] = rows["minu_n"]
            codes = rows["tex_codes"]
            if codes_resident:
                t["tex_codes"][sl] = codes
            else:
                t["tex_dec"][sl] = E.predecode(codes)
            dec = decode_pq(codes, E.codebook_t)
            t["tex_sqnorm"][sl] = (dec * dec).sum(dim=2)
            t["tex_pack"][sl] = coord_pack(rows["tex_xy"], rows["tex_ori"])
            t["tex_n"][sl] = rows["tex_n"]
            del rows, dec
        self.gallery = DeviceGallery(
            names=[str(i) for i in range(draws.G)], n_real=draws.G,
            minu_scale=minu_scale, **t)
        lat = {k: v.cpu().numpy() for k, v in draws.latents.items()}
        self.latents = []
        for i in range(draws.pool):
            lm, lt = packed_sizes(lat["minu_n"][i], lat["tex_n"][i])
            a = {k: np.ascontiguousarray(lat[k][i][:, :lm]) for k in
                 ("minu_des", "minu_xy", "minu_ori")}
            a.update({k: np.ascontiguousarray(lat[k][i][:lt]) for k in
                      ("tex_des", "tex_xy", "tex_ori")})
            self.latents.append(PackedLatent(
                minu_n=lat["minu_n"][i], tex_n=lat["tex_n"][i],
                name=f"latent{i}", **a))

    def gallery_bytes(self) -> int:
        g = self.gallery
        return sum(x.numel() * x.element_size() for x in
                   (getattr(g, f) for f in g.TENSORS) if x is not None)

    def search(self, pool_idx: List[int]) -> Dict[int, dict]:
        """One batch through the mix's entry; the answers, keyed by pool
        latent, that reached the host."""
        lats = [self.latents[i] for i in pool_idx]
        mix, E, gal = self.mix, self.engine, self.gallery
        out = {}
        if mix["entry"] == "list_to_list":
            for i, r in zip(pool_idx, E.list_to_list(lats, gal)):
                top = np.array([int(name) for name, _ in
                                r.ranked(int(mix["top"]))], np.int64)
                out[i] = dict(scores=r.scores, top=top)
            return out
        pre = mix.get("prescreen") or {}
        idx, exact, _, _ = E.match_scores_batch_reranked(
            lats, gal, m=int(mix["m"]), prescreen_k=int(pre.get("k", 0)),
            prescreen_lt=int(pre.get("lt", 0)),
            prescreen_t=int(pre.get("t", 0)))
        order = np.argsort(-exact, axis=1, kind="stable")[:, :int(mix["top"])]
        top = np.take_along_axis(idx, order, axis=1)
        for j, i in enumerate(pool_idx[:len(idx)]):
            out[i] = dict(kept=idx[j], exact=exact[j], top=top[j])
        return out


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def batches(pool: int, batch: int, seed: int) -> Callable[[int], List[int]]:
    """Batch b's pool latents: a seeded order of the pool, cycled."""
    from .gen import batch_order
    order = batch_order(pool, seed)
    return lambda b: [int(order[(b * batch + k) % pool]) for k in range(batch)]


def refuse_second_screen(config: dict, mix: dict) -> None:
    """A prescreen keeps k1 = max(block, k // block * block) candidates;
    where they outnumber the m_pad kept, the engine screens them again with
    the full latent, a stage that neither the rooflines nor the reference
    model: such a mix is refused."""
    from .reference import kept_count
    k = int((mix.get("prescreen") or {}).get("k", 0))
    block = int(config["modes"]["block"])
    Gp = -(-int(config["gallery"]) // block) * block
    if k and max(block, k // block * block) > kept_count(
            Gp, int(mix["m"]), block):
        raise ValueError(f"prescreen k {k} keeps more candidates than the "
                         f"m_pad the mix scores: a second screen, which "
                         f"the benchmark does not model")


def run_cell(bench: Bench, cell: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t0: Optional[float] = None,
             clock: Callable[[], float] = time.perf_counter,
             program: Callable = Program, log=print) -> dict:
    """One run of ``cell``; returns the result line's object."""
    import torch
    from . import check as C
    from . import reference as R
    from .gen import Draws
    from .trace import Trace, read_profile
    from .window import ClosedLoop
    from .work import latent_sizes

    t0 = clock() if t0 is None else t0
    w = bench.cell(cell)
    config, mix = bench.config(w["config"]), bench.mix(w["traffic"])
    if mix["loop"] != "closed" or int(mix["clients"]) != 1:
        raise ValueError(f"{w['traffic']}: the harness drives one client "
                         f"in a closed loop")
    refuse_second_screen(config, mix)
    limits = bench.limits(cell)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        from msu_latentafis_tpu_torch.matcher.kernels import _build
        _build.load()
    draws = Draws(config, int(mix["pool"]), seed, device)
    prog = program(config, mix, draws, device)
    gallery_bytes, gallery_entries = prog.gallery_bytes(), draws.Gp
    batch_of = batches(draws.pool, int(mix["batch"]), seed)
    sizes = latent_sizes(draws.latents["minu_n"].cpu().numpy(),
                         draws.latents["tex_n"].cpu().numpy())

    def sync():
        if cuda:
            torch.cuda.synchronize()
    warm = int(mix["warmup_batches"])
    for b in range(warm):
        prog.search(batch_of(b))          # the window goes on from here
    sync()
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    answers: Dict[int, dict] = {}
    attempted = [0]
    carried: List[List[int]] = []

    def submit(b: int) -> int:
        carried.append(batch_of(warm + b))
        got = prog.search(carried[-1])
        attempted[0] += int(mix["batch"])
        answers.update(got)
        return len(got)

    loop = ClosedLoop(seconds, clock)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
    setup_s = clock() - t0
    loop.run(submit)
    sync()
    if prof is not None:
        prof.__exit__(None, None, None)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_modules()
    run = RunView(
        window=loop, setup_s=setup_s, window_peak_bytes=window_peak,
        gallery_bytes=gallery_bytes, gallery_entries=gallery_entries,
        config=config, mix=mix,
        batch_latents=[[sizes[i] for i in b] for b in carried],
        trace=Trace(read_profile(prof), loop.window_s) if prof else None)
    del prof, prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    metrics = {}
    for m in bench.metrics(cell, trace):
        v = bench.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    t_check = time.perf_counter()
    prec = R.Precision(config["modes"])
    checked = C.sample_latents(list(answers), int(mix["check_latents"]),
                               seed, draws.pool, int(mix["batch"]))
    details: List[str] = []
    numbers = C.judge(draws, mix, prec, answers, checked, seed, details)
    for line in details:
        log(f"afis_bench: score off the reference: {line}", file=sys.stderr)
    log(f"afis_bench: the check took {time.perf_counter() - t_check:.1f} s",
        file=sys.stderr)
    failed = attempted[0] - loop.latents
    correct = C.verdict(numbers, limits, failed) and not found
    out = {"correct": bool(correct), "attempted": attempted[0],
           "failed": failed, "metrics": metrics,
           "device": device_record(torch, cuda, max(setup_peak, window_peak))}
    if run.trace is not None:
        out["device"].update(busy_s=run.trace.busy_s,
                             window_s=run.trace.window_s)
        out["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["check"] = {k: {"value": v, "limit": limits[k]}
                    for k, v in numbers.items()}
    out["check"]["failed"] = {"value": failed, "limit": 0}
    out["forbidden_modules"] = found
    return out


def device_record(torch, cuda: bool, peak: int) -> dict:
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(peak)}


def parse(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    set_cache_dirs()
    bench = Bench.load()
    w = bench.cell(args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(w["chips"]):
        print(f"afis_bench: {args.workload} needs {w['chips']} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import msu_latentafis_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"afis_bench: the program is not in this checkout ({e})",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda", t0=t0)
    found = out.pop("forbidden_modules")
    if found or forbidden_modules():
        print("afis_bench: JAX or the JAX package was loaded: "
              + ", ".join(found or forbidden_modules()), file=sys.stderr)
        return 4
    for k, v in out["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
