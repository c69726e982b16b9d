"""The two readings each limit of ``limits/<cell>.json`` is set from, in
one process on the card:

    python3 afis_bench/readings.py --workload <cell> --seeds 1,2,... \
        --control-seeds 101,102,103 [--seconds S]

For every seed of ``--seeds`` a short run of the cell (the program, its
window of S seconds and the check, as ``run.py`` makes them) gives the
numbers of sound runs; for every seed of ``--control-seeds`` the control
(the reference in the program's place, its operands one step below the
configuration's) is judged on as many latents as a run judges. Prints one
JSON line a seed, then the lower reading (the largest of the sound runs)
and the upper reading (the smallest of the control's) of each number.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse
    import json

    import torch

    from afis_bench import check as C
    from afis_bench import harness as H
    from afis_bench import reference as R
    from afis_bench.gen import Draws

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    H.set_cache_dirs()
    bench = H.Bench.load()
    w = bench.cell(args.workload)
    config, mix = bench.config(w["config"]), bench.mix(w["traffic"])
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = [int(s) for s in args.control_seeds.split(",") if s]
    sound, control = [], []
    for s in seeds:
        out = H.run_cell(bench, args.workload, s, args.seconds, False)
        nums = {k: v["value"] for k, v in out["check"].items()}
        torch.cuda.empty_cache()
        sound.append(nums)
        print(json.dumps({"sound": s, **nums,
                          "metrics": {k: v["value"] for k, v in
                                      out["metrics"].items()}}), flush=True)
    for s in ctl:
        d = Draws(config, int(mix["pool"]), s, "cuda")
        lats = C.sample_latents(list(range(d.pool)),
                                int(mix["check_latents"]), s, d.pool,
                                int(mix["batch"]))
        ans = C.control_answers(d, mix, R.Precision(config["modes"], True),
                                lats, s)
        nums = C.judge(d, mix, R.Precision(config["modes"]), ans, lats, s)
        control.append(nums)
        print(json.dumps({"control": s, **nums}), flush=True)
        del d, ans
        torch.cuda.empty_cache()
    keys = sorted({k for n in sound + control for k in n if k != "failed"})
    print(json.dumps({"cell": args.workload, "lower": {
        k: max(n[k] for n in sound) for k in keys if sound}, "upper": {
        k: min(n[k] for n in control) for k in keys if control}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
