"""Run one benchmark cell once, from the root of a checkout:

    python3 afis_bench/run.py --workload <config>.<mix> --seed N \
        --seconds S --trace 0|1

Prints one JSON line (the result) as the last line of standard output and
the numbers that decide ``correct``, each beside its limit, as the last
lines of standard error. Exits 2 without a result where torch sees fewer
CUDA devices than the cell asks for.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from afis_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t0=T0))
