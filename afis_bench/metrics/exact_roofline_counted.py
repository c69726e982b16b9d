"""exact_roofline_counted: ``exact_roofline``'s least time plus the graph
filter's operations, counted by the exact layer's kernels over the traced
window (``ops.filter_counts``: k_valid^2 (26 + 2 iters) + 56 n_stage1^2 a
set, at the f32 peak), over the exact group's device time, in per cent;
``afis_bench.spans``."""
from afis_bench.spans import exact_roofline_counted


def read(run):
    return exact_roofline_counted(run)
