"""exact_roofline: the exact group's least time (``work.Shapes``'s
operations and bytes of each batch's minutiae_match, ADC row maximum and
texture_match launches, at the peak of the configuration's operand types)
over its device time in the traced window, in per cent. The graph
filter's work is not counted yet, so this share reads low."""
from afis_bench.kernels import device_seconds
from afis_bench.work import Shapes, bound_s


def read(run):
    if run.trace is None:
        return None
    s = device_seconds(run.trace, "exact")
    work = Shapes(run.config, run.mix).exact_batch()
    if s <= 0 or not work:
        return None
    return 100.0 * bound_s(work) * len(run.window.batches) / s
