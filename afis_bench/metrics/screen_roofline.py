"""screen_roofline: the screen group's least time (``work.Shapes``'s
operations and bytes of each batch's screens, at the peak of the
configuration's operand types) over its device time in the traced window,
in per cent."""
from afis_bench.kernels import device_seconds
from afis_bench.work import Shapes, bound_s


def read(run):
    if run.trace is None:
        return None
    s = device_seconds(run.trace, "screen")
    work = Shapes(run.config, run.mix).screen_batch()
    if s <= 0 or not work:
        return None
    return 100.0 * bound_s(work) * len(run.window.batches) / s
