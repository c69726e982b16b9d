"""screen_roofline: the screen group's least time (``work.Shapes``'s
operations and bytes of each window batch's screens, counted from the
latents the batch carried, at the peak of the configuration's operand
types) over its device time in the traced window, in per cent."""
from afis_bench.kernels import device_seconds
from afis_bench.work import Shapes, window_least_s


def read(run):
    if run.trace is None:
        return None
    s = device_seconds(run.trace, "screen")
    least = window_least_s(Shapes(run.config, run.mix), run.window_latents(),
                           "screen")
    if s <= 0 or not least:
        return None
    return 100.0 * least / s
