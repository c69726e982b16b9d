"""screen_ms_per_latent: device time of the screen group's kernels
(``kernels.SCREEN``) per latent completed, in the traced window."""
from afis_bench.kernels import device_seconds


def read(run):
    if run.trace is None:
        return None
    s = device_seconds(run.trace, "screen")
    return s * 1e3 / run.window.latents if s > 0 else None
