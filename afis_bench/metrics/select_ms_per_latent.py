"""select_ms_per_latent: device time of every device operation outside the
screen and exact groups (sorts, gathers, masks, copies to the host) per
latent completed, in the traced window."""
from afis_bench.kernels import device_seconds


def read(run):
    if run.trace is None:
        return None
    s = device_seconds(run.trace, "select", kernels_only=False)
    return s * 1e3 / run.window.latents if s > 0 else None
