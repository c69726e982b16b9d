"""exact_ms_per_latent: device time of the exact group's kernels
(``kernels.EXACT``: minutiae_match, the ADC row maximum, texture_match)
per latent completed, in the traced window."""
from afis_bench.kernels import device_seconds


def read(run):
    if run.trace is None:
        return None
    s = device_seconds(run.trace, "exact")
    return s * 1e3 / run.window.latents if s > 0 else None
