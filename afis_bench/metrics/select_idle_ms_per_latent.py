"""select_idle_ms_per_latent: device idle time per latent completed in the
traced window, in gaps whose innermost program span is selection or
readback (``select.*``: the stable sorts, the gallery gathers, the copies
to the host and the NumPy work after them, the ranking of a dense list);
``afis_bench.spans``."""
from afis_bench.spans import idle_ms_per_latent


def read(run):
    return idle_ms_per_latent(run, ("select",))
