"""screen_idle_ms_per_latent: device idle time per latent completed in the
traced window, in gaps whose innermost program span is ``screen``
(``engine._screen_all``'s own time, its chunks' launches and glue);
``afis_bench.spans``."""
from afis_bench.spans import idle_ms_per_latent


def read(run):
    return idle_ms_per_latent(run, ("screen",))
