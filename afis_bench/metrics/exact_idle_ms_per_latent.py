"""exact_idle_ms_per_latent: device idle time per latent completed in the
traced window, in gaps whose innermost program span is ``exact``
(``engine._match_all``'s own time: its blocks' arguments and launches);
``afis_bench.spans``."""
from afis_bench.spans import idle_ms_per_latent


def read(run):
    return idle_ms_per_latent(run, ("exact",))
