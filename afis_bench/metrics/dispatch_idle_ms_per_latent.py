"""dispatch_idle_ms_per_latent: device idle time per latent completed in
the traced window, in gaps whose innermost program span is the request
(``search``) or host dispatch (``dispatch.*``: packing the latents,
building their kernel operands); ``afis_bench.spans``."""
from afis_bench.spans import idle_ms_per_latent


def read(run):
    return idle_ms_per_latent(run, ("search", "dispatch"))
