"""search_rate: latents whose top-24 lists reached the host, per second,
over the whole window (host clock)."""


def read(run):
    return run.window.rate
