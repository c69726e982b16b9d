"""search_p95_ms: the 95th percentile of batch latency, submission to the
last list on the host, over every batch of the window (host clock)."""


def read(run):
    return run.window.percentile_ms(95)
