"""device_idle_share: 1 - device busy / window over the traced window, the
busy time the union of the device's operations in torch.profiler's trace."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return run.trace.idle_share
