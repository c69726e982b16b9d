"""launches_per_latent: device kernels launched in the traced window (all
of them, from the profiler's trace) per latent completed: the host
dispatch around the kernels."""


def read(run):
    if run.trace is None or run.trace.kernel_launches == 0:
        return None
    return run.trace.kernel_launches / run.window.latents
