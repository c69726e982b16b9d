"""peak_bytes_per_entry: the device allocator's peak over the window (reset
once the gallery is stored and the raw draws freed) per padded gallery
entry: what one card holds per print while it searches."""


def read(run):
    if not run.window_peak_bytes:
        return None
    return run.window_peak_bytes / run.gallery_entries
