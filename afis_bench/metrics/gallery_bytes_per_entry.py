"""gallery_bytes_per_entry: bytes of the DeviceGallery's tensors per padded
entry, in the configuration's layout."""


def read(run):
    return run.gallery_bytes / run.gallery_entries
