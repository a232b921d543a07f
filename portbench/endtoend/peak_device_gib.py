"""peak_device_gib: ``torch.cuda.max_memory_allocated()`` over the window,
its statistics reset at the window's start."""

UNIT = "GiB"


def read(window):
    return window.peak_bytes / 2**30 if window.peak_bytes else None
