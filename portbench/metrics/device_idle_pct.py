"""device_idle_pct: the share of the traced window in which no operation
ran on the card (the union of the profiler's device events)."""

LAYER = "device"
UNIT = "%"
MOVES = "build_mbases_per_s"
READS = "the device events of the profiler timeline and the window's length"


def read(trace):
    busy = trace.busy_s
    if busy <= 0 or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy / trace.window_s)
