"""lf_walk_ms: device time of the LF walks' kernels an op (an append's
cyclic terminator search)."""

LAYER = "LF walks (ops/lf.lf_walk_cyclic)"
UNIT = "ms"
MOVES = "build_mbases_per_s"
READS = "the walk kernels' device time and the window's ops"
PATTERNS = ("lf_walk_kernel", "lf_array_kernel", "lf_chase_lengths_kernel", "lf_locate_kernel")


def read(trace):
    seconds = trace.device_seconds(PATTERNS)
    return seconds / len(trace.ops) * 1e3 if trace.ops and seconds else None
