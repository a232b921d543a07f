"""build_mbases_per_s: the read bases (terminators not counted) of every op
completed in the window, over the time from the window's start to the end
of its last op."""

UNIT = "Mbases/s"


def read(window):
    ops = window.ops
    span = ops[-1]["end"] - window.start if ops else 0.0
    return sum(op["bases"] for op in ops) / span / 1e6 if span > 0 else None
