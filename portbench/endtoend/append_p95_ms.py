"""append_p95_ms: the 95th percentile of the walls of every op in the
window, each from its call to its ``torch.cuda.synchronize()``."""

import numpy as np

UNIT = "ms"


def read(window):
    walls = [op["end"] - op["start"] for op in window.ops]
    return float(np.percentile(walls, 95)) * 1e3 if walls else None
