"""host_prep_ms: the median, over the traced window's ops, of the time from
the harness's span around the build entry to the op's first device
activity: the validation, read sort and stage view on the host before the
stage view's upload."""

import numpy as np

LAYER = "host prep (ops/bcr._prepare_build, utils/native sort and stage view)"
UNIT = "ms"
MOVES = "build_mbases_per_s"
READS = "the op spans and the device events of the profiler timeline"


def read(trace):
    prep = trace.host_prep_s()
    return float(np.median(prep)) * 1e3 if len(prep) else None
