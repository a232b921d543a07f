"""prep_p95_ms: the 95th percentile, over the traced window's ops, of the
host prep an op: the port's ``msbwt.prep.sort``, ``msbwt.prep.view`` and
``msbwt.upload`` spans summed (about 470 ops in the append cell, so about
23 beyond it)."""

import numpy as np

from portbench import spans

LAYER = "host prep, tail"
UNIT = "ms"
MOVES = "append_p95_ms"
READS = "the msbwt.prep.sort, msbwt.prep.view and msbwt.upload spans inside the op spans"


def read(trace):
    t = spans.per_op(trace, {"msbwt.prep.sort", "msbwt.prep.view", "msbwt.upload"})
    return float(np.percentile(t, 95)) * 1e3 if len(t) else None
