"""prep_sort_ms: the median, over the traced window's ops, of the port's
``msbwt.prep.sort`` span: the reads' validation and their native row sort
on the host."""

import numpy as np

from portbench import spans

LAYER = "host prep: read sort (utils/native.sort_rows_native)"
UNIT = "ms"
MOVES = "build_mbases_per_s"
READS = "the msbwt.prep.sort spans inside the op spans"


def read(trace):
    t = spans.per_op(trace, {"msbwt.prep.sort"})
    return float(np.median(t)) * 1e3 if len(t) else None
