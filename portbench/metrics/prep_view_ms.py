"""prep_view_ms: the median, over the traced window's ops, of the port's
``msbwt.prep.view`` span: the sorted reads' gather into the column-major
stage view on the host."""

import numpy as np

from portbench import spans

LAYER = "host prep: stage view (utils/native.reads_to_cols_native)"
UNIT = "ms"
MOVES = "build_mbases_per_s"
READS = "the msbwt.prep.view spans inside the op spans"


def read(trace):
    t = spans.per_op(trace, {"msbwt.prep.view"})
    return float(np.median(t)) * 1e3 if len(t) else None
