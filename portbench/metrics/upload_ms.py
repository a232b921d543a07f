"""upload_ms: the median, over the traced window's ops, of the port's
``msbwt.upload`` span: the stage view's and the lengths' pageable copies
to the card, which return once the copies are done."""

import numpy as np

from portbench import spans

LAYER = "stage-view upload (ops/bcr._build_device)"
UNIT = "ms"
MOVES = "build_mbases_per_s"
READS = "the msbwt.upload spans inside the op spans"


def read(trace):
    t = spans.per_op(trace, {"msbwt.upload"})
    return float(np.median(t)) * 1e3 if len(t) else None
