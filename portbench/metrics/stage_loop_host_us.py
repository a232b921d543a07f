"""stage_loop_host_us: the host's time a merge pass in the stage loop: the
median, over the traced window's ops, of the port's ``msbwt.stage_loop``
span (the passes enqueued, not waited for) over the op's passes, the
window's ``merge_insert.launches`` over its ops."""

import numpy as np

from portbench import spans

LAYER = "stage loop, host side (ops/bcr._build_device)"
UNIT = "us"
MOVES = "build_mbases_per_s"
READS = "the msbwt.stage_loop spans inside the op spans and merge_insert.launches"
COUNTERS = {"merge": "rust_msbwt_tpu_torch.ops.merge_insert:merge_insert"}


def read(trace):
    t = spans.per_op(trace, {"msbwt.stage_loop"})
    passes = trace.counters.get("merge", 0) / len(trace.ops) if trace.ops else 0
    return float(np.median(t)) / passes * 1e6 if len(t) and passes else None
