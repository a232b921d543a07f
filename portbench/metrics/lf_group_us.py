"""lf_group_us: device time of the column group's kernel a column carried
(``ops/lf.lf_group``): the group kernel's summed device time over the
port's ``lf_group.columns``. The counter is resolved here and reads 0 on a
program without ``lf_group`` (a commit from before it), so that the reader
finds nothing to read there and the run goes on."""

import importlib

LAYER = "radix-k column group (ops/lf.lf_group)"
UNIT = "us"
MOVES = "build_mbases_per_s"
READS = "group_kernel's device time and lf_group.columns"
PATTERNS = ("group_kernel",)
COUNTERS = {"lf_group_columns": "portbench.metrics.lf_group_us:columns"}
PORT_MODULE = "rust_msbwt_tpu_torch.ops.lf"


class _Columns:
    """The port's ``lf_group.columns``, read as ``.launches`` as the
    harness reads counters, or 0 without it."""

    @property
    def launches(self) -> int:
        group = getattr(importlib.import_module(PORT_MODULE), "lf_group", None)
        return int(getattr(group, "columns", 0))


columns = _Columns()


def read(trace):
    cols = trace.counters.get("lf_group_columns", 0)
    seconds = trace.device_seconds(PATTERNS)
    return seconds / cols * 1e6 if cols and seconds else None
