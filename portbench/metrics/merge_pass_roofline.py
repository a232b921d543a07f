"""merge_pass_roofline: the merge passes' share of the memory roofline.

Bytes: for every pass of every op in the window, 3 x the symbols in the
BWT after the pass + 6 x the pass's inserts (``roofline.merge_pass_bytes``,
from the op's reads and base alone). The passes that pair two columns are
the ``lf_pair`` calls; their count a build comes from the port's launch
counters, which must add up to one pass a stage-1 insert, a pair and a
single column. Time: the summed device time of the pass's five kernels.
The least time is the bytes over the card's published memory rate
(``roofline.PEAKS``)."""

from portbench import roofline

LAYER = "merge pass (ops/merge_insert.merge_insert, csrc/merge_insert.cu)"
UNIT = "%"
MOVES = "build_mbases_per_s"
READS = "merge kernels' device time, the launch counters, the ops' reads"
PATTERNS = ("count_superbuckets", "scan_superbuckets", "place_superbuckets",
            "sort_tiles", "merge_tiles")
COUNTERS = {
    "merge": "rust_msbwt_tpu_torch.ops.merge_insert:merge_insert",
    "lf_pair": "rust_msbwt_tpu_torch.ops.lf:lf_pair",
    "lf_stage": "rust_msbwt_tpu_torch.ops.lf:lf_stage",
}


def read(trace):
    seconds = trace.device_seconds(PATTERNS)
    peak = roofline.hbm_bytes_per_s(trace.device_name)
    ops = len(trace.ops)
    c = trace.counters
    if not seconds or not peak or not ops or any(c.get(k, 0) % ops for k in COUNTERS):
        return None
    pairs, singles = c["lf_pair"] // ops, c["lf_stage"] // ops
    if c["merge"] // ops != 1 + pairs + singles:
        return None
    total = sum(roofline.merge_pass_bytes(op["n0"], op["lengths"], pairs) for op in trace.ops)
    return 100.0 * total / peak / seconds
