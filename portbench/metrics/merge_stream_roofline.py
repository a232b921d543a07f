"""merge_stream_roofline: the merge passes' share of the memory roofline
on what they stream. Bytes: 3 a symbol streamed (the old symbol read, the
new one written, a 128-symbol bin's 128 B of table), from the stage loop's
symbol counter (``ops/bcr.merge_streamed``), and 6 an insert (its slot,
symbol and flag), from the ops' reads. Time: the summed device time of the
pass's five kernels. The least time is the bytes over the card's published
memory rate (``roofline.PEAKS``)."""

from portbench import roofline, stage_counts

LAYER = "merge pass (ops/merge_insert.merge_insert, csrc/merge_insert.cu)"
UNIT = "%"
MOVES = "build_mbases_per_s"
READS = "merge kernels' device time, the stage loop's streamed-symbol counter, the ops' reads"
PATTERNS = ("count_superbuckets", "scan_superbuckets", "place_superbuckets",
            "sort_tiles", "merge_tiles")
COUNTERS = {"streamed": "portbench.stage_counts:streamed"}


def read(trace):
    seconds = trace.device_seconds(PATTERNS)
    peak = roofline.hbm_bytes_per_s(trace.device_name)
    streamed, inserted = trace.counters.get("streamed", 0), stage_counts.inserted(trace)
    if not seconds or not peak or not streamed or not inserted:
        return None
    return 100.0 * (3 * streamed + 6 * inserted) / peak / seconds
