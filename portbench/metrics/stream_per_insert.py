"""stream_per_insert: the symbols the window's merge passes stream (each
pass its bucket's whole capacity, read and written) over the symbols its
builds insert: the stage loop's symbol counter (``ops/bcr.merge_streamed``,
added to once a build) over the ops' read bases and terminators. Lower is
better: each pass saved, or a smaller bucket a pass, streams less for the
same reads."""

from portbench import stage_counts

LAYER = "stage loop schedule (ops/bcr._build_device)"
UNIT = "x"
MOVES = "build_mbases_per_s"
READS = "the stage loop's streamed-symbol counter, the ops' reads"
COUNTERS = {"streamed": "portbench.stage_counts:streamed"}


def read(trace):
    streamed, inserted = trace.counters.get("streamed", 0), stage_counts.inserted(trace)
    return streamed / inserted if streamed and inserted else None
