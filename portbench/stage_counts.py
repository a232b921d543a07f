"""The stage loop's symbols, as the metric readers take them: the port's
``ops/bcr.merge_streamed`` counter as the harness reads counters, by
``.launches`` (0 where the program lacks it, a commit from before it, so
that a reader finds nothing to read there and the run goes on), and the
symbols the window's ops insert, from their records."""

from __future__ import annotations

import importlib

PORT_MODULE = "rust_msbwt_tpu_torch.ops.bcr"


class PortCount:
    """The port's counter ``name`` in ``PORT_MODULE``, or 0 without it."""

    def __init__(self, name: str):
        self.name = name

    @property
    def launches(self) -> int:
        counter = getattr(importlib.import_module(PORT_MODULE), self.name, None)
        return int(getattr(counter, "launches", 0))


streamed = PortCount("merge_streamed")   # symbols the merge passes stream


def inserted(trace) -> int:
    """Symbols the window's ops insert: each op's read bases and a
    terminator a read."""
    return sum(op["bases"] + len(op["lengths"]) for op in trace.ops)
