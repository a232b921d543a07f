"""The readers of the port's own spans (``msbwt.*``) on a timeline made by
hand: a known answer each, and None where the program has no such spans."""

import numpy as np
import pytest

from portbench.tests.test_portbench_metrics import _metric, _trace


def _span_trace(counters=None):
    """``_trace``'s two op spans with the port's spans inside, in host us:
    op 0 sort 4, view 3, upload 1, stage loop 20; op 1 sort 8, view 1,
    upload 3, stage loop 10; and a sort span outside every op span (set-up)
    that no reader counts."""
    t = _trace(counters=counters)
    names = ["msbwt.build", "msbwt.prep.sort", "msbwt.prep.view", "msbwt.upload",
             "msbwt.stage_loop", "msbwt.build", "msbwt.prep.sort", "msbwt.prep.view",
             "msbwt.upload", "msbwt.stage_loop", "msbwt.prep.sort"]
    ev = [[1, 99], [2, 6], [6, 9], [9, 10], [40, 60], [101, 199], [101, 109], [110, 111],
          [111, 114], [140, 150], [250, 290]]
    t.cpu = np.concatenate([t.cpu, np.array(ev, float)])
    t.cpu_names = t.cpu_names + names
    return t


@pytest.mark.parametrize("name,want", [
    ("prep_sort_ms", 0.006),             # median of 4 and 8 us
    ("prep_view_ms", 0.002),             # of 3 and 1
    ("upload_ms", 0.002),                # of 1 and 3
    ("stage_loop_host_us", 1.5),         # median of 20 and 10 us over 20 passes / 2 ops
    ("prep_p95_ms", 0.0118),             # 95th percentile of 8 and 12 us
])
def test_span_readers_read_the_ports_spans_by_op(name, want):
    reader = _metric(name)
    assert reader.read(_span_trace(counters={"merge": 20})) == pytest.approx(want)
    assert reader.read(_trace(counters={"merge": 20})) is None  # a program with no spans
    assert name != "stage_loop_host_us" or reader.read(_span_trace()) is None  # no passes
