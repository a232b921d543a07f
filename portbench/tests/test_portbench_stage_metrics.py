"""The readers of the stage loop's symbol counter on a timeline made by
hand: a known answer each, and None without the counter or ops; the
counter's ref reads the port's value, and 0 from a program that lacks
it."""

import pytest

from portbench import run, stage_counts

from .test_portbench_metrics import _metric, _trace

COUNTS = {"streamed": 6_000_000}
INSERTED = 2 * (9 + 2)  # two ops of 9 bases in two reads


def test_inserted_counts_each_ops_bases_and_terminators():
    assert stage_counts.inserted(_trace()) == INSERTED
    assert stage_counts.inserted(_trace(ops=0)) == 0


def test_stream_per_insert_reads_streamed_over_inserted():
    want = 6_000_000 / INSERTED
    assert _metric("stream_per_insert").read(_trace(counters=COUNTS)) == pytest.approx(want)


def test_merge_stream_roofline_reads_bytes_over_the_peak_and_kernel_time():
    # merge_tiles holds 20 us of the timeline
    want = 100 * (3 * 6_000_000 + 6 * INSERTED) / 3.35e12 / 20e-6
    assert _metric("merge_stream_roofline").read(_trace(counters=COUNTS)) == pytest.approx(want)


@pytest.mark.parametrize("name", ["stream_per_insert", "merge_stream_roofline"])
@pytest.mark.parametrize("counters,ops", [({}, 2), ({"streamed": 0}, 2),
                                          ({"streamed": 5}, 0)])
def test_readers_without_their_counters_return_none(name, counters, ops):
    assert _metric(name).read(_trace(ops=ops, counters=counters)) is None


def test_merge_stream_roofline_reads_nothing_without_a_peak_or_kernels():
    reader = _metric("merge_stream_roofline")
    assert reader.read(_trace(counters=COUNTS, device_name="a card with no peak")) is None
    t = _trace(counters=COUNTS)
    t.device_names = ["other"] * len(t.device_names)
    assert reader.read(t) is None


def test_counter_refs_read_the_port_and_zero_without_it(monkeypatch):
    from rust_msbwt_tpu_torch.ops import bcr

    refs = _metric("stream_per_insert").COUNTERS
    assert refs == _metric("merge_stream_roofline").COUNTERS
    monkeypatch.setattr(bcr.merge_streamed, "launches", 17)
    assert run._counters(refs) == {"streamed": 17}
    monkeypatch.delattr(bcr, "merge_streamed")
    assert run._counters(refs) == {"streamed": 0}
    assert stage_counts.streamed.launches == 0
