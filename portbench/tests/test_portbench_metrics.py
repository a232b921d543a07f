"""The per-layer metrics' arithmetic: the merge passes' byte count against
a hand count over the port's own pass schedule, and each reader on a
timeline made by hand (a reader with nothing to read returns None)."""

import numpy as np
import pytest

from portbench import roofline
from portbench.run import HERE, load_file
from portbench.trace import OP_SPAN, Trace


def _metric(name):
    import os

    return load_file(os.path.join(HERE, "metrics", f"{name}.py"), f"m_{name}")


@pytest.mark.parametrize("radix", ["1", "2"])
@pytest.mark.parametrize("base", [False, True])
def test_merge_bytes_equal_a_hand_count_of_the_passes(monkeypatch, radix, base):
    """Every merge pass the port's CPU build makes, recorded with its
    inserts and the symbols after it, counted by hand as 3n + 6k, equals
    ``merge_pass_bytes`` over the reads and the base alone; the inserts a
    pass equal ``merge_pass_inserts``."""
    from rust_msbwt_tpu_torch.ops import bcr
    from rust_msbwt_tpu_torch.ops.merge_insert import merge_insert_slots

    monkeypatch.setenv("MSBWT_TPU_RADIX", radix)
    rng = np.random.default_rng(5)
    lengths = rng.integers(1, 14, 40).astype(np.int32)
    lengths[:3] = 13
    reads = np.zeros((40, 13), np.uint8)
    for i, n in enumerate(lengths):
        reads[i, :n] = rng.integers(1, 6, n)
    kw, n0 = {}, 0
    if base:
        b_reads = rng.integers(1, 6, (25, 9)).astype(np.uint8)
        idx, packed = bcr.build_msbwt_with_index(b_reads, np.full(25, 9, np.int32), device="cpu")
        n0 = idx.n
        kw = dict(base=idx.bwt[:n0], base_string_count=25, base_rot_max=10, base_index=packed)
    passes = []

    def counting(old, q, v, active, **k):
        out = merge_insert_slots(old, q, v, active, **k)
        passes.append(int(active.sum()))
        return out

    bcr.build_msbwt_with_index(reads, lengths, device="cpu", merge=counting, **kw)
    hand, n = 0, n0
    for k in passes:
        n += k
        hand += 3 * n + 6 * k
    pairs = 13 // 2 if radix == "2" else 0
    assert passes == roofline.merge_pass_inserts(lengths, pairs)
    assert roofline.merge_pass_bytes(n0, lengths, pairs) == hand
    assert n == n0 + int(lengths.sum()) + 40


def _trace(ops=2, counters=None, device_name="NVIDIA H100 80GB HBM3"):
    """Two ops: span [0, 100) us with device events at 10-30 (merge_tiles)
    and 40-50 (pair_first_kernel), span [100, 200) with 130-150
    (lf_stage_kernel) and 160-170 (lf_walk_kernel<0>)."""
    dev = np.array([[10, 30], [40, 50], [130, 150], [160, 170]], float)
    names = ["void merge_tiles(int)", "pair_first_kernel(PairArgs)", "lf_stage_kernel(x)",
             "void lf_walk_kernel<0>(WalkArgs)"]
    cpu = np.array([[0, 100], [100, 200], [12, 14]], float)
    recs = [{"start": 0, "end": 1, "bases": 9, "n0": 10, "lengths": np.array([3, 1])}
            for _ in range(ops)]
    t = Trace(device_name, 200e-6, recs, counters or {}, dev, names, cpu,
              [OP_SPAN, OP_SPAN, "aten::copy_"])
    t.spans = cpu[:2]
    return t


def test_trace_reads_busy_gaps_and_host_prep():
    t = _trace()
    assert t.busy_s == pytest.approx(60e-6)
    assert t.host_prep_s() == pytest.approx([10e-6, 30e-6])
    gaps = t.idle_gaps()
    assert gaps[0] == [OP_SPAN, pytest.approx(80e-6)]  # 50 -> 130
    assert [g[1] for g in gaps] == sorted((g[1] for g in gaps), reverse=True)
    assert t.top_device_ops(2)[0][1] == pytest.approx(20e-6)
    assert _metric("device_idle_pct").read(t) == pytest.approx(70.0)
    assert _metric("host_prep_ms").read(t) == pytest.approx(0.02)


def test_kernel_readers_divide_by_their_counters():
    t = _trace(counters={"lf_pair": 2, "lf_stage": 4})
    assert _metric("lf_pair_us").read(t) == pytest.approx(5.0)
    assert _metric("lf_stage_us").read(t) == pytest.approx(5.0)
    assert _metric("lf_walk_ms").read(t) == pytest.approx(0.005)


def test_merge_roofline_reads_bytes_over_the_peak_and_kernel_time():
    # two ops of reads [3, 1] onto 10 symbols at radix 1: 207 B each
    t = _trace(counters={"merge": 8, "lf_pair": 0, "lf_stage": 6})
    assert _metric("merge_pass_roofline").read(t) == pytest.approx(
        100 * 2 * 207 / 3.35e12 / 20e-6)
    # radix 2: 165 B each
    t = _trace(counters={"merge": 6, "lf_pair": 2, "lf_stage": 2})
    assert _metric("merge_pass_roofline").read(t) == pytest.approx(
        100 * 2 * 165 / 3.35e12 / 20e-6)


@pytest.mark.parametrize("counters,name", [
    ({"merge": 9, "lf_pair": 0, "lf_stage": 6}, "NVIDIA H100 80GB HBM3"),  # an extra pass
    ({"merge": 8, "lf_pair": 0, "lf_stage": 5}, "NVIDIA H100 80GB HBM3"),  # not whole ops
    ({"merge": 8, "lf_pair": 0, "lf_stage": 6}, "a card with no peak in the table"),
])
def test_merge_roofline_reads_nothing_it_cannot_count(counters, name):
    assert _metric("merge_pass_roofline").read(_trace(counters=counters, device_name=name)) is None


def test_readers_with_nothing_to_read_return_none():
    t = _trace(counters={})
    t.device, t.device_names = np.zeros((0, 2)), []
    for name in ("device_idle_pct", "host_prep_ms", "merge_pass_roofline", "lf_pair_us",
                 "lf_stage_us", "lf_walk_ms"):
        assert _metric(name).read(t) is None, name
