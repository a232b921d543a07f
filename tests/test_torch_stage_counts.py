"""The stage loop's symbol counter (``ops/bcr.merge_streamed``) on CPU
builds: a build adds, once, the capacities of the merge passes it made,
which are its schedule's; and the numpy stage view, gathered in column
blocks, equals the native one at ragged shapes."""

import numpy as np
import pytest

from rust_msbwt_tpu_torch.ops import bcr
from rust_msbwt_tpu_torch.ops.merge_insert import merge_insert_slots
from rust_msbwt_tpu_torch.utils.native import reads_to_cols_native


def _ragged(rng, n, width):
    lengths = rng.integers(1, width + 1, n).astype(np.int32)
    lengths[0] = width
    reads = np.zeros((n, width), np.uint8)
    for i, k in enumerate(lengths):
        reads[i, :k] = rng.integers(1, 6, k)
    return reads, lengths


def _schedule_sum(n0, lengths, radix, groups=True):
    """Stage 1 at the first bucket's capacity, then a pass a column (radix
    1), or at radix 2 a pass a step of the schedule with column groups
    (``groups``) or of the pairs alone (an odd last stage alone), at its
    bucket's."""
    N, L = len(lengths), int(lengths.max())
    n_cap = n0 + int(lengths.sum()) + N
    sched = bcr.bucket_schedule(n0, N, L, n_cap, 128)
    if radix == 1:
        return sched[0][2] + sum((b - a) * c for a, b, c in sched)
    sched = bcr.pair_buckets(sched, L)
    steps = (bcr.group_schedule(sched, bcr.active_counts(lengths, L), N) if groups
             else bcr.pair_steps(sched))
    return sched[0][2] + sum(c for _, _, c in steps)


def _counted_build(reads, lengths, **kw):
    """The build's merge passes' capacities, the counter's values while
    they ran, and what the counter gained over the build."""
    caps, seen = [], []

    def counting(old, q, v, active, **k):
        caps.append(int(old.shape[0]))
        seen.append(bcr.merge_streamed.launches)
        return merge_insert_slots(old, q, v, active, **k)

    s0 = bcr.merge_streamed.launches
    idx, _ = bcr.build_msbwt_with_index(reads, lengths, device="cpu", merge=counting, **kw)
    assert set(seen) == {s0}  # nothing added while the passes ran
    return idx, caps, bcr.merge_streamed.launches - s0


@pytest.mark.parametrize("kind,radix", [("one_shot", "1"), ("one_shot", "2"),
                                        ("append", "1"), ("append", "2")])
def test_counters_add_the_schedules_capacities_and_inserts(monkeypatch, kind, radix):
    """Every pass's capacity, recorded by the merge it calls, sums to what
    ``merge_streamed`` gained over the build and to the schedule's sum; the
    count comes once a build, not a pass, and the build inserts n_cap - n0.
    At radix 2 the ragged reads' tail runs in two column groups (of 4 and 5
    columns): 7 passes, which stream less than the pairs' 10 would."""
    monkeypatch.setenv("MSBWT_TPU_RADIX", radix)
    rng = np.random.default_rng(11)
    reads, lengths = _ragged(rng, 30, 17)
    kw, n0 = {}, 0
    if kind == "append":
        b_reads, b_lengths = _ragged(rng, 20, 9)
        idx, packed = bcr.build_msbwt_with_index(b_reads, b_lengths, device="cpu")
        n0 = idx.n
        kw = dict(base=idx.bwt[:n0], base_string_count=20, base_rot_max=10, base_index=packed)
    idx, caps, gained = _counted_build(reads, lengths, **kw)
    assert gained == sum(caps) == _schedule_sum(n0, lengths, int(radix))
    assert idx.n - n0 == int(lengths.sum()) + 30
    passes = 1 + 6 if radix == "2" else 1 + 17
    assert len(caps) == passes
    if radix == "2":
        assert gained == {"one_shot": 1920, "append": 2816}[kind]
        assert gained < _schedule_sum(n0, lengths, 2, groups=False)


def test_streamed_is_the_schedules_sum():
    """A one-shot build of 50 long ragged reads (radix 2 by the port's own
    rule, growing buckets, the tail past the shortest read's 1,001 columns
    in column groups: 395 columns in groups) adds its schedule's sum, which
    the pairs alone and a radix-1 build of the same reads exceed."""
    rng = np.random.default_rng(7)
    lengths = rng.integers(1000, 1602, 50).astype(np.int32)
    lengths[0] = 1601
    reads = np.zeros((50, 1601), np.uint8)
    for i, k in enumerate(lengths):
        reads[i, :k] = rng.integers(1, 6, k)
    n_cap = int(lengths.sum()) + 50
    assert bcr.build_radix(n_cap, 50) == 2 and len(bcr.bucket_schedule(0, 50, 1601, n_cap, 128)) > 1
    _, caps, gained = _counted_build(reads, lengths)
    assert gained == sum(caps) == _schedule_sum(0, lengths, 2) == 25_794_816
    assert len(caps) == 682  # stage 1, then the schedule's pairs and groups
    assert gained < _schedule_sum(0, lengths, 2, groups=False) == 33_735_936
    assert _schedule_sum(0, lengths, 1) > gained


@pytest.mark.parametrize("n,width", [(40, 700), (3000, 60), (9, 1), (1, 5), (600, 9000)])
def test_block_view_equals_the_native_view(monkeypatch, n, width):
    """Ragged reads through the numpy view, with blocks small enough that
    a shape takes several, equal the native view."""
    rng = np.random.default_rng(n + width)
    reads, lengths = _ragged(rng, n, width)
    native = reads_to_cols_native(reads, lengths)
    if native is None:
        pytest.skip("no native host library here")
    monkeypatch.setattr(bcr, "_VIEW_BLOCK", 4096)
    assert np.array_equal(bcr.reads_to_cols(reads, lengths), native)
