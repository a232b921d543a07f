"""The port's column groups on CPU: ``lf_group_plain`` (k > 2 BCR columns
through one merge pass) against running ``lf_stage_plain`` and the plain
merge pass column by column, the group's slot math past 2^30 against a
numpy oracle, whole ragged builds through groups against the naive BWT and
radix 1 (one-shot, onto a base, streamed; sorted and chronological), the
radix-2 schedule with groups (``ops.bcr.group_schedule``) against its rule,
against the pairs on reads of one length and on the benchmark's nanopore
read lengths, and the benchmark's reader of the group's device time.
Every comparison is bit-exact (tolerance 0: every output is an integer).
"""

import os

import numpy as np
import pytest
import torch

from portbench.traffic.closed_loop_ragged import gamma_lengths
from rust_msbwt_tpu_torch.ops import bcr, lf
from rust_msbwt_tpu_torch.ops.alphabet import convert_itos
from rust_msbwt_tpu_torch.ops.merge_insert import insert_maps, merge_insert_slots
from rust_msbwt_tpu_torch.utils.oracle import naive_bwt
from rust_msbwt_tpu_torch.utils.streaming import build_msbwt_streaming
from test_torch_gpu import GROUP_SHAPES, group_captures, lf_group_args, ragged_reads


def _column_by_column(c):
    """The captured group run as single columns: ``lf_stage_plain`` and a
    plain merge pass each, every earlier insert's slot moved through each
    pass (its old position to the new buffer's non-inserted positions).
    Returns the inserts' final slots and symbols by group id, the buffer and
    table after, and the carry."""
    j, acts, by = c["j"], c["acts"], c["by_len"].long()
    tab, buf, cols = c["tab"], c["buf"], c["cols"]
    lengths = c["lengths"]
    P, counts, prev_v = c["P"], c["counts"], c["prev_v"]
    slots = torch.zeros(0, dtype=torch.int64)
    syms = torch.zeros(0, dtype=torch.uint8)
    for t, A in enumerate(acts):
        q, v, active, P, counts, prev_v = lf.lf_stage_plain(j + t, tab, c["nst"], cols, lengths,
                                                           P, counts, prev_v)
        assert int(active.sum()) == A and bool(active[by[:A]].all())
        ins, _, _ = insert_maps(buf.shape[0], q, v, active)
        kept = (ins[: buf.shape[0]] == 0).nonzero()[:, 0]
        slots = torch.cat([kept[slots], q[by[:A]].long()])
        syms = torch.cat([syms, v[by[:A]]])
        buf, tab, _ = merge_insert_slots(buf, q, v, active)
    return slots, syms, buf, tab, P, counts, prev_v


def _keep_some(i, k):
    return i < 3 or i % 10 == 0


def _base(sorted_insert):
    r = np.random.default_rng(30 + sorted_insert)
    reads = r.integers(1, 6, (25, 9)).astype(np.uint8)
    idx, packed = bcr.build_msbwt_with_index(reads, np.full(25, 9, np.int32), sorted_insert,
                                             device="cpu")
    return dict(base=idx.bwt[: idx.n], base_string_count=25, base_rot_max=10,
                base_index=packed)


@pytest.mark.parametrize("onto_base", [False, True], ids=["one_shot", "onto_base"])
@pytest.mark.parametrize("sorted_insert", [True, False], ids=["sorted", "chronological"])
@pytest.mark.parametrize("shape", list(GROUP_SHAPES))
def test_group_equals_column_by_column(monkeypatch, shape, sorted_insert, onto_base):
    """Each captured group of a ragged build (gamma lengths at mean 150, a
    thin tail, a group of exactly three columns; after a pair and after a
    group): ``lf_group_plain``'s slots and symbols == the single columns'
    inserts moved to the buffer after the pass, its pass == their passes
    (buffer and table), its counts and prev_v == theirs, P == theirs for
    the reads active in the last column and the slot of its last insert
    for the others, and its order the last column's reads by slot."""
    kw = _base(sorted_insert) if onto_base else {}
    calls, _ = group_captures(*ragged_reads(*GROUP_SHAPES[shape]), monkeypatch, sorted_insert,
                              keep=_keep_some, **kw)
    calls = [c for c in calls if c is not None]
    assert any(c["order"] is None for c in calls) and any(c["order"] is not None for c in calls)
    if shape == "k3":
        assert min(len(c["acts"]) for c in calls) == 3
    for c in calls:
        args, order = lf_group_args(c, "cpu")
        q, v, active, P, counts, prev_v, order_out = lf.lf_group_plain(*args, order)
        slots, syms, buf, tab, P_o, counts_o, prev_o = _column_by_column(c)
        acts, by, M = c["acts"], c["by_len"].long(), int(c["acts"].sum())
        assert torch.equal(q[:M].long(), slots) and torch.equal(v[:M], syms)
        assert bool(active[:M].all()) and not active[M:].any() and not q[M:].any()
        new, new_tab, m = merge_insert_slots(c["buf"], q, v, active)
        assert int(m) == M and torch.equal(new, buf) and torch.equal(new_tab, tab)
        assert torch.equal(counts, counts_o) and torch.equal(prev_v, prev_o)
        last = by[: acts[-1]]
        assert torch.equal(P[last], P_o[last])
        off = np.concatenate([[0], np.cumsum(acts)])
        for t in range(len(acts) - 1):
            r = torch.arange(int(acts[t + 1]), int(acts[t]))
            assert torch.equal(P[by[r]].long(), slots[off[t] + r])
        assert torch.equal(order_out.long(), torch.argsort(slots[off[-2]:]))
        rest = by[acts[0]:]
        assert torch.equal(P[rest], c["P"][rest]) and torch.equal(prev_v[rest], c["prev_v"][rest])


@pytest.mark.parametrize("seed", range(3))
def test_group_slots_above_2_30_match_oracle(seed):
    """One column of a group with every slot near 2^31 (a buffer past 2^30
    symbols): the column's slots and the inserts moved past them == a
    numpy count of the same sets, no sentinel in either search."""
    r = np.random.default_rng(seed)
    m, A = 300, 120
    lo = 2**31 - 2**20 - 1024
    pos = np.sort(r.choice(2**20, m, replace=False) + lo)
    r.shuffle(pos)
    sym = r.integers(0, 6, m).astype(np.uint8)
    heads = r.choice(m, A, replace=False)  # the active reads' last inserts
    x, f = pos[heads], sym[heads]
    # C_t[f] + rank_B0(f, old): monotone in old within a symbol, the
    # symbols' ranges apart, every value above 2^30
    C = 2**31 - 2**24 + np.arange(6, dtype=np.int64) * 2**21

    def base(f, old):
        return torch.from_numpy(C)[f.long()] + (old - lo) // 8

    t = torch.from_numpy
    q, moved = lf.group_column(t(pos), t(sym), t(x), t(f), base)
    below = (pos[None, :] < x[:, None]).sum(1)
    same = ((pos[None, :] < x[:, None]) & (sym[None, :] == f[:, None])).sum(1)
    q_want = C[f] + (x - below - lo) // 8 + same
    assert np.array_equal(q.numpy(), q_want) and (q_want > 2**30).all()
    d = np.sort(q_want) - np.arange(A)
    assert np.array_equal(moved.numpy(), pos + (d[None, :] <= pos[:, None]).sum(1))
    assert (moved.numpy() < 2**31 - 1).all()


def _ragged_set(seed, n, width, thin=False):
    r = np.random.default_rng(seed)
    lengths = (r.integers(1, 4, n) if thin else r.integers(1, width + 1, n)).astype(np.int32)
    lengths[0] = width
    return [r.integers(1, 6, k).astype(np.uint8) for k in lengths]


def _build(reads_l, sorted_insert, radix, monkeypatch, **kw):
    monkeypatch.setenv("MSBWT_TPU_RADIX", str(radix))
    reads, lengths = bcr.encode_reads(reads_l)
    idx, packed = bcr.build_msbwt_with_index(reads, lengths, sorted_insert, device="cpu", **kw)
    return idx.bwt[: idx.n].numpy(), packed.table.numpy()


@pytest.mark.parametrize("kind", ["ragged", "thin_tail"])
@pytest.mark.parametrize("sorted_insert", [True, False], ids=["sorted", "chronological"])
@pytest.mark.parametrize("onto_base", [False, True], ids=["one_shot", "onto_base"])
def test_ragged_build_through_groups(monkeypatch, kind, sorted_insert, onto_base):
    """A ragged build at radix 2 runs groups and equals the radix-1 build,
    BWT and table, and (sorted) the naive BWT of every read, the base's
    included."""
    reads_l = _ragged_set(40 + sorted_insert, 35, 40, thin=kind == "thin_tail")
    kw, base_l = {}, []
    if onto_base:
        base_l = _ragged_set(50, 12, 11)
        b_reads, b_lengths = bcr.encode_reads(base_l)
        idx, packed = bcr.build_msbwt_with_index(b_reads, b_lengths, sorted_insert, device="cpu")
        kw = dict(base=idx.bwt[: idx.n], base_string_count=12, base_rot_max=12,
                  base_index=packed)
    before = []
    monkeypatch.setattr(bcr, "lf_group", lambda *a, order=None: before.append(len(a[7]))
                        or lf.lf_group_plain(*a, order))
    bwt2, tab2 = _build(reads_l, sorted_insert, 2, monkeypatch, **kw)
    bwt1, tab1 = _build(reads_l, sorted_insert, 1, monkeypatch, **kw)
    assert before and min(before) > 2
    assert np.array_equal(bwt2, bwt1) and np.array_equal(tab2, tab1)
    if sorted_insert:
        assert convert_itos(bwt2) == naive_bwt([convert_itos(s) for s in base_l + reads_l])


@pytest.mark.parametrize("sorted_insert", [True, False], ids=["sorted", "chronological"])
def test_ragged_streamed_batches_equal_one_shot(monkeypatch, sorted_insert):
    """Ragged batches streamed at radix 2 (each batch's tail in groups) ==
    the one-shot build of every read."""
    monkeypatch.setenv("MSBWT_TPU_RADIX", "2")
    reads, lengths = bcr.encode_reads(_ragged_set(60, 45, 30))
    calls = []
    monkeypatch.setattr(bcr, "lf_group", lambda *a, order=None: calls.append(1)
                        or lf.lf_group_plain(*a, order))
    want = bcr.build_msbwt(reads, lengths, sorted_insert, device="cpu")
    n_one_shot = len(calls)
    got = build_msbwt_streaming(reads, lengths, 15, sorted_insert, device="cpu")
    assert n_one_shot and len(calls) > n_one_shot
    assert np.array_equal(got, want)


def _schedule(lengths, n0=0):
    N, L = len(lengths), int(max(lengths))
    n_cap = n0 + int(np.sum(lengths)) + N
    buckets = bcr.pair_buckets(bcr.bucket_schedule(n0, N, L, n_cap, 128), L)
    return buckets, bcr.group_schedule(buckets, bcr.active_counts(lengths, L), N)


@pytest.mark.parametrize("N,L,n0", [(10, 20, 0), (500, 101, 0), (64, 1000, 0), (7, 33, 5000),
                                    (1000, 100, 404_000)])
def test_schedule_on_one_length_is_the_pairs(N, L, n0):
    buckets, steps = _schedule(np.full(N, L), n0)
    assert steps == bcr.pair_steps(buckets)


@pytest.mark.parametrize("seed", range(6))
def test_schedule_groups_follow_the_rule(seed):
    """On ragged lengths the steps cover [2, L + 2) contiguously, each
    inside the bucket whose capacity it carries; a group (k > 2) holds at
    most 2N active reads and stops at its bucket's end or where the next
    column would pass 2N; a run of one or two columns is a pair, or a
    bucket's last column alone."""
    r = np.random.default_rng(seed)
    N = int(r.integers(5, 300))
    lengths = r.integers(1, int(r.integers(2, 400)), N)
    if seed % 2:
        lengths[: N // 2] = r.integers(1, 5, N // 2)
    L = int(lengths.max())
    buckets, steps = _schedule(lengths)
    A = bcr.active_counts(lengths, L)
    assert [j for j, _, _ in steps] == list(np.cumsum([2] + [k for _, k, _ in steps])[:-1])
    assert steps[-1][0] + steps[-1][1] == L + 2
    for j, k, cap in steps:
        (ja, jb), = [(a, b) for a, b, c in buckets if c == cap]
        assert ja <= j and j + k <= jb
        held = int(A[j: j + k].sum())
        if k > 2:
            assert held <= 2 * N and (j + k == jb or held + A[j + k] > 2 * N)
        else:
            assert k == 2 or j + 1 == jb


def test_schedule_on_the_nanopore_lengths():
    """``ecoli-ont50x``'s own read lengths (Badread's gamma quantiles):
    8,474 merge passes a build (stage 1, 3,676 pairs, 4,797 groups) in
    place of the pairs' 63,564; 119,773 columns in groups, the first at
    column 7,352, the longest 15,369 columns; 3,262 passes in the last,
    full-capacity bucket; 1,254,602,714,368 symbols streamed over
    232,091,467 inserted, the ``stream_per_insert`` of the cell."""
    lengths = gamma_lengths(15472, 15000, 13000)
    n_cap = int(lengths.sum()) + 15472
    buckets, steps = _schedule(lengths)
    ks = [k for _, k, _ in steps]
    groups = [(j, k) for j, k, _ in steps if k > 2]
    assert (1 + len(steps), ks.count(2), len(groups), ks.count(1)) == (8474, 3676, 4797, 0)
    assert 1 + len(bcr.pair_steps(buckets)) == 63564
    assert sum(k for _, k in groups) == 119773 and min(j for j, _ in groups) == 7352
    assert max(ks) == 15369
    assert sum(cap == buckets[-1][2] for _, _, cap in steps) == 3262
    streamed = buckets[0][2] + sum(cap for _, _, cap in steps)
    assert (streamed, n_cap) == (1_254_602_714_368, 232_091_467)
    assert streamed / n_cap == pytest.approx(5405.639124026908, rel=1e-12)


def test_lf_group_us_reads_device_time_over_columns(monkeypatch):
    """The benchmark's reader: the group kernel's device time over
    ``lf_group.columns`` in microseconds; None without columns or device
    time; its counter reads the port's ``lf_group.columns`` and 0 on a
    program without ``lf_group``."""
    from types import SimpleNamespace

    from portbench import run

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mod = run.load_file(os.path.join(root, "portbench", "metrics", "lf_group_us.py"),
                        "lf_group_us_test")

    def trace(columns, seconds):
        return SimpleNamespace(counters={"lf_group_columns": columns} if columns else {},
                               device_seconds=lambda patterns: seconds
                               if "group_kernel" in patterns else 0.0)

    assert mod.read(trace(1000, 0.015)) == pytest.approx(15.0)
    assert mod.read(trace(0, 0.015)) is None and mod.read(trace(1000, 0.0)) is None
    monkeypatch.setattr(lf.lf_group, "columns", 41)
    assert run._counters(mod.COUNTERS) == {"lf_group_columns": 41}
    monkeypatch.delattr(lf, "lf_group")
    assert run._counters(mod.COUNTERS) == {"lf_group_columns": 0}
